// y = a_scale * sum_g scale_g * (x_q . (c - off) + rowsum_g(x_q) * (off - zp_g))
// The weight-activation packed matmul of the W4A4 / W4A8 serving path.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::w4a8_matmul
// (Pallas body _w4a8_kernel) and holds to the plain oracle
// repro/kernels/ref.py::quant_matmul_ref, which quantizes each activation
// row with ONE whole-row scale.  (The TPU kernel takes a scale per
// (token, 512-wide K slab) when it tiles K; that is an artifact of its
// tiling and is not reproduced.)  x (M, K) float32; packed (K/8*BITS, N)
// uint8; scale/zp (K/g, N) float32; a_bits 2..8; y (M, N) float32.
//
// Two launches:
//  1. act_quant (common.cuh, shared with w8a8_matmul): one block per row.
//     A NaN-propagating max |x| gives
//     a_scale = max(bound, 1e-8) / qmax (IEEE division), the int8 codes
//     clip(rint(x / a_scale)) (round half to even, as the plain version)
//     go to a scratch (M, K) int8 buffer, and their per-group row sums to
//     (M, K/g) int32.  This is the whole-row pre-pass the one-scale
//     contract needs; it moves M*K*5 bytes, small next to the weights.
//  2. w4a8_main: one 32x64 output tile per block, 256 threads with 2x4
//     outputs each.  Codes are unpacked, centred by off = 2^(BITS-1) and
//     widened to int8 while a 32-deep K slab is staged in shared memory
//     (Hopper has no int4 MMA), then reduced four at a time with dp4a into
//     int32.  At each group boundary the float32 epilogue runs in the
//     plain version's exact op order, with explicitly rounded intrinsics so
//     the compiler cannot contract it into FMAs:
//         acc += scale_g * (float(dot) + float(rsum) * (off - zp_g))
//     and the tile ends with acc * a_scale.  The integer dot is exact, so
//     kernel and plain version agree bit for bit.
//     For M <= 8 (decode) w4a8_decode runs instead: 32 columns per block,
//     the K groups spread over its warps, the group terms summed in order
//     afterwards (same bits).
//
// What bounds it on an H100: at decode (M <= 8) the packed weight stream,
// K*N*BITS/8 + 8*K*N/g bytes against 3.35 TB/s; at prefill the 2*M*K*N
// int8 operations, which the tensor cores could do at 1,979 TOP/s.  This
// first version uses dp4a on the CUDA cores, far below that: mma.sync /
// wgmma on int8 operands is the next step for prefill.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 32, THREADS = 256, KW = BK / 4;
constexpr int DEC_SMEM_MAX = 96 * 1024;      // decode path's group terms

template <int BITS>
__global__ void __launch_bounds__(THREADS)
w4a8_main_kernel(const int8_t* __restrict__ xq,
                 const float* __restrict__ a_scale,
                 const int* __restrict__ rsum,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale,
                 const float* __restrict__ zp, float* __restrict__ y, int M,
                 int K, int N, int group) {
  __shared__ __align__(16) int xs[KW][BM];   // 4 int8 codes per word, K-major
  __shared__ __align__(16) int ws[KW][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kwords = K / 4, gwords = group / 4, groups = K / group;
  const float off = (float)(1 << (BITS - 1));
  int dot[2][4] = {};
  float acc[2][4] = {};
  int gi = 0, next_b = gwords;               // word index of the group's end

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // activation codes: one word per thread
      int m = tid / KW, w = tid % KW;
      int gm = m0 + m, gw = k0 / 4 + w;
      xs[w][m] = (gm < M && gw < kwords)
                     ? *reinterpret_cast<const int*>(xq + (long long)gm * K + 4 * gw)
                     : 0;
    }
    {  // weight codes: one (unit, column) pair per thread -> two words
      int n = tid % BN, u = tid / BN;
      int gn = n0 + n;
      long long gu = k0 / 8 + u;
      int w0 = 0, w1 = 0;
      if (gn < N && gu < K / 8) {
        uint64_t lane = aq::load_unit<BITS>(packed, gu, gn, N);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w0 |= ((aq::unit_code<BITS>(lane, j) - (1 << (BITS - 1))) & 0xff) << (8 * j);
          w1 |= ((aq::unit_code<BITS>(lane, j + 4) - (1 << (BITS - 1))) & 0xff) << (8 * j);
        }
      }
      ws[2 * u][n] = w0;
      ws[2 * u + 1][n] = w1;
    }
    __syncthreads();
    const int wend = min(KW, kwords - k0 / 4);
    for (int w = 0; w < wend; ++w) {
      int2 a = *reinterpret_cast<const int2*>(&xs[w][ty * 2]);
      int4 b = *reinterpret_cast<const int4*>(&ws[w][tx * 4]);
      int av[2] = {a.x, a.y}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = __dp4a(av[i], bv[j], dot[i][j]);
      if (k0 / 4 + w + 1 == next_b) {          // group boundary: f32 epilogue
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          int gm = m0 + ty * 2 + i;
          float rs = gm < M ? (float)rsum[(long long)gm * groups + gi] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int gn = n0 + tx * 4 + j;
            if (gn < N) {
              float sc = scale[(long long)gi * N + gn];
              float z = zp[(long long)gi * N + gn];
              float t = __fadd_rn(__int2float_rn(dot[i][j]),
                                  __fmul_rn(rs, __fsub_rn(off, z)));
              acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(sc, t));
            }
            dot[i][j] = 0;
          }
        }
        ++gi;
        next_b += gwords;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int gm = m0 + ty * 2 + i;
    if (gm >= M) continue;
    float s = a_scale[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < N) y[(long long)gm * N + gn] = __fmul_rn(acc[i][j], s);
    }
  }
}

// Decode shape (M <= DEC_MMAX): the tile kernel above keeps few loads in
// flight when M is small, so the weight stream runs far below the card's
// bandwidth.  Here a block owns 32 columns (one per lane) and its 8 warps
// take the K groups round-robin, each lane issuing its column's packed
// bytes directly (a warp's load is one full 32-byte sector).  The
// per-group float32 terms scale_g * (float(dot) + float(rsum) * (off - zp))
// go to shared memory, and one pass adds them in group order, so the
// result is the tile kernel's bit for bit.
constexpr int DEC_MMAX = 8, DEC_COLS = 32;

template <int BITS>
__global__ void __launch_bounds__(THREADS)
w4a8_decode_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ a_scale,
                   const int* __restrict__ rsum,
                   const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale,
                   const float* __restrict__ zp, float* __restrict__ y, int M,
                   int K, int N, int group) {
  extern __shared__ float terms[];           // [groups][M][DEC_COLS]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * DEC_COLS + lane;
  const int groups = K / group, units = group / 8;
  const int off_i = 1 << (BITS - 1);
  const float off = (float)off_i;
  for (int gi = warp; gi < groups && n < N; gi += THREADS / 32) {
    int dot[DEC_MMAX] = {};
#pragma unroll 4
    for (int u = 0; u < units; ++u) {
      const long long gu = (long long)gi * units + u;
      const uint64_t lane64 = aq::load_unit<BITS>(packed, gu, n, N);
      int w0 = 0, w1 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w0 |= ((aq::unit_code<BITS>(lane64, j) - off_i) & 0xff) << (8 * j);
        w1 |= ((aq::unit_code<BITS>(lane64, j + 4) - off_i) & 0xff) << (8 * j);
      }
#pragma unroll
      for (int m = 0; m < DEC_MMAX; ++m) {
        if (m < M) {
          const int2 xv = __ldg(reinterpret_cast<const int2*>(
              xq + (long long)m * K + gu * 8));
          dot[m] = __dp4a(xv.y, w1, __dp4a(xv.x, w0, dot[m]));
        }
      }
    }
    const float sc = scale[(long long)gi * N + n];
    const float z = zp[(long long)gi * N + n];
#pragma unroll
    for (int m = 0; m < DEC_MMAX; ++m) {
      if (m < M) {
        const float t = __fadd_rn(__int2float_rn(dot[m]),
                                  __fmul_rn((float)rsum[(long long)m * groups + gi],
                                            __fsub_rn(off, z)));
        terms[(gi * M + m) * DEC_COLS + lane] = __fmul_rn(sc, t);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * DEC_COLS; i += THREADS) {
    const int m = i / DEC_COLS, l = i % DEC_COLS;
    const int col = blockIdx.x * DEC_COLS + l;
    if (col >= N) continue;
    float acc = 0.f;
    for (int gi = 0; gi < groups; ++gi)
      acc = __fadd_rn(acc, terms[(gi * M + m) * DEC_COLS + l]);
    y[(long long)m * N + col] = __fmul_rn(acc, a_scale[m]);
  }
}

template <int BITS>
cudaError_t launch_main(const int8_t* xq, const float* a_scale, const int* rsum,
                        const uint8_t* packed, const float* scale,
                        const float* zp, float* y, int M, int K, int N,
                        int group, cudaStream_t s) {
  const int terms_bytes = (K / group) * M * DEC_COLS * (int)sizeof(float);
  if (M <= DEC_MMAX && terms_bytes <= DEC_SMEM_MAX) {
    cudaError_t err = cudaFuncSetAttribute(
        w4a8_decode_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        terms_bytes);
    if (err != cudaSuccess) return err;
    w4a8_decode_kernel<BITS><<<(N + DEC_COLS - 1) / DEC_COLS, THREADS,
                               terms_bytes, s>>>(xq, a_scale, rsum, packed,
                                                 scale, zp, y, M, K, N, group);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    w4a8_main_kernel<BITS><<<grid, THREADS, 0, s>>>(xq, a_scale, rsum, packed,
                                                    scale, zp, y, M, K, N,
                                                    group);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int aq_w4a8_matmul(const float* x, int8_t* xq, float* a_scale,
                              int* rsum, const uint8_t* packed,
                              const float* scale, const float* zp, float* y,
                              int M, int K, int N, int bits, int group,
                              int a_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qmax = (float)((1 << (a_bits - 1)) - 1);
  aq::act_quant_kernel<<<M, aq::ACT_THREADS, 0, s>>>(x, xq, a_scale, rsum, K,
                                                     group, qmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (bits) {
    case 2:
      return (int)launch_main<2>(xq, a_scale, rsum, packed, scale, zp, y, M, K,
                                 N, group, s);
    case 4:
      return (int)launch_main<4>(xq, a_scale, rsum, packed, scale, zp, y, M, K,
                                 N, group, s);
    case 8:
      return (int)launch_main<8>(xq, a_scale, rsum, packed, scale, zp, y, M, K,
                                 N, group, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
