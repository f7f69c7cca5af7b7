// y = x @ ((unpack(packed) - zp) * scale): the weight-only packed matmul.
//
// Replaces the TPU kernel repro/kernels/dequant_matmul.py::dequant_matmul
// (the Pallas body _kernel / _unpack_block).  It runs every linear of the
// a16 serving path: x (M, K) float32, packed (K/8*BITS, N) uint8,
// scale/zp (K/g, N) float32, y (M, N) float32.
//
// What bounds it on an H100: at decode (M <= 8) the packed weight stream,
// K*N*BITS/8 bytes plus 8*K*N/g bytes of scale and zero point, against
// 3.35 TB/s.  At prefill (M in the hundreds) the 2*M*K*N float32
// multiply-adds against the 67 TFLOP/s of the CUDA cores: x is float32, so
// there is no tensor-core path that keeps float32 accuracy (no TF32).
//
// The pinned arithmetic.  A row of y is the same bit for bit whatever M is
// and whichever body runs, so that chunked admission and preemption, which
// recompute a token's K/V at another M, see the same numbers.  Every
// weight is (code - zp) * scale with separate float32 roundings, as the
// plain version computes it; K is cut into splits of SPLIT = 512 rows; in
// each split y[m][n] is an fmaf chain over its rows in increasing order,
// from +0; the splits' chains are added left to right,
// ((c0 + c1) + c2) + ..., with __fadd_rn.
//
// Two bodies:
//  * decode (M <= 8): no reuse of a weight across rows to speak of, so the
//    weight stream is all that counts and it needs many loads in flight.
//    A block of 256 threads owns 256 columns and one split, a thread one
//    column (a warp reads 32 contiguous bytes of each packed byte row), so
//    that the M chains of a column-split are all a thread computes and
//    enough warps are resident to hide latency (88K threads at
//    4096->11008).  A thread walks the split's units of 8 rows in batches
//    of 16 / BITS units, all of a batch's 16 byte loads issued before the
//    first use (more per batch cost occupancy and ran slower); x of the
//    split sits in shared memory.  Each split's chains go to a
//    float32 workspace (splits, M, N) and a second launch adds them in
//    split order (no atomics: the result is deterministic); a single split
//    writes y directly.
//  * tile (M > 8): one 64x64 output tile per block, 256 threads with 4x4
//    outputs each; the K loop stages 32-deep slabs of x and of the
//    dequantized weight in shared memory.  At each split boundary the
//    chains are folded into the running sum in the same order.
// Rows past M are zero and never stored; K tails inside a slab are zero
// codes times zero x, and fmaf(0, 0, acc) returns acc exactly (acc is never
// -0).  A NaN in a row of x stays in that row.
#include "common.cuh"

namespace {

constexpr int SPLIT = 512;
// tile body
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
// decode body
constexpr int DEC_MMAX = 8, DEC_THREADS = 256;

__device__ __forceinline__ float weight(int code, float z, float sc) {
  return __fmul_rn(__fsub_rn((float)code, z), sc);
}

template <int BITS, int MR>
__global__ void __launch_bounds__(DEC_THREADS)
dequant_decode_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ scale,
                      const float* __restrict__ zp, float* __restrict__ part,
                      int M, int K, int N, int group) {
  constexpr int UB = 16 / BITS;                  // units per batch
  __shared__ __align__(16) float xs[SPLIT][MR];  // x[m][k0 + k] at xs[k][m]
  const int n = blockIdx.x * DEC_THREADS + threadIdx.x;
  const int k0 = blockIdx.y * SPLIT;
  const int kn = min(SPLIT, K - k0), units = kn / 8;
  for (int i = threadIdx.x; i < kn * MR; i += DEC_THREADS) {
    const int k = i / MR, m = i % MR;
    xs[k][m] = m < M ? x[(long long)m * K + k0 + k] : 0.f;
  }
  __syncthreads();
  if (n >= N) return;
  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;
  const uint8_t* col = packed + (long long)(k0 / 8) * BITS * N + n;
  for (int u0 = 0; u0 < units; u0 += UB) {
    uint32_t w[UB][BITS];                        // byte b of unit uu
#pragma unroll
    for (int uu = 0; uu < UB; ++uu)
#pragma unroll
      for (int b = 0; b < BITS; ++b)
        w[uu][b] = u0 + uu < units
                       ? (uint32_t)__ldg(col + ((long long)(u0 + uu) * BITS + b) * N)
                       : 0u;
#pragma unroll
    for (int uu = 0; uu < UB; ++uu) {
      if (u0 + uu >= units) break;
      const long long gi = (k0 + 8LL * (u0 + uu)) / group;  // g % 8 == 0
      const float sc = __ldg(scale + gi * N + n), z = __ldg(zp + gi * N + n);
      const int kk = 8 * (u0 + uu);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // code i: bits i*BITS .. of the unit's little-endian bytes
        const int code = (int)((w[uu][i * BITS / 8] >> (i * BITS % 8)) &
                               ((1u << BITS) - 1u));
        const float wv = weight(code, z, sc);
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[m] = fmaf(xs[kk + i][m], wv, acc[m]);
      }
    }
  }
  float* out = part + (long long)blockIdx.y * M * N + n;
#pragma unroll
  for (int m = 0; m < MR; ++m)
    if (m < M) out[(long long)m * N] = acc[m];
}

// y = ((part[0] + part[1]) + part[2]) + ...
__global__ void __launch_bounds__(THREADS)
split_sum_kernel(const float* __restrict__ part, float* __restrict__ y,
                 long long mn, int splits) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[k * mn + i]);
  y[i] = s;
}

// tot = first ? acc : tot + acc; acc = 0
__device__ __forceinline__ void fold(float (&tot)[4][4], float (&acc)[4][4],
                                     bool first) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tot[i][j] = first ? acc[i][j] : __fadd_rn(tot[i][j], acc[i][j]);
      acc[i][j] = 0.f;
    }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
dequant_tile_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zp, float* __restrict__ y,
                    int M, int K, int N, int group) {
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int units = K / 8;
  float acc[4][4] = {}, tot[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (k0 > 0 && k0 % SPLIT == 0) fold(tot, acc, k0 == SPLIT);
    // x slab: BM x BK floats, coalesced along K, stored K-major
    for (int i = tid; i < BM * BK; i += THREADS) {
      int m = i / BK, kk = i % BK;
      int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
    }
    // weight slab: one (unit of 8 K rows, column) pair per thread
    {
      int n = tid % BN, u = tid / BN;        // u in 0..3
      int gn = n0 + n;
      long long gu = k0 / 8 + u;
      if (gn < N && gu < units) {
        uint64_t lane = aq::load_unit<BITS>(packed, gu, gn, N);
        long long gi = gu * 8 / group;       // group % 8 == 0: one group
        float sc = scale[gi * N + gn], z = zp[gi * N + gn];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ws[u * 8 + j][n] = weight(aq::unit_code<BITS>(lane, j), z, sc);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) ws[u * 8 + j][n] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  fold(tot, acc, K <= SPLIT);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < N) y[(long long)gm * N + gn] = tot[i][j];
    }
  }
}

template <int BITS>
cudaError_t launch(const float* x, const uint8_t* packed, const float* scale,
                   const float* zp, float* y, float* part, int M, int K, int N,
                   int group, cudaStream_t s) {
  if (M > DEC_MMAX) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    dequant_tile_kernel<BITS><<<grid, THREADS, 0, s>>>(x, packed, scale, zp,
                                                       y, M, K, N, group);
    return cudaGetLastError();
  }
  const int splits = max(1, (K + SPLIT - 1) / SPLIT);
  float* dst = splits > 1 ? part : y;
  dim3 grid((N + DEC_THREADS - 1) / DEC_THREADS, splits);
#define AQ_DEC(MR)                                                            \
  dequant_decode_kernel<BITS, MR><<<grid, DEC_THREADS, 0, s>>>(               \
      x, packed, scale, zp, dst, M, K, N, group)
  if (M == 1) AQ_DEC(1);
  else if (M == 2) AQ_DEC(2);
  else if (M <= 4) AQ_DEC(4);
  else AQ_DEC(8);
#undef AQ_DEC
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  split_sum_kernel<<<(unsigned)((mn + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      part, y, mn, splits);
  return cudaGetLastError();
}

}  // namespace

// part: the decode body's float32 workspace, ceil(K / 512) x M x N (the
// wrapper allocates it for M <= 8 and K > 512; unused otherwise).
extern "C" int aq_dequant_matmul(const float* x, const uint8_t* packed,
                                 const float* scale, const float* zp,
                                 float* y, float* part, int M, int K, int N,
                                 int bits, int group, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return (int)launch<2>(x, packed, scale, zp, y, part, M, K, N, group, s);
    case 4: return (int)launch<4>(x, packed, scale, zp, y, part, M, K, N, group, s);
    case 8: return (int)launch<8>(x, packed, scale, zp, y, part, M, K, N, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
