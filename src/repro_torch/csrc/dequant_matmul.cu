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
// Design: one 64x64 output tile per block, 256 threads with 4x4 outputs
// each.  The K loop stages a 32-deep slab of x and of the weight in shared
// memory; the weight is unpacked and dequantized once while it is staged
// ((code - zp) * scale with separate float32 rounding, as the plain
// version computes it), so each packed byte is read from device memory
// once per block and never written back in float.  Accumulation is float32
// fused multiply-add.  Simple first: no cp.async pipeline, no split-K.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;

template <int BITS>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_kernel(const float* __restrict__ x,
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
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
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
          ws[u * 8 + j][n] =
              __fmul_rn(__fsub_rn((float)aq::unit_code<BITS>(lane, j), z), sc);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < N) y[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int aq_dequant_matmul(const float* x, const uint8_t* packed,
                                 const float* scale, const float* zp,
                                 float* y, int M, int K, int N, int bits,
                                 int group, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      dequant_matmul_kernel<2><<<grid, THREADS, 0, s>>>(x, packed, scale, zp,
                                                        y, M, K, N, group);
      break;
    case 4:
      dequant_matmul_kernel<4><<<grid, THREADS, 0, s>>>(x, packed, scale, zp,
                                                        y, M, K, N, group);
      break;
    case 8:
      dequant_matmul_kernel<8><<<grid, THREADS, 0, s>>>(x, packed, scale, zp,
                                                        y, M, K, N, group);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
