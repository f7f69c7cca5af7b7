// Shared helpers of the matmul kernels: the 4x4 byte transpose and the
// whole-row activation pre-pass of w4a8_matmul and w8a8_matmul.
//
// Packed layout (repro_torch/core/packing.py): the 8 codes of K rows
// 8u .. 8u+7 of column n sit little-endian in the BITS bytes
// packed[(u * BITS + b) * N + n], b = 0 .. BITS-1; code j occupies bits
// j*BITS .. j*BITS+BITS-1 of that 64-bit lane.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aq {

// Four row words (byte j = column j) -> four column words (byte i = row i).
__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

constexpr int ACT_THREADS = 256;

// Internal linkage: each source that includes this header gets its own copy.
namespace {

// Per-token dynamic symmetric activation codes, one block per row, in the
// plain versions' op order: a NaN-propagating max |x| gives
// a_scale = max(bound, 1e-8) / qmax (IEEE division); the codes
// clip(rint(x / a_scale), -qmax - 1, qmax) (round half to even) go to xq
// (M, K) int8.  With rsum != nullptr the per-group row sums of the codes go
// to rsum (M, K / group) int32.  Block 0 also zeroes the nzero words of
// `zero` (the next launch's counters; nullptr and 0 when it has none).
__global__ void __launch_bounds__(ACT_THREADS)
act_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                 float* __restrict__ a_scale, int* __restrict__ rsum, int K,
                 int group, float qmax, unsigned* __restrict__ zero,
                 int nzero) {
  __shared__ float red[ACT_THREADS / 32];
  __shared__ int red_nan[ACT_THREADS / 32];
  __shared__ float s_scale;
  const int m = blockIdx.x, tid = threadIdx.x;
  if (m == 0)
    for (int i = tid; i < nzero; i += ACT_THREADS) zero[i] = 0u;
  const float* xr = x + (long long)m * K;
  float mx = 0.f;
  int has_nan = 0;
  for (int k = tid; k < K; k += ACT_THREADS) {
    float v = fabsf(xr[k]);
    has_nan |= isnan(v);
    mx = fmaxf(mx, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    has_nan |= __shfl_xor_sync(0xffffffffu, has_nan, o);
  }
  if (tid % 32 == 0) { red[tid / 32] = mx; red_nan[tid / 32] = has_nan; }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < ACT_THREADS / 32; ++w) {
      mx = fmaxf(mx, red[w]);
      has_nan |= red_nan[w];
    }
    float bound = has_nan ? __int_as_float(0x7fc00000) : fmaxf(mx, 1e-8f);
    s_scale = bound / qmax;
    a_scale[m] = s_scale;
  }
  __syncthreads();
  const float s = s_scale;
  int8_t* xqr = xq + (long long)m * K;
  for (int k = tid; k < K; k += ACT_THREADS) {
    float q = fminf(fmaxf(rintf(xr[k] / s), -qmax - 1.f), qmax);
    xqr[k] = (int8_t)__float2int_rn(q);
  }
  if (rsum == nullptr) return;
  __syncthreads();
  // per-group row sums of the codes just written (visible after the barrier)
  const int groups = K / group, warp = tid / 32, lane = tid % 32;
  for (int gi = warp; gi < groups; gi += ACT_THREADS / 32) {
    int acc = 0;
    for (int k = lane; k < group; k += 32) acc += xqr[(long long)gi * group + k];
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) rsum[(long long)m * groups + gi] = acc;
  }
}

}  // namespace

}  // namespace aq
