// Per-group asymmetric RTN quantization of a weight and its packing along K.
//
// Replaces the TPU kernel repro/kernels/quantize_pack.py::quantize_pack
// (Pallas body _kernel, _pack_block) and holds to the plain oracle
// repro/kernels/ref.py::quantize_pack_ref.  w (K, N) float32, finite; per
// group of `group` rows along K and column n:
//     scale = max(wmax - wmin, 1e-8) / (2^BITS - 1)      (IEEE division)
//     zp    = rint(-wmin / scale)
//     code  = clip(rint(w / scale) + zp, 0, 2^BITS - 1)
// rint rounds half to even, as torch.round and jnp.round do; no step is a
// multiply-add, so nvcc has nothing to contract.  The 8 codes of K rows
// 8u .. 8u+7 go little-endian into the BITS bytes packed[(u*BITS + b), n]
// (repro_torch/core/packing.py, the layout common.cuh reads).  Outputs:
// packed (K/8*BITS, N) uint8, scale and zp (K/group, N) float32, all equal
// byte for byte to the plain version.
//
// One block per (group, 32-column tile): 8 rows of 32 threads, neighbouring
// threads on neighbouring columns (N is w's fast axis, so a warp reads 128
// contiguous bytes of a row).  Pass 1 reduces min and max down the group
// (exact in any order) and fixes scale and zp; pass 2 reads the group
// again (from L2 at the sizes here), one 8-row packing unit per thread at
// a time, and writes its BITS bytes.
//
// What bounds it on an H100: the bytes, 4*K*N read plus K*N*BITS/8 + 8*N*K/g
// written, at 3.35 TB/s; the float work is a few operations per element.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32, ROWS = 8, THREADS = COLS * ROWS;

template <int BITS>
__global__ void __launch_bounds__(THREADS)
quantize_pack_kernel(const float* __restrict__ w, uint8_t* __restrict__ packed,
                     float* __restrict__ scale, float* __restrict__ zp, int N,
                     int group) {
  __shared__ float s_max[ROWS][COLS], s_min[ROWS][COLS];
  __shared__ float s_scale[COLS], s_zp[COLS];
  const int tx = threadIdx.x % COLS, ty = threadIdx.x / COLS;
  const int n = blockIdx.x * COLS + tx, gi = blockIdx.y;
  const float* wg = w + (long long)gi * group * N;
  const float levels = (float)((1 << BITS) - 1);
  const float inf = __int_as_float(0x7f800000);
  float mx = -inf, mn = inf;
  if (n < N) {
#pragma unroll 4
    for (int k = ty; k < group; k += ROWS) {
      const float v = __ldg(wg + (long long)k * N + n);
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
    }
  }
  s_max[ty][tx] = mx;
  s_min[ty][tx] = mn;
  __syncthreads();
  if (ty == 0) {
    for (int r = 1; r < ROWS; ++r) {
      mx = fmaxf(mx, s_max[r][tx]);
      mn = fminf(mn, s_min[r][tx]);
    }
    const float sc = fmaxf(mx - mn, 1e-8f) / levels;
    const float z = rintf(-mn / sc);
    s_scale[tx] = sc;
    s_zp[tx] = z;
    if (n < N) {
      scale[(long long)gi * N + n] = sc;
      zp[(long long)gi * N + n] = z;
    }
  }
  __syncthreads();
  if (n >= N) return;
  const float sc = s_scale[tx], z = s_zp[tx];
  const int units = group / 8;
  for (int u = ty; u < units; u += ROWS) {
    uint64_t lane = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = __ldg(wg + (long long)(8 * u + j) * N + n);
      const float q = fminf(fmaxf(rintf(v / sc) + z, 0.f), levels);
      lane |= (uint64_t)(unsigned)q << (j * BITS);
    }
    const long long row = ((long long)gi * units + u) * BITS;
#pragma unroll
    for (int b = 0; b < BITS; ++b)
      packed[(row + b) * N + n] = (uint8_t)(lane >> (8 * b));
  }
}

template <int BITS>
cudaError_t launch(const float* w, uint8_t* packed, float* scale, float* zp,
                   int K, int N, int group, cudaStream_t s) {
  dim3 grid((N + COLS - 1) / COLS, K / group);
  quantize_pack_kernel<BITS><<<grid, THREADS, 0, s>>>(w, packed, scale, zp, N,
                                                      group);
  return cudaGetLastError();
}

}  // namespace

extern "C" int aq_quantize_pack(const float* w, uint8_t* packed, float* scale,
                                float* zp, int K, int N, int bits, int group,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return (int)launch<2>(w, packed, scale, zp, K, N, group, s);
    case 4: return (int)launch<4>(w, packed, scale, zp, K, N, group, s);
    case 8: return (int)launch<8>(w, packed, scale, zp, K, N, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
