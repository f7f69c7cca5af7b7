// Chunked causal prefill attention over the linear KV cache as stored.
//
// Replaces the TPU kernel repro/kernels/flash_prefill.py::flash_prefill
// (linear layout; the paged variant and the kv4 layout come later).
// q (B, Hkv, C, G, D) float32: a C-token chunk whose token c sits at
// position offset[b] + c, its G query heads per KV head folded into
// R = C*G rows (row r is token r / G).  k/v (B, S, Hkv, D) int8 codes with
// (B, S, Hkv) float32 scales (kv8) or float32 (kv16), the chunk's own K/V
// already written.  Position p is valid for row r iff
// p <= offset[b] + r/G and r/G < chunk_len[b]; rows past chunk_len (and
// every row of a chunk_len == 0 sequence) visit no tile and return zeros.
// out (B, Hkv, C, G, D) float32.
//
// What bounds it on an H100: at the serving shapes (C up to a few hundred)
// the 4*D float32 operations per (row, valid position), about
// B*Hq*C*(offset + C/2)*4*D in all, against the 67 TFLOP/s of the CUDA
// cores; the cache bytes of the attended prefix are read once per block
// of 16 rows.  Design (flash_common.cuh): one block per (batch, kv-head,
// 16 rows), the KV walk a loop inside the block that stops at the block's
// last valid position, each tile dequantized in shared memory, online
// softmax in float32.  The score and p @ v products run on the CUDA cores;
// a tensor-core (mma / wgmma) version is later work.
#include "flash_common.cuh"

namespace {

constexpr int RT = 16;

template <bool INT8>
__global__ void __launch_bounds__(aq::FLASH_THREADS)
flash_prefill_kernel(const float* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ offset,
                     const int* __restrict__ chunk_len, float* __restrict__ out,
                     int S, int Hkv, int C, int G, int D, float scale) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int R = C * G;
  const int nrows = min(RT, R - r0);
  int* ends = aq::flash_ends<RT>(smem, D);
  if (threadIdx.x < RT) {
    const int r = r0 + threadIdx.x, c = r / G;
    const int cl = chunk_len[b];
    ends[threadIdx.x] =
        (threadIdx.x < nrows && c < cl) ? min(offset[b] + c + 1, S) : 0;
  }
  __syncthreads();
  const long long bh = ((long long)b * Hkv + h);
  const long long kv_off = (long long)b * S * Hkv * D + (long long)h * D;
  const long long sc_off = (long long)b * S * Hkv + h;
  const long long elt = INT8 ? 1 : 4;
  aq::flash_rows<RT, INT8>(
      q + (bh * R + r0) * D, static_cast<const char*>(k) + kv_off * elt,
      static_cast<const char*>(v) + kv_off * elt,
      INT8 ? k_scale + sc_off : nullptr, INT8 ? v_scale + sc_off : nullptr, Hkv,
      D, scale, nrows, out + (bh * R + r0) * D, smem);
}

}  // namespace

extern "C" int aq_flash_prefill(const float* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                const int* offset, const int* chunk_len,
                                float* out, int B, int S, int Hkv, int C, int G,
                                int D, float scale, int kv_int8, void* stream) {
  if (D > 2 * aq::FLASH_THREADS) return (int)cudaErrorInvalidValue;
  const int smem = aq::flash_smem_bytes<RT>(D);
  dim3 grid((C * G + RT - 1) / RT, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8) {
    cudaFuncSetAttribute(flash_prefill_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_prefill_kernel<true><<<grid, aq::FLASH_THREADS, smem, s>>>(
        q, k, v, k_scale, v_scale, offset, chunk_len, out, S, Hkv, C, G, D,
        scale);
  } else {
    cudaFuncSetAttribute(flash_prefill_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_prefill_kernel<false><<<grid, aq::FLASH_THREADS, smem, s>>>(
        q, k, v, k_scale, v_scale, offset, chunk_len, out, S, Hkv, C, G, D,
        scale);
  }
  return (int)cudaGetLastError();
}
