// One-token GQA decode attention over the linear KV cache as stored.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (linear layout; the paged variant and the kv4 layout come later).
// q (B, Hkv, G, D) float32 with the G query heads of a KV head folded
// together; k/v (B, S, Hkv, D) int8 codes with k_scale/v_scale (B, S, Hkv)
// float32 (kv8), or float32 (kv16); cur_len (B,) int32 valid positions;
// out (B, Hkv, G, D) float32, zeros where cur_len == 0.
//
// What bounds it on an H100: the cache bytes of the valid prefix,
// B*Hkv*cur_len*(2*D + 8) at kv8, against 3.35 TB/s; its B*Hq*cur_len*4*D
// float32 operations are few.  Design (flash_common.cuh): one block per
// (batch, kv-head, 4 query heads), the KV walk a loop inside the block
// that stops at cur_len, each tile dequantized in shared memory, online
// softmax in float32.  K and V are read once per block; with G = 1 the
// block has one live row, so the score stage keeps one warp busy: folding
// more rows or splitting the walk over blocks is later work.
#include "flash_common.cuh"

namespace {

constexpr int RT = 4;

template <bool INT8>
__global__ void __launch_bounds__(aq::FLASH_THREADS)
flash_decode_kernel(const float* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ cur_len, float* __restrict__ out,
                    int S, int Hkv, int G, int D, float scale) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(RT, G - r0);
  int* ends = aq::flash_ends<RT>(smem, D);
  if (threadIdx.x < RT) {
    int e = min(max(cur_len[b], 0), S);
    ends[threadIdx.x] = threadIdx.x < nrows ? e : 0;
  }
  __syncthreads();
  const long long bh = ((long long)b * Hkv + h);
  const long long kv_off = (long long)b * S * Hkv * D + (long long)h * D;
  const long long sc_off = (long long)b * S * Hkv + h;
  const long long elt = INT8 ? 1 : 4;
  aq::flash_rows<RT, INT8>(
      q + (bh * G + r0) * D, static_cast<const char*>(k) + kv_off * elt,
      static_cast<const char*>(v) + kv_off * elt,
      INT8 ? k_scale + sc_off : nullptr, INT8 ? v_scale + sc_off : nullptr, Hkv,
      D, scale, nrows, out + (bh * G + r0) * D, smem);
}

}  // namespace

extern "C" int aq_flash_decode(const float* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* cur_len, float* out, int B, int S,
                               int Hkv, int G, int D, float scale, int kv_int8,
                               void* stream) {
  if (D > 2 * aq::FLASH_THREADS) return (int)cudaErrorInvalidValue;
  const int smem = aq::flash_smem_bytes<RT>(D);
  dim3 grid((G + RT - 1) / RT, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8) {
    cudaFuncSetAttribute(flash_decode_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_decode_kernel<true><<<grid, aq::FLASH_THREADS, smem, s>>>(
        q, k, v, k_scale, v_scale, cur_len, out, S, Hkv, G, D, scale);
  } else {
    cudaFuncSetAttribute(flash_decode_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_decode_kernel<false><<<grid, aq::FLASH_THREADS, smem, s>>>(
        q, k, v, k_scale, v_scale, cur_len, out, S, Hkv, G, D, scale);
  }
  return (int)cudaGetLastError();
}
