// One-token GQA decode attention over the KV cache as stored: the linear
// cache (aq_flash_decode) and the paged pool (aq_flash_decode_paged).
//
// Replaces the TPU kernels repro/kernels/flash_decode.py::flash_decode
// (linear) and ::flash_decode_paged (page pool + page table).
// q (B, Hkv, G, D) float32 with the G query heads of a KV head folded
// together.  Linear cache: k/v (B, S, Hkv, Dk).  Paged cache: pools
// (P, page, Hkv, Dk) and page_table (B, max_pages) int32, -1 unallocated,
// of which only entries below ceil(cur_len / page) are read.  Formats
// (kv_bits): 16 float32 (Dk = D); 8 int8 codes (Dk = D) with float32 scales
// (..., Hkv); 4 packed int4 nibbles (Dk = D / 2) with bfloat16 scales
// (..., Hkv, D / 32).  cur_len (B,) int32 valid positions; out
// (B, Hkv, G, D) float32, zeros where cur_len == 0.
//
// What bounds it on an H100: the cache bytes of the valid prefix,
// B*Hkv*cur_len per position 2*D + 8 bytes at kv8 and 2*(D/2 + 2*D/32) at
// kv4, against 3.35 TB/s; its B*Hq*cur_len*4*D float32 operations are few.
// Design (flash_common.cuh): one block per (batch, kv-head, 4 query heads),
// the KV walk a loop inside the block that stops at cur_len, each tile
// dequantized in shared memory, online softmax in float32.  The paged
// kernel is the linear one with each position's row looked up in the page
// table, so on the same contents the two are equal bit for bit.  K and V
// are read once per block; with G = 1 the block has one live row, so the
// score stage keeps one warp busy: folding more rows, cp.async page
// gathers or splitting the walk over blocks is later work.
#include "flash_common.cuh"

namespace {

constexpr int RT = 4;

template <int KVB>
__device__ void decode_block(const float* __restrict__ q, const aq::KVView& kv,
                             int cur_len, int cap, float* __restrict__ out,
                             int Hkv, int G, int D, float scale) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(RT, G - r0);
  int* ends = aq::flash_ends<RT>(smem, D);
  if (threadIdx.x < RT)
    ends[threadIdx.x] = threadIdx.x < nrows ? min(max(cur_len, 0), cap) : 0;
  __syncthreads();
  const long long row0 = ((long long)b * Hkv + h) * G + r0;
  aq::flash_rows<RT, KVB>(q + row0 * D, kv, D, scale, nrows, out + row0 * D,
                          smem);
}

template <int KVB>
__global__ void __launch_bounds__(aq::FLASH_THREADS)
flash_decode_kernel(const float* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v, const void* __restrict__ k_scale,
                    const void* __restrict__ v_scale,
                    const int* __restrict__ cur_len, float* __restrict__ out,
                    int S, int Hkv, int G, int D, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h,
                                         (long long)b * S);
  decode_block<KVB>(q, kv, cur_len[b], S, out, Hkv, G, D, scale);
}

template <int KVB>
__global__ void __launch_bounds__(aq::FLASH_THREADS)
flash_decode_paged_kernel(const float* __restrict__ q, const void* __restrict__ k,
                          const void* __restrict__ v,
                          const void* __restrict__ k_scale,
                          const void* __restrict__ v_scale,
                          const int* __restrict__ page_table,
                          const int* __restrict__ cur_len, float* __restrict__ out,
                          int page, int max_pages, int Hkv, int G, int D,
                          float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h, 0);
  kv.pt = page_table + (long long)b * max_pages;
  kv.page = page;
  decode_block<KVB>(q, kv, cur_len[b], page * max_pages, out, Hkv, G, D, scale);
}

template <typename K, typename... Args>
int launch(K kernel, int B, int Hkv, int G, int D, cudaStream_t s, Args... args) {
  const int smem = aq::flash_smem_bytes<RT>(D);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((G + RT - 1) / RT, Hkv, B);
  kernel<<<grid, aq::FLASH_THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aq_flash_decode(const float* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const int* cur_len, float* out, int B, int S,
                               int Hkv, int G, int D, float scale, int kv_bits,
                               void* stream) {
  if (!aq::flash_shapes_ok(D, kv_bits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aq::with_kv_format(kv_bits, [&](auto f) {
    constexpr int KVB = decltype(f)::value;
    return launch(flash_decode_kernel<KVB>, B, Hkv, G, D, s, q, k, v, k_scale,
                  v_scale, cur_len, out, S, Hkv, G, D, scale);
  });
}

extern "C" int aq_flash_decode_paged(const float* q, const void* k,
                                     const void* v, const void* k_scale,
                                     const void* v_scale, const int* page_table,
                                     const int* cur_len, float* out, int B,
                                     int page, int max_pages, int Hkv, int G,
                                     int D, float scale, int kv_bits,
                                     void* stream) {
  if (!aq::flash_shapes_ok(D, kv_bits) || page < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aq::with_kv_format(kv_bits, [&](auto f) {
    constexpr int KVB = decltype(f)::value;
    return launch(flash_decode_paged_kernel<KVB>, B, Hkv, G, D, s, q, k, v,
                  k_scale, v_scale, page_table, cur_len, out, page, max_pages,
                  Hkv, G, D, scale);
  });
}
