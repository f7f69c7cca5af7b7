// Chunked causal prefill attention over the KV cache as stored: the linear
// cache (aq_flash_prefill) and the paged pool (aq_flash_prefill_paged).
//
// Replaces the TPU kernels repro/kernels/flash_prefill.py::flash_prefill
// (linear) and ::flash_prefill_paged (page pool + page table).
// q (B, Hkv, C, G, D) float32: a C-token chunk whose token c sits at
// position offset[b] + c, its G query heads per KV head folded into
// R = C*G rows (row r is token r / G).  The cache in the layouts and
// formats of flash_decode.cu (kv16, kv8, kv4; linear or paged), with the
// chunk's own K/V already written.  Position p is valid for row r iff
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
// softmax in float32.  The paged kernel is the linear one with each
// position's row looked up in the page table.  The score and p @ v
// products run on the CUDA cores; a tensor-core (mma / wgmma) version is
// later work.
#include "flash_common.cuh"

namespace {

constexpr int RT = 16;

template <int KVB>
__device__ void prefill_block(const float* __restrict__ q, const aq::KVView& kv,
                              int offset, int chunk_len, int cap,
                              float* __restrict__ out, int Hkv, int C, int G,
                              int D, float scale) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int R = C * G;
  const int nrows = min(RT, R - r0);
  int* ends = aq::flash_ends<RT>(smem, D);
  if (threadIdx.x < RT) {
    const int c = (r0 + threadIdx.x) / G;
    ends[threadIdx.x] =
        (threadIdx.x < nrows && c < chunk_len) ? min(offset + c + 1, cap) : 0;
  }
  __syncthreads();
  const long long row0 = ((long long)b * Hkv + h) * R + r0;
  aq::flash_rows<RT, KVB>(q + row0 * D, kv, D, scale, nrows, out + row0 * D,
                          smem);
}

template <int KVB>
__global__ void __launch_bounds__(aq::FLASH_THREADS)
flash_prefill_kernel(const float* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, const void* __restrict__ k_scale,
                     const void* __restrict__ v_scale,
                     const int* __restrict__ offset,
                     const int* __restrict__ chunk_len, float* __restrict__ out,
                     int S, int Hkv, int C, int G, int D, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h,
                                         (long long)b * S);
  prefill_block<KVB>(q, kv, offset[b], chunk_len[b], S, out, Hkv, C, G, D,
                     scale);
}

template <int KVB>
__global__ void __launch_bounds__(aq::FLASH_THREADS)
flash_prefill_paged_kernel(const float* __restrict__ q,
                           const void* __restrict__ k, const void* __restrict__ v,
                           const void* __restrict__ k_scale,
                           const void* __restrict__ v_scale,
                           const int* __restrict__ page_table,
                           const int* __restrict__ offset,
                           const int* __restrict__ chunk_len,
                           float* __restrict__ out, int page, int max_pages,
                           int Hkv, int C, int G, int D, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h, 0);
  kv.pt = page_table + (long long)b * max_pages;
  kv.page = page;
  prefill_block<KVB>(q, kv, offset[b], chunk_len[b], page * max_pages, out,
                     Hkv, C, G, D, scale);
}

template <typename K, typename... Args>
int launch(K kernel, int B, int Hkv, int C, int G, int D, cudaStream_t s,
           Args... args) {
  const int smem = aq::flash_smem_bytes<RT>(D);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((C * G + RT - 1) / RT, Hkv, B);
  kernel<<<grid, aq::FLASH_THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aq_flash_prefill(const float* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const int* offset, const int* chunk_len,
                                float* out, int B, int S, int Hkv, int C, int G,
                                int D, float scale, int kv_bits, void* stream) {
  if (!aq::flash_shapes_ok(D, kv_bits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aq::with_kv_format(kv_bits, [&](auto f) {
    constexpr int KVB = decltype(f)::value;
    return launch(flash_prefill_kernel<KVB>, B, Hkv, C, G, D, s, q, k, v,
                  k_scale, v_scale, offset, chunk_len, out, S, Hkv, C, G, D,
                  scale);
  });
}

extern "C" int aq_flash_prefill_paged(const float* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale,
                                      const int* page_table, const int* offset,
                                      const int* chunk_len, float* out, int B,
                                      int page, int max_pages, int Hkv, int C,
                                      int G, int D, float scale, int kv_bits,
                                      void* stream) {
  if (!aq::flash_shapes_ok(D, kv_bits) || page < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aq::with_kv_format(kv_bits, [&](auto f) {
    constexpr int KVB = decltype(f)::value;
    return launch(flash_prefill_paged_kernel<KVB>, B, Hkv, C, G, D, s, q, k, v,
                  k_scale, v_scale, page_table, offset, chunk_len, out, page,
                  max_pages, Hkv, C, G, D, scale);
  });
}
