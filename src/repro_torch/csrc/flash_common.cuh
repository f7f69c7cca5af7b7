// What the flash kernels share: the cache views and dequantization
// (kv_value), the online-softmax step (flash_softmax) and the output
// (flash_out).  Each kernel file has its own block body: flash_decode.cu
// for one-token decode (a few rows, a long walk), flash_prefill.cu for
// chunks (many rows).  The two bodies compute every row with the same float
// operations in the same order: every operation that could round
// differently is written with an explicitly rounded intrinsic (__fmul_rn,
// __fsub_rn, __fadd_rn, __fdiv_rn) or fmaf, so nvcc cannot contract it
// differently in the two bodies.  That is what makes a one-token prefill
// chunk equal decode on the same cache bit for bit.
//
// The pinned operations of a row that attends the cache positions
// [0, end) of its (batch, kv-head) pair (end == 0 means a zero row):
//  * tiles of FLASH_T = 32 positions from position 0, up to end;
//  * each cache value is kv_value of its row and column;
//  * the score of a valid position is the fmaf chain over d = 0 .. D-1
//    from +0, then __fmul_rn by the scale; a masked one is FLASH_MASK;
//  * each tile goes through flash_softmax's step (lane = position in the
//    tile; flash_decode.cu computes the same step in two halves);
//  * acc = __fmul_rn(acc, correction), then the fmaf chain p * v over the
//    row's valid positions of the tile in order (a masked position never
//    enters it, so a NaN left in a stale slot cannot leak through 0 * NaN);
//  * the output is flash_out.
// A paged kernel equals its linear kernel: the two layouts differ only in
// the cache row that position p maps to (p itself, or
// page_table[p / page] * page + p % page, a -1 entry reading pool page 0
// as the reference's gather does); only pages below ceil(end / page) are
// looked up, so a 32-position tile may span pages of any size.  No float
// copy of the cache is ever written to device memory.  Three formats (KVB):
//   16  float32 values;
//    8  int8 codes times a float32 scale per (token, head);
//    4  two int4 codes per byte along D (low nibble first, sign-extended)
//       times a bfloat16 scale per 32 values, widened to float32 exactly.
// Scores are float32 dots scaled by 1/sqrt(D) after the sum, as the plain
// version does; the softmax is online in float32 (running max, running
// sum, rescale by exp(m_old - m_new)) with the reference's -1e30 initial
// max.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace aq {

constexpr int FLASH_T = 32;
constexpr int FLASH_MAX_D = 256;
constexpr float FLASH_MASK = -1e30f;
constexpr int KV4_BLOCK = 32;

// Where the cache of one (batch, kv-head) pair lives.  Byte pointers to
// position 0 (linear) or pool row 0 (paged) of the pair's head; cache row
// `row` of it is at k + row * row_bytes (codes or floats) and
// ks + row * srow_bytes (scales).
struct KVView {
  const char* k;
  const char* v;
  const char* ks;
  const char* vs;
  long long row_bytes;
  long long srow_bytes;
  const int* pt;   // the pair's page-table row; nullptr for the linear cache
  int page;        // page size (paged)
};

// The view of head h at cache row `row0` (b * S linear, 0 paged) of
// caches (rows, Hkv, Dk) with scales (rows, Hkv[, D / 32]).
template <int KVB>
__device__ __forceinline__ KVView kv_view(const void* k, const void* v,
                                          const void* ks, const void* vs,
                                          int Hkv, int D, int h,
                                          long long row0) {
  const long long elt = KVB == 16 ? 4 : 1;
  const long long dk = KVB == 4 ? D / 2 : D;
  const long long sbytes = KVB == 4 ? (D / KV4_BLOCK) * 2 : (KVB == 8 ? 4 : 0);
  KVView kv;
  kv.row_bytes = Hkv * dk * elt;
  kv.srow_bytes = Hkv * sbytes;
  const long long off = row0 * kv.row_bytes + h * dk * elt;
  const long long soff = row0 * kv.srow_bytes + h * sbytes;
  kv.k = static_cast<const char*>(k) + off;
  kv.v = static_cast<const char*>(v) + off;
  kv.ks = KVB == 16 ? nullptr : static_cast<const char*>(ks) + soff;
  kv.vs = KVB == 16 ? nullptr : static_cast<const char*>(vs) + soff;
  kv.pt = nullptr;
  kv.page = 0;
  return kv;
}

// kv4 nibbles of a sign-extended byte x: d even (low) and d odd (high).
__device__ __forceinline__ int kv4_lo(int x) { return (int)((unsigned)x << 28) >> 28; }
__device__ __forceinline__ int kv4_hi(int x) { return x >> 4; }
// A bfloat16 scale's bits, widened to float32 exactly.
__device__ __forceinline__ float bf16_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// Value d of cache row `row`, dequantized to float32.
template <int KVB>
__device__ __forceinline__ float kv_value(const char* base, const char* sbase,
                                          long long row, long long row_bytes,
                                          long long srow_bytes, int d) {
  const char* r = base + row * row_bytes;
  if (KVB == 16) return reinterpret_cast<const float*>(r)[d];
  if (KVB == 8)
    return __fmul_rn((float)reinterpret_cast<const int8_t*>(r)[d],
                     *reinterpret_cast<const float*>(sbase + row * srow_bytes));
  const int x = (int)reinterpret_cast<const int8_t*>(r)[d >> 1];
  const unsigned bits = *reinterpret_cast<const uint16_t*>(
      sbase + row * srow_bytes + (d / KV4_BLOCK) * 2);
  return __fmul_rn((float)((d & 1) ? kv4_hi(x) : kv4_lo(x)), bf16_float(bits));
}

// The online-softmax step of NR rows over one 32-position tile, called by
// a whole warp whose lane is the position in the tile, in three parts that
// both block bodies use: the tile's max (flash_tile_max), the entering max
// folded with it, m_new = fmaxf(m_old, max), then p and their sum
// (flash_tile_p), and the running sum's update with the correction
// exp(m_old - m_new) (flash_fold).  The butterfly max and sum fix the order
// of the tile's reduction.  s[j] is the lane's scaled score for row j
// (FLASH_MASK where !valid[j]) and becomes its p (0 where !valid[j]).  The
// NR rows' steps are interleaved for instruction-level parallelism; each
// row's operations and their order are those of a lone row.
template <int NR>
__device__ __forceinline__ void flash_tile_max(const float (&s)[NR],
                                               float (&mx)[NR]) {
#pragma unroll
  for (int j = 0; j < NR; ++j) mx[j] = s[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < NR; ++j)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
}

template <int NR>
__device__ __forceinline__ void flash_tile_p(float (&s)[NR],
                                             const bool (&valid)[NR],
                                             const float (&m_new)[NR],
                                             float (&sum)[NR]) {
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    s[j] = valid[j] ? expf(__fsub_rn(s[j], m_new[j])) : 0.f;
    sum[j] = s[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < NR; ++j) sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], o);
}

// The correction of a tile whose rows entered at m_old and leave at m_new,
// and the running sum after it.
__device__ __forceinline__ float flash_corr(float m_old, float m_new) {
  return expf(__fsub_rn(m_old, m_new));
}
__device__ __forceinline__ float flash_fold(float l, float corr, float sum) {
  return __fadd_rn(__fmul_rn(l, corr), sum);
}

// The whole step for one tile, the running max, sum and this tile's
// correction of row row[j] at ms, ls, cs[row[j]] (lane 0 writes them).  A
// row with no valid position in the tile (!active) keeps its max and sum
// and gets the correction 1.
template <int NR>
__device__ __forceinline__ void flash_softmax(float (&s)[NR],
                                              const bool (&valid)[NR],
                                              const bool (&active)[NR],
                                              const int (&row)[NR], float* ms,
                                              float* ls, float* cs, int lane) {
  float mx[NR], m_old[NR], m_new[NR], sum[NR];
  flash_tile_max<NR>(s, mx);
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    m_old[j] = ms[row[j]];
    m_new[j] = fmaxf(m_old[j], mx[j]);
  }
  flash_tile_p<NR>(s, valid, m_new, sum);
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      if (!active[j]) {
        cs[row[j]] = 1.f;
        continue;
      }
      const float corr = flash_corr(m_old[j], m_new[j]);
      cs[row[j]] = corr;
      ls[row[j]] = flash_fold(ls[row[j]], corr, sum[j]);
      ms[row[j]] = m_new[j];
    }
  }
}

// A row's output: acc / max(l, 1e-30), zero for a row that attends nothing.
__device__ __forceinline__ float flash_out(float acc, float l, int end) {
  return end > 0 ? __fdiv_rn(acc, fmaxf(l, 1e-30f)) : 0.f;
}

// Launch-side helpers: check the shapes the kernels take, and call
// f(std::integral_constant<int, KVB>) for the cache format code.
inline bool flash_shapes_ok(int D, int kv_bits) {
  return D > 0 && D <= FLASH_MAX_D && (kv_bits != 4 || D % KV4_BLOCK == 0);
}

template <typename F>
inline int with_kv_format(int kv_bits, F f) {
  switch (kv_bits) {
    case 16: return f(std::integral_constant<int, 16>());
    case 8: return f(std::integral_constant<int, 8>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace aq
