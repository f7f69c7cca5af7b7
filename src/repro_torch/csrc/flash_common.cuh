// What the flash kernels share: the cache views and dequantization, the
// online-softmax step (flash_softmax) and the output (flash_out), and the
// decode block body (flash_rows), which flash_decode.cu runs for its linear
// and paged entries.  flash_prefill.cu runs its own block body, laid out
// for many rows (see its header), that computes each row with the same
// float operations in the same order as flash_rows: every operation that
// could round differently is written with an explicitly rounded intrinsic
// (__fmul_rn, __fsub_rn, __fadd_rn, __fdiv_rn) or fmaf, so nvcc cannot
// contract it differently in the two bodies.  That is what makes a
// one-token prefill chunk equal decode on the same cache bit for bit.
//
// A block owns up to RT query rows of one (batch, kv-head) pair; row r
// attends the cache positions [0, end[r]) of that pair and end[r] == 0 means
// a zero output row.  Decode gives its G folded query heads end = cur_len;
// prefill gives chunk row (c, g) end = offset + c + 1 while c < chunk_len.
// A paged kernel equals its linear kernel: the two layouts differ only in
// the cache row that position p maps to (p itself, or
// page_table[p / page] * page + p % page), which each tile resolves once
// per position, so a 32-position tile may span pages of any size.  Only
// pages below ceil(end / page) are looked up; a -1 entry there reads pool
// page 0, as the reference's gather does.
//
// The KV walk is a loop inside the block (the TPU kernel's sequential grid
// axis): tiles of T = 32 positions up to max_r end[r], so work and reads
// stop at the valid prefix.  Each tile is read from the cache as stored and
// dequantized into shared memory; no float copy of the cache is ever
// written to device memory.  Three formats (KVB):
//   16  float32 values;
//    8  int8 codes times a float32 scale per (token, head);
//    4  two int4 codes per byte along D (low nibble first, sign-extended)
//       times a bfloat16 scale per 32 values, widened to float32 exactly.
// Scores are float32 dots scaled by 1/sqrt(D) after the sum, as the plain
// version does; the softmax is online in float32 (running max, running
// sum, rescale by exp(m_old - m_new)) with the reference's -1e30 initial
// max.  A masked position never enters the p @ v sum at all (a NaN left in
// a stale slot cannot leak through 0 * NaN).
//
// flash_rows' threads: 4 warps.  Scores: lane = position in the tile, warp
// = row (RT / 4 rows each), rows padded by one float in shared memory
// against bank conflicts.  p @ v: thread t owns head-dim columns t and
// t + 128 for all RT rows, so D <= 256.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace aq {

constexpr int FLASH_T = 32;
constexpr int FLASH_THREADS = 128;
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

// The online-softmax update of NR rows over one 32-position tile, shared
// by both block bodies.  Called by a whole warp whose lane is the position
// in the tile: s[j] is the lane's scaled score for row row[j] (FLASH_MASK
// where !valid[j]) and becomes its p (0 where !valid[j]).  The butterfly
// max and sum fix the order of the tile's reduction; each row's running
// max, sum and this tile's correction live at ms, ls, cs[row] (lane 0
// writes them).  A row with no valid position in the tile (!active) keeps
// its max and sum and gets the correction 1.  The NR rows' steps are
// interleaved for instruction-level parallelism; each row's operations and
// their order are those of a lone row.
template <int NR>
__device__ __forceinline__ void flash_softmax(float (&s)[NR],
                                              const bool (&valid)[NR],
                                              const bool (&active)[NR],
                                              const int (&row)[NR], float* ms,
                                              float* ls, float* cs, int lane) {
  float mx[NR], m_old[NR], m_new[NR], sum[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) mx[j] = s[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < NR; ++j)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    m_old[j] = ms[row[j]];
    m_new[j] = fmaxf(m_old[j], mx[j]);
    s[j] = valid[j] ? expf(__fsub_rn(s[j], m_new[j])) : 0.f;
    sum[j] = s[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < NR; ++j) sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], o);
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      if (!active[j]) {
        cs[row[j]] = 1.f;
        continue;
      }
      const float corr = expf(__fsub_rn(m_old[j], m_new[j]));
      cs[row[j]] = corr;
      ls[row[j]] = __fadd_rn(__fmul_rn(ls[row[j]], corr), sum[j]);
      ms[row[j]] = m_new[j];
    }
  }
}

// A row's output: acc / max(l, 1e-30), zero for a row that attends nothing.
__device__ __forceinline__ float flash_out(float acc, float l, int end) {
  return end > 0 ? __fdiv_rn(acc, fmaxf(l, 1e-30f)) : 0.f;
}

template <int RT>
__host__ __device__ inline int flash_smem_bytes(int D) {
  return (int)sizeof(float) *
             (RT * (D + 1) + FLASH_T * (D + 1) + FLASH_T * D + RT * FLASH_T + 3 * RT) +
         (int)sizeof(int) * (RT + FLASH_T);
}

// The per-row prefix lengths, after the floats in shared memory; the caller
// fills them (zeros for rows past nrows) and synchronises before flash_rows.
template <int RT>
__device__ __forceinline__ int* flash_ends(float* smem, int D) {
  return reinterpret_cast<int*>(
      smem + RT * (D + 1) + FLASH_T * (D + 1) + FLASH_T * D + RT * FLASH_T + 3 * RT);
}

template <int RT, int KVB>
__device__ void flash_rows(const float* __restrict__ q, const KVView kv, int D,
                           float scale, int nrows, float* __restrict__ out,
                           float* smem) {
  float* qs = smem;                          // RT x (D+1)
  float* ks = qs + RT * (D + 1);             // T x (D+1)
  float* vs = ks + FLASH_T * (D + 1);        // T x D
  float* ps = vs + FLASH_T * D;              // RT x T
  float* ms = ps + RT * FLASH_T;             // RT
  float* ls = ms + RT;                       // RT
  float* cs = ls + RT;                       // RT
  const int* ends = flash_ends<RT>(smem, D);  // RT, filled by the caller
  int* rows = flash_ends<RT>(smem, D) + RT;  // T: cache row of each position

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int RPW = RT / 4;                // rows per warp
  for (int i = tid; i < RT * D; i += FLASH_THREADS) {
    int r = i / D, d = i % D;
    qs[r * (D + 1) + d] = r < nrows ? q[(long long)r * D + d] : 0.f;
  }
  if (tid < RT) { ms[tid] = FLASH_MASK; ls[tid] = 0.f; }
  int max_end = 0;
  for (int r = 0; r < RT; ++r) max_end = max(max_end, ends[r]);

  float acc[2][RT];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[c][r] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < max_end; t0 += FLASH_T) {
    const int tn = min(FLASH_T, max_end - t0);
    if (tid < tn) {
      const int pos = t0 + tid;
      rows[tid] = kv.pt == nullptr
                      ? pos
                      : max(kv.pt[pos / kv.page], 0) * kv.page + pos % kv.page;
    }
    __syncthreads();
    for (int i = tid; i < tn * D; i += FLASH_THREADS) {
      const int p = i / D, d = i % D;
      const long long row = rows[p];
      ks[p * (D + 1) + d] =
          kv_value<KVB>(kv.k, kv.ks, row, kv.row_bytes, kv.srow_bytes, d);
      vs[p * D + d] =
          kv_value<KVB>(kv.v, kv.vs, row, kv.row_bytes, kv.srow_bytes, d);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp * RPW + j;
      const int pos = t0 + lane;
      float s[1] = {FLASH_MASK};
      const bool valid[1] = {lane < tn && pos < ends[r]};
      const bool active[1] = {t0 < ends[r]};
      const int row[1] = {r};
      if (valid[0]) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot = fmaf(qs[r * (D + 1) + d], ks[lane * (D + 1) + d], dot);
        s[0] = __fmul_rn(dot, scale);
      }
      flash_softmax<1>(s, valid, active, row, ms, ls, cs, lane);
      ps[r * FLASH_T + lane] = s[0];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = tid + c * FLASH_THREADS;
      if (d >= D) continue;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float a = __fmul_rn(acc[c][r], cs[r]);
        const int n = min(tn, ends[r] - t0);
        for (int p = 0; p < n; ++p) a = fmaf(ps[r * FLASH_T + p], vs[p * D + d], a);
        acc[c][r] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = tid + c * FLASH_THREADS;
    if (d >= D) continue;
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < nrows)
        out[(long long)r * D + d] = flash_out(acc[c][r], ls[r], ends[r]);
  }
}

// Launch-side helpers: check the shapes the kernels take, and call
// f(std::integral_constant<int, KVB>) for the cache format code.
inline bool flash_shapes_ok(int D, int kv_bits) {
  return D > 0 && D <= 2 * FLASH_THREADS && (kv_bits != 4 || D % KV4_BLOCK == 0);
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
