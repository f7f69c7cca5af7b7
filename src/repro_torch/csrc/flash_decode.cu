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
// At serving sizes (B 4, Hkv 32, 144 positions) each block reads ~38 KB,
// so the time is the latency of the walk, not bandwidth: the design keeps
// the walk's loads in flight and the tile-ordered part of the softmax
// short.  On long walks the sequential chains (each score's fmaf chain
// over d, each column's p @ v chain over positions) set the time.
//
// Every row keeps the pinned operations of flash_common.cuh, which
// flash_prefill.cu's body repeats, so a one-token prefill chunk equals
// decode and the paged kernel equals the linear one, bit for bit.  The KV
// walk is not split over blocks: merging partial softmax states would
// round differently from the tile-by-tile recurrence.  What the layout
// does instead:
//  * one block of 128 threads per (batch, kv-head, RT query heads), RT =
//    4, 2 or 1: the most rows that still give every SM a block (so the
//    GQA case Hkv 8 G 4 at B 4 runs 128 one-row blocks, four to a pair,
//    which read the same cache rows);
//  * a ring of NS tile stages in shared memory holds each 32-position tile
//    of K and V as stored (codes and scales, rows padded so 8 neighbouring
//    positions' 16-byte reads fall on distinct banks).  Tiles are copied by
//    16-byte cp.async (scales by 4-byte ones) in rounds of up to NW tiles,
//    two rounds in flight (at 144 positions the whole walk is requested
//    at once).  The paged kernel loads each position's pool row
//    one round ahead into a row table that the copies read.  NS is sized
//    per format and D (at most 8 stages, ~200 KB).  A 16-byte copy needs
//    D % 4 (kv16), D % 16 (kv8) or D % 64 (kv4, whose scale row is then
//    whole 4-byte words) and aligned caches; otherwise the same stages are
//    filled value by value and read after a barrier;
//  * scores: warp w scores tile w of the round, lane = position, each
//    score one fmaf chain over d, the staged codes dequantized in registers
//    (the kv8 scale read once per position, the kv4 scale once per 32
//    values), q read from shared memory as broadcast float4s; the warp
//    also takes its tile's max (flash_tile_max);
//  * softmax: the step of flash_common.cuh, split where the running state
//    enters.  Every tile's max is known after the score stage, so a tile's
//    entering max is the running max folded with the earlier tiles' maxima
//    in order, the fmaxf chain of the tile-by-tile step; every scoring warp
//    then finishes its tile's p, sum (flash_tile_p) and correction at once,
//    and one thread per row folds the running sum tile by tile
//    (flash_fold).  Each tile gets exactly the floats that flash_softmax
//    gives it in turn;
//  * p @ v: thread t owns head-dim columns t and t + 128 of every row,
//    dequantizing each staged V value once for all rows, 8 positions at a
//    time, so D <= 256.
// The kernel attribute for dynamic shared memory is set once per kernel
// and device, not per launch.
#include <atomic>

#include "flash_common.cuh"

namespace {

constexpr int T = aq::FLASH_T;
constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;       // warps: tiles scored at once
constexpr int MAX_STAGES = 8;
constexpr int STAGE_BUDGET = 200 * 1024;

// Bytes of one position of one head as stored: codes (or floats), scales.
template <int KVB>
__host__ __device__ inline int code_bytes(int D) {
  return KVB == 16 ? 4 * D : (KVB == 8 ? D : D / 2);
}
template <int KVB>
__host__ __device__ inline int scale_bytes(int D) {
  return KVB == 16 ? 0 : (KVB == 8 ? 4 : D / aq::KV4_BLOCK * 2);
}
// A staged position's strides: codes padded to 16 bytes, plus 16 so the
// 16-byte reads of 8 neighbouring positions fall on distinct banks;
// scales padded to 4 bytes.
template <int KVB>
__host__ __device__ inline int code_stride(int D) {
  return ((code_bytes<KVB>(D) + 15) & ~15) + 16;
}
template <int KVB>
__host__ __device__ inline int scale_stride(int D) {
  return (scale_bytes<KVB>(D) + 3) & ~3;
}
// One stage: K codes, V codes (T x code_stride each), K scales, V scales
// (T x scale_stride each); a multiple of 16 bytes.
template <int KVB>
__host__ __device__ inline int stage_bytes(int D) {
  return 2 * T * (code_stride<KVB>(D) + scale_stride<KVB>(D));
}

// The ring: rounds of `per` tiles (one per scoring warp), `inflight` (2,
// or 1 where a stage is too large for two) rounds requested ahead; NS =
// per * inflight stages.
struct Plan {
  int per, inflight;
};
template <int KVB>
__host__ __device__ inline Plan plan(int D) {
  const int fit = STAGE_BUDGET / stage_bytes<KVB>(D);
  const int ns = fit < MAX_STAGES ? fit : MAX_STAGES;
  Plan p;
  p.inflight = ns >= 2 ? 2 : 1;
  p.per = ns / p.inflight < NW ? ns / p.inflight : NW;
  return p;
}

__host__ __device__ inline int q_stride(int D) { return (D + 3) & ~3; }

// Shared memory: the stages, then Q (RT x q_stride), the scores / p of a
// round (NW x RT x T), the running max and sum (RT each), the round's
// tile maxima, corrections and sums of p (NW x RT each), and the paged
// row table (one int per staged position).
template <int KVB, int RT>
__host__ __device__ inline int smem_bytes(int D) {
  const Plan p = plan<KVB>(D);
  return p.per * p.inflight * (stage_bytes<KVB>(D) + (int)sizeof(int) * T) +
         (int)sizeof(float) * (RT * q_stride(D) + NW * RT * T + 2 * RT + 3 * NW * RT);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `pending` (0 or 1) of the latest groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The paged cache row of position pos of a round, for the thread whose
// index is pos's place in the round: its page's pool row (-1 reads page
// 0); 0 past the walk or for the linear cache, which needs no table.
__device__ __forceinline__ int pool_row(const aq::KVView& kv, int pos, int end) {
  if (kv.pt == nullptr || pos >= end) return 0;
  return max(__ldg(kv.pt + pos / kv.page), 0) * kv.page + pos % kv.page;
}

// Request round `round`'s valid positions (below end) into its stages and
// commit them as one cp.async group (an empty group past the walk).  The
// paged cache first writes each position's pool row (`prow`, resolved by
// the thread of that place, see pool_row) to the round's row table.
// !vec: the same stages are filled by plain loads, value by value.
template <int KVB>
__device__ void request_round(const aq::KVView& kv, int round, int end, int D,
                            bool vec, Plan pl, char* stages, int* table,
                            int prow) {
  const int CS = code_stride<KVB>(D), SS = scale_stride<KVB>(D);
  const int SB = stage_bytes<KVB>(D), cb = code_bytes<KVB>(D);
  const int p0 = round * pl.per * T;
  const int n = max(0, min(pl.per * T, end - p0));
  char* base = stages + (round % pl.inflight) * pl.per * SB;
  int* rows = table + (round % pl.inflight) * pl.per * T;
  if (kv.pt != nullptr) {
    if ((int)threadIdx.x < n) rows[threadIdx.x] = prow;
    __syncthreads();
  }
  auto cache_row = [&](int p) -> long long {
    return kv.pt == nullptr ? p0 + p : rows[p];
  };
  // position p of the round: stage p / T, staged row p % T
  auto dst = [&](int p, int which) {
    return base + (p / T) * SB + which * T * CS + (p % T) * CS;
  };
  auto sdst = [&](int p, int which) {
    return base + (p / T) * SB + 2 * T * CS + which * T * SS + (p % T) * SS;
  };
  if (vec) {
    const int cpp = cb / 16;
    for (int i = threadIdx.x; i < n * cpp; i += THREADS) {
      const int p = i / cpp, c = i - p * cpp;
      const long long off = cache_row(p) * kv.row_bytes + 16 * c;
      cp_async16(dst(p, 0) + 16 * c, kv.k + off);
      cp_async16(dst(p, 1) + 16 * c, kv.v + off);
    }
    if (KVB != 16) {
      const int spp = scale_bytes<KVB>(D) / 4;
      for (int i = threadIdx.x; i < n * spp; i += THREADS) {
        const int p = i / spp, c = i - p * spp;
        const long long off = cache_row(p) * kv.srow_bytes + 4 * c;
        cp_async4(sdst(p, 0) + 4 * c, kv.ks + off);
        cp_async4(sdst(p, 1) + 4 * c, kv.vs + off);
      }
    }
  } else {
    // kv16: 4-byte floats; kv8 / kv4: bytes; scales: kv8 4-byte words,
    // kv4 2-byte bf16s
    const int unit = KVB == 16 ? 4 : 1, upp = cb / unit;
    for (int i = threadIdx.x; i < n * upp; i += THREADS) {
      const int p = i / upp, e = i - p * upp;
      const long long off = cache_row(p) * kv.row_bytes + unit * e;
      if (KVB == 16) {
        *reinterpret_cast<float*>(dst(p, 0) + 4 * e) = *reinterpret_cast<const float*>(kv.k + off);
        *reinterpret_cast<float*>(dst(p, 1) + 4 * e) = *reinterpret_cast<const float*>(kv.v + off);
      } else {
        dst(p, 0)[e] = kv.k[off];
        dst(p, 1)[e] = kv.v[off];
      }
    }
    if (KVB != 16) {
      const int sunit = KVB == 8 ? 4 : 2, spp = scale_bytes<KVB>(D) / sunit;
      for (int i = threadIdx.x; i < n * spp; i += THREADS) {
        const int p = i / spp, e = i - p * spp;
        const long long off = cache_row(p) * kv.srow_bytes + sunit * e;
        if (KVB == 8) {
          *reinterpret_cast<unsigned*>(sdst(p, 0)) = *reinterpret_cast<const unsigned*>(kv.ks + off);
          *reinterpret_cast<unsigned*>(sdst(p, 1)) = *reinterpret_cast<const unsigned*>(kv.vs + off);
        } else {
          *reinterpret_cast<uint16_t*>(sdst(p, 0) + 2 * e) = *reinterpret_cast<const uint16_t*>(kv.ks + off);
          *reinterpret_cast<uint16_t*>(sdst(p, 1) + 2 * e) = *reinterpret_cast<const uint16_t*>(kv.vs + off);
        }
      }
    }
  }
  cp_async_commit();
}

// The NR live rows' dots with the staged K row `krow` (scales at `ksr`):
// fmaf chains over d = 0 .. D-1 from +0, 16 stored bytes dequantized at a
// time in registers, the tail (D not a whole number of 16-byte chunks)
// value by value.
template <int KVB, int RT>
__device__ __forceinline__ void dots(const float* qs, int QS, const char* krow,
                                     const char* ksr, int D, int nrows,
                                     float (&dot)[RT]) {
  constexpr int VALS = KVB == 16 ? 4 : (KVB == 8 ? 16 : 32);  // per 16 bytes
#pragma unroll
  for (int j = 0; j < RT; ++j) dot[j] = 0.f;
  const float ksc = KVB == 8 ? *reinterpret_cast<const float*>(ksr) : 0.f;
  const int nc = D / VALS;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const int4 raw = *reinterpret_cast<const int4*>(krow + 16 * c);
    const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z,
                           (uint32_t)raw.w};
    float kf[VALS];
    if (KVB == 16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) kf[i] = __uint_as_float(w[i]);
    } else if (KVB == 8) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        kf[i] = __fmul_rn((float)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xff), ksc);
    } else {
      const float sc = aq::bf16_float(
          *reinterpret_cast<const uint16_t*>(ksr + 2 * c));  // block c
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int x = (int)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xff);
        kf[2 * i] = __fmul_rn((float)aq::kv4_lo(x), sc);
        kf[2 * i + 1] = __fmul_rn((float)aq::kv4_hi(x), sc);
      }
    }
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      if (j >= nrows) break;
      const float* qr = qs + j * QS + c * VALS;
#pragma unroll
      for (int e = 0; e < VALS; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + e);
        dot[j] = fmaf(qv.x, kf[e], dot[j]);
        dot[j] = fmaf(qv.y, kf[e + 1], dot[j]);
        dot[j] = fmaf(qv.z, kf[e + 2], dot[j]);
        dot[j] = fmaf(qv.w, kf[e + 3], dot[j]);
      }
    }
  }
  for (int d = nc * VALS; d < D; ++d) {
    const float kd = aq::kv_value<KVB>(krow, ksr, 0, 0, 0, d);
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (j < nrows) dot[j] = fmaf(qs[j * QS + d], kd, dot[j]);
  }
}

// The block body: rows [0, nrows) of q (RT at most) attend positions
// [0, end) of the pair's cache `kv`.
template <int KVB, int RT>
__device__ void decode_rows(const float* __restrict__ q, const aq::KVView& kv,
                            int end, int nrows, float scale, int D, bool vec,
                            float* __restrict__ out, char* sm) {
  const Plan pl = plan<KVB>(D);
  const int CS = code_stride<KVB>(D), SS = scale_stride<KVB>(D);
  const int SB = stage_bytes<KVB>(D), QS = q_stride(D);
  char* stages = sm;
  float* qs = reinterpret_cast<float*>(sm + pl.per * pl.inflight * SB);
  float* ss = qs + RT * QS;        // NW x RT x T: scores, then p
  float* ms = ss + NW * RT * T;    // RT
  float* ls = ms + RT;             // RT
  float* mxs = ls + RT;            // NW x RT: tile maxima
  float* cs = mxs + NW * RT;       // NW x RT: corrections
  float* sums = cs + NW * RT;      // NW x RT: sums of p
  int* table = reinterpret_cast<int*>(sums + NW * RT);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int RP = pl.per * T;       // positions of a round
  const int rounds = (end + RP - 1) / RP;

  {  // the first rounds, their pool rows loaded together
    const int rows0 = pool_row(kv, tid, end), rows1 = pool_row(kv, RP + tid, end);
    if (rounds > 0) request_round<KVB>(kv, 0, end, D, vec, pl, stages, table, rows0);
    if (rounds > 1 && pl.inflight > 1)
      request_round<KVB>(kv, 1, end, D, vec, pl, stages, table, rows1);
  }
  for (int i = tid; i < RT * QS; i += THREADS) {
    const int j = i / QS, d = i - j * QS;
    qs[i] = j < nrows && d < D ? q[(long long)j * D + d] : 0.f;
  }
  if (tid < RT) { ms[tid] = aq::FLASH_MASK; ls[tid] = 0.f; }

  float acc[2][RT];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[c][j] = 0.f;

  for (int r = 0; r < rounds; ++r) {
    // the pool rows of the round this one's stages take next, loaded now
    const int next_row = pool_row(kv, (r + pl.inflight) * RP + tid, end);
    // round r's group has landed once at most the later rounds' are pending
    cp_async_wait(min(pl.inflight, rounds - r) - 1);
    __syncthreads();
    const char* base = stages + (r % pl.inflight) * pl.per * SB;
    const int t0r = r * RP;
    const bool scoring = warp < pl.per && t0r + warp * T < end;
    const bool valid = t0r + warp * T + lane < end;

    // Scores of tile `warp` and their tile maxima: the part of the
    // softmax step that does not depend on the running state.
    float s[RT];
    if (scoring) {
      const char* st = base + warp * SB;
      float dot[RT];
      dots<KVB, RT>(qs, QS, st + lane * CS, st + 2 * T * CS + lane * SS, D,
                    nrows, dot);
      float mx[RT];
#pragma unroll
      for (int j = 0; j < RT; ++j)
        s[j] = valid ? __fmul_rn(dot[j], scale) : aq::FLASH_MASK;
      aq::flash_tile_max<RT>(s, mx);
      if (lane == 0)
#pragma unroll
        for (int j = 0; j < RT; ++j) mxs[warp * RT + j] = mx[j];
    }
    __syncthreads();

    // The rest of the step for every tile at once.  A tile's entering max
    // is the running max folded with the earlier tiles' maxima in order,
    // the fmaxf chain of the tile-by-tile step, so each tile's p, sum and
    // correction are the floats aq::flash_softmax gives it in turn.
    if (scoring) {
      float m_new[RT], sum[RT];
      bool valids[RT];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        float m_old = ms[j];
        for (int u = 0; u < warp; ++u) m_old = fmaxf(m_old, mxs[u * RT + j]);
        m_new[j] = fmaxf(m_old, mxs[warp * RT + j]);
        valids[j] = valid;
        if (lane == 0) cs[warp * RT + j] = aq::flash_corr(m_old, m_new[j]);
      }
      aq::flash_tile_p<RT>(s, valids, m_new, sum);
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        ss[(warp * RT + j) * T + lane] = s[j];
        if (lane == 0) sums[warp * RT + j] = sum[j];
      }
    }
    __syncthreads();
    if (tid < nrows) {  // the running max and sum, tile by tile
      float m = ms[tid], l = ls[tid];
      for (int w = 0; w < pl.per && t0r + w * T < end; ++w) {
        l = aq::flash_fold(l, cs[w * RT + tid], sums[w * RT + tid]);
        m = fmaxf(m, mxs[w * RT + tid]);
      }
      ms[tid] = m;
      ls[tid] = l;
    }

#pragma unroll
    for (int c = 0; c < 2; ++c) {  // p @ v
      const int d = tid + c * THREADS;
      if (d >= D) continue;
      for (int w = 0; w < pl.per && t0r + w * T < end; ++w) {
        const int n = min(T, end - (t0r + w * T));
        const char* vrow = base + w * SB + T * CS;
        const char* vsr = base + w * SB + 2 * T * CS + T * SS;
        const float* pw = ss + w * RT * T;
#pragma unroll
        for (int j = 0; j < RT; ++j)
          if (j < nrows) acc[c][j] = __fmul_rn(acc[c][j], cs[w * RT + j]);
        int p = 0;
        for (; p + 8 <= n; p += 8) {  // 8 positions: p, kv8 scales as float4s
          float v[8];
          if (KVB == 8) {
            const float4 s0 = *reinterpret_cast<const float4*>(vsr + p * 4);
            const float4 s1 = *reinterpret_cast<const float4*>(vsr + p * 4 + 16);
            const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
            const int8_t* col = reinterpret_cast<const int8_t*>(vrow + p * CS) + d;
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __fmul_rn((float)col[e * CS], sc[e]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = aq::kv_value<KVB>(vrow, vsr, p + e, CS, SS, d);
          }
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            if (j >= nrows) break;
            const float4 p0 = *reinterpret_cast<const float4*>(pw + j * T + p);
            const float4 p1 = *reinterpret_cast<const float4*>(pw + j * T + p + 4);
            const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[c][j] = fmaf(pr[e], v[e], acc[c][j]);
          }
        }
        for (; p < n; ++p) {
          const float v = aq::kv_value<KVB>(vrow, vsr, p, CS, SS, d);
#pragma unroll
          for (int j = 0; j < RT; ++j)
            if (j < nrows) acc[c][j] = fmaf(pw[j * T + p], v, acc[c][j]);
        }
      }
    }
    __syncthreads();  // the round's stages are free
    if (r + pl.inflight < rounds)
      request_round<KVB>(kv, r + pl.inflight, end, D, vec, pl, stages, table,
                         next_row);
  }

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = tid + c * THREADS;
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (j < nrows) out[(long long)j * D + d] = aq::flash_out(acc[c][j], ls[j], end);
  }
}

template <int KVB, int RT>
__device__ void decode_block(const float* __restrict__ q, const aq::KVView& kv,
                             int cur_len, int cap, float* __restrict__ out,
                             int Hkv, int G, int D, float scale, bool vec) {
  extern __shared__ float4 smem4[];
  const int r0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(RT, G - r0);
  const long long row0 = ((long long)b * Hkv + h) * G + r0;
  decode_rows<KVB, RT>(q + row0 * D, kv, min(max(cur_len, 0), cap), nrows,
                       scale, D, vec, out + row0 * D,
                       reinterpret_cast<char*>(smem4));
}

template <int KVB, int RT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const float* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v, const void* __restrict__ k_scale,
                    const void* __restrict__ v_scale,
                    const int* __restrict__ cur_len, float* __restrict__ out,
                    int S, int Hkv, int G, int D, float scale, bool vec) {
  const int h = blockIdx.y, b = blockIdx.z;
  const aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h,
                                         (long long)b * S);
  decode_block<KVB, RT>(q, kv, cur_len[b], S, out, Hkv, G, D, scale, vec);
}

template <int KVB, int RT>
__global__ void __launch_bounds__(THREADS)
flash_decode_paged_kernel(const float* __restrict__ q, const void* __restrict__ k,
                          const void* __restrict__ v,
                          const void* __restrict__ k_scale,
                          const void* __restrict__ v_scale,
                          const int* __restrict__ page_table,
                          const int* __restrict__ cur_len, float* __restrict__ out,
                          int page, int max_pages, int Hkv, int G, int D,
                          float scale, bool vec) {
  const int h = blockIdx.y, b = blockIdx.z;
  aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h, 0);
  kv.pt = page_table + (long long)b * max_pages;
  kv.page = page;
  decode_block<KVB, RT>(q, kv, cur_len[b], page * max_pages, out, Hkv, G, D,
                        scale, vec);
}

// 16-byte tile copies: both caches 16-byte aligned, whole 16-byte chunks
// per head row, and (kv4) whole 4-byte words of scales per head row.
bool vec_ok(const void* k, const void* v, const void* ks, const void* vs,
            int D, int kv_bits) {
  auto aligned = [](const void* p, int a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  if (!aligned(k, 16) || !aligned(v, 16)) return false;
  if (kv_bits == 16) return D % 4 == 0;
  if (!aligned(ks, 4) || !aligned(vs, 4)) return false;
  return kv_bits == 8 ? D % 16 == 0 : D % 64 == 0;
}

// Launch with the dynamic shared memory the plan needs; the kernel's
// limit is raised to the device's opt-in maximum once per device.
template <int KVB, int RT, typename K, typename... Args>
int launch(K kernel, int B, int Hkv, int G, int D, cudaStream_t s,
           Args... args) {
  static std::atomic<unsigned> ready{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !((ready.load() >> dev) & 1u)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) ready.fetch_or(1u << dev);
  }
  dim3 grid((G + RT - 1) / RT, Hkv, B);
  kernel<<<grid, THREADS, smem_bytes<KVB, RT>(D), s>>>(args...);
  return (int)cudaGetLastError();
}

// The current device's SM count, read once per device.
int sm_count() {
  static std::atomic<int> known[32];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 32) return 132;
  int n = known[dev].load();
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    known[dev].store(n);
  return n > 0 ? n : 132;
}

// f(kv format, RT) for the format code and the rows per block: the most
// rows (4, 2, 1) that still give every SM a block; a row's arithmetic does
// not depend on RT.
template <typename F>
int with_rows(int kv_bits, int B, int Hkv, int G, F f) {
  const long long pairs = (long long)B * Hkv, sms = sm_count();
  return aq::with_kv_format(kv_bits, [&](auto fmt) {
    if (G > 2 && pairs * ((G + 3) / 4) >= sms)
      return f(fmt, std::integral_constant<int, 4>());
    if (G > 1 && pairs * ((G + 1) / 2) >= sms)
      return f(fmt, std::integral_constant<int, 2>());
    return f(fmt, std::integral_constant<int, 1>());
  });
}

}  // namespace

extern "C" int aq_flash_decode(const float* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const int* cur_len, float* out, int B, int S,
                               int Hkv, int G, int D, float scale, int kv_bits,
                               void* stream) {
  if (!aq::flash_shapes_ok(D, kv_bits)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0 || G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(k, v, k_scale, v_scale, D, kv_bits);
  return with_rows(kv_bits, B, Hkv, G, [&](auto fmt, auto rt) {
    constexpr int KVB = decltype(fmt)::value, RT = decltype(rt)::value;
    return launch<KVB, RT>(flash_decode_kernel<KVB, RT>, B, Hkv, G, D, s, q, k,
                           v, k_scale, v_scale, cur_len, out, S, Hkv, G, D,
                           scale, vec);
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
  if (B == 0 || Hkv == 0 || G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(k, v, k_scale, v_scale, D, kv_bits);
  return with_rows(kv_bits, B, Hkv, G, [&](auto fmt, auto rt) {
    constexpr int KVB = decltype(fmt)::value, RT = decltype(rt)::value;
    return launch<KVB, RT>(flash_decode_paged_kernel<KVB, RT>, B, Hkv, G, D, s,
                           q, k, v, k_scale, v_scale, page_table, cur_len, out,
                           page, max_pages, Hkv, G, D, scale, vec);
  });
}
