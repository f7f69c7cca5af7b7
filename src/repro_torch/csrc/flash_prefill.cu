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
// What bounds it on an H100: the 4*D float32 operations per (row, valid
// position), about B*Hq*C*(offset + C/2)*4*D in all, against the 67
// TFLOP/s of the CUDA cores.  Tensor cores are out: TF32 rounds the
// operands, and the arithmetic below is pinned.
//
// The pinned arithmetic.  Every output row comes out of the same float
// operations, in the same order, as the decode body (flash_common.cuh,
// flash_decode.cu) computes for that row: tiles of FLASH_T = 32 positions from
// position 0; the score is the fmaf chain over d = 0 .. D-1 from +0, then
// times the scale; the tile's max and sum of p are the warp butterfly of
// aq::flash_softmax; acc is scaled by the tile's correction, then the fmaf
// chain over the row's valid positions in order (a masked position never
// enters it, so a NaN in a stale slot cannot leak); finally aq::flash_out.
// That makes a one-token chunk equal decode, a chunk split in two equal the
// whole, and the paged kernel equal the linear one, bit for bit, while the
// work is laid out for prefill:
//  * one block of 256 threads per (batch, kv-head, 64 rows), two blocks per
//    SM (128 registers a thread), the row blocks of a pair launched
//    heaviest (latest rows) first;
//  * Q stays in shared memory; each K/V tile is read once per block, as
//    stored, by 16-byte cp.async copies into a staging area, issued while
//    the block works on the tile before (double buffering: staging, then
//    the float tile), and dequantized once into shared memory (the kv8
//    scale once per position, the kv4 scale once per 32 values); a 16-byte
//    copy needs D % 4 (kv16) or D % 16 (kv8) and aligned caches, else the
//    tile is read value by value after a barrier;
//  * scores: each thread owns 4 rows x 2 positions, 8 independent fmaf
//    chains fed by float4 shared loads, skipped where all 4 rows end before
//    the tile (the head dim is zero-padded to a multiple of 4:
//    fmaf(0, 0, dot) returns dot exactly, and dot is never -0); they are
//    stored position-major, so 4 rows of a position are one float4;
//  * softmax: a warp owns 8 rows, lane = position, as in decode, with the
//    8 rows' butterflies interleaved;
//  * p @ v: each thread owns 4 rows x 4*NC columns, one float4 of p and NC
//    float4s of V per position, each row's chain cut at its own valid
//    length.
// The paged kernel is the linear one with each position's pool row looked
// up in the page table (-1 reads page 0), once per position per tile.
#include "flash_common.cuh"

namespace {

constexpr int RT = 64;                 // rows per block
constexpr int TPR = 16;                // threads per group of 4 rows
constexpr int THREADS = RT / 4 * TPR;
constexpr int MIN_BLOCKS = 2;          // per SM: at most 128 registers a thread
constexpr int PPT = aq::FLASH_T / TPR;  // score positions per thread
constexpr int SREG = 2 * 32 * 8 / THREADS;  // kv4 scales per thread at D 256
constexpr int T = aq::FLASH_T;
constexpr int PS = RT + 4;             // score / p buffer: T x PS, position-major

__host__ __device__ inline int padded(int D) { return (D + 3) & ~3; }

// Cache bytes of one position of one head: codes or floats, and scales.
template <int KVB>
__host__ __device__ inline int code_bytes(int D) {
  return KVB == 16 ? 4 * D : (KVB == 8 ? D : D / 2);
}
template <int KVB>
__host__ __device__ inline int scale_units(int D) {  // 32-bit / bf16 scales
  return KVB == 16 ? 0 : (KVB == 8 ? 1 : D / aq::KV4_BLOCK);
}

// Shared memory, in floats: Q (RT x KS), K (T x KS), V (T x Dp), scores /
// p (T x PS, position-major, so 4 rows of a position are one float4), running max, sum and correction (RT each), the rows' ends
// and the tile's cache rows (ints, RT + T), then the staging area of the
// next tile as stored (K and V codes, T x code_bytes each, and their
// scales as 32-bit words).  KS = Dp + 4 keeps the float4 K reads of 8
// neighbouring positions on distinct banks.
template <int KVB>
__host__ __device__ inline int smem_floats(int D) {
  const int Dp = padded(D), KS = Dp + 4;
  return RT * KS + T * KS + T * Dp + T * PS + 3 * RT + RT + T +
         2 * T * code_bytes<KVB>(D) / 4 + 2 * T * scale_units<KVB>(D);
}

// The rows' ends in the shared memory of smem_floats: RT ints after the
// Q, K, V, p and row-state floats.
__device__ __forceinline__ int* smem_ends(float* sm, int D) {
  const int Dp = padded(D), KS = Dp + 4;
  return reinterpret_cast<int*>(sm + RT * KS + T * KS + T * Dp + T * PS + 3 * RT);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dequantize 16 bytes of a position's stored row (chunk c) into dst: kv16
// 4 floats, kv8 16 codes x the position's scale sc, kv4 32 nibbles x the
// chunk's block scale sc (a chunk is one 32-value block).
template <int KVB>
__device__ __forceinline__ void dequant_chunk(const int4 raw, float sc,
                                              float* dst) {
  if (KVB == 16) {
    *reinterpret_cast<int4*>(dst) = raw;
    return;
  }
  const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z,
                         (uint32_t)raw.w};
  if (KVB == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 f;
      f.x = __fmul_rn((float)(int8_t)(w[i] & 0xff), sc);
      f.y = __fmul_rn((float)(int8_t)((w[i] >> 8) & 0xff), sc);
      f.z = __fmul_rn((float)(int8_t)((w[i] >> 16) & 0xff), sc);
      f.w = __fmul_rn((float)(int8_t)(w[i] >> 24), sc);
      reinterpret_cast<float4*>(dst)[i] = f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b0 = (int)(int8_t)((w[i] >> (16 * h)) & 0xff);
      const int b1 = (int)(int8_t)((w[i] >> (16 * h + 8)) & 0xff);
      float4 f;
      f.x = __fmul_rn((float)aq::kv4_lo(b0), sc);
      f.y = __fmul_rn((float)aq::kv4_hi(b0), sc);
      f.z = __fmul_rn((float)aq::kv4_lo(b1), sc);
      f.w = __fmul_rn((float)aq::kv4_hi(b1), sc);
      reinterpret_cast<float4*>(dst)[2 * i + h] = f;
    }
  }
}

// The staging area of the next tile.  issue(): its stored bytes go to
// shared memory by cp.async (16 bytes each) and its scales (at most two
// per thread) to registers; stash() writes those scales to shared memory
// once the current tile's work is done; land(), after cp.async.wait_all
// and a barrier, dequantizes the staged tile into ks / vs.
template <int KVB>
struct Stage {
  char* codes;        // K then V, T x code_bytes each
  uint32_t* scales;   // K then V, T x scale_units each
  uint32_t sreg[SREG];

  __device__ __forceinline__ void issue(const aq::KVView& kv, const int* rows,
                                        int tn, int D) {
    const int cb = code_bytes<KVB>(D), cpp = cb / 16, per = tn * cpp;
    for (int i = threadIdx.x; i < 2 * per; i += THREADS) {
      const int which = i / per, rem = i % per, p = rem / cpp, c = rem % cpp;
      const char* src = (which ? kv.v : kv.k) + rows[p] * kv.row_bytes + 16 * c;
      cp_async16(codes + (which * T + p) * cb + 16 * c, src);
    }
    cp_async_commit();
    if (KVB == 16) return;
    const int spp = scale_units<KVB>(D), sper = tn * spp;
#pragma unroll
    for (int u = 0; u < SREG; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < 2 * sper) {
        const int which = i / sper, rem = i % sper, p = rem / spp, c = rem % spp;
        const char* srow = (which ? kv.vs : kv.ks) + rows[p] * kv.srow_bytes;
        sreg[u] = KVB == 8 ? __ldg(reinterpret_cast<const unsigned*>(srow))
                           : __ldg(reinterpret_cast<const unsigned short*>(srow) + c);
      }
    }
  }

  __device__ __forceinline__ void stash(int tn, int D) {
    if (KVB == 16) return;
    const int sper = tn * scale_units<KVB>(D);
#pragma unroll
    for (int u = 0; u < SREG; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < 2 * sper) {
        const int which = i / sper, rem = i % sper;
        scales[which * T * scale_units<KVB>(D) + rem] = sreg[u];
      }
    }
  }

  __device__ __forceinline__ void land(int tn, int D, int KS, int VS,
                                       float* ks, float* vs) const {
    constexpr int VALS = KVB == 16 ? 4 : (KVB == 8 ? 16 : 32);  // per chunk
    const int cb = code_bytes<KVB>(D), cpp = cb / 16, per = tn * cpp;
    const int spp = scale_units<KVB>(D);
    for (int i = threadIdx.x; i < 2 * per; i += THREADS) {
      const int which = i / per, rem = i % per, p = rem / cpp, c = rem % cpp;
      const int4 raw =
          *reinterpret_cast<const int4*>(codes + (which * T + p) * cb + 16 * c);
      float sc = 0.f;
      if (KVB == 8) sc = __uint_as_float(scales[which * T + p]);
      if (KVB == 4) sc = aq::bf16_float(scales[(which * T + p) * spp + c]);
      float* dst = which ? vs + p * VS : ks + p * KS;
      dequant_chunk<KVB>(raw, sc, dst + c * VALS);
    }
  }
};

// The tile's cache row of each position (tid < tn): p itself, or its page's
// pool row (-1 reads page 0).
__device__ __forceinline__ void resolve_rows(const aq::KVView& kv, int t0,
                                             int tn, int* rows) {
  if ((int)threadIdx.x < tn) {
    const int pos = t0 + threadIdx.x;
    rows[threadIdx.x] = kv.pt == nullptr
                            ? pos
                            : max(kv.pt[pos / kv.page], 0) * kv.page + pos % kv.page;
  }
}

// The block body.  The rows' ends (smem_ends) are filled by the caller,
// which synchronises before calling.  NC: float4 column chunks per
// thread in p @ v, so padded(D) <= 64 * NC.  vec: the tile is staged by
// cp.async (see the header), else read value by value after a barrier.
template <int KVB, int NC>
__device__ void prefill_rows(const float* __restrict__ q, const aq::KVView& kv,
                             int D, float scale, int nrows, bool vec,
                             float* __restrict__ out, float* sm) {
  const int Dp = padded(D), KS = Dp + 4, VS = Dp;
  float* qs = sm;
  float* ks = qs + RT * KS;
  float* vs = ks + T * KS;
  float* ss = vs + T * VS;
  float* ms = ss + T * PS;
  float* ls = ms + RT;
  float* cs = ls + RT;
  const int* ends = smem_ends(sm, D);
  int* rows = smem_ends(sm, D) + RT;
  Stage<KVB> stage;
  stage.codes = reinterpret_cast<char*>(rows + T);
  stage.scales = reinterpret_cast<uint32_t*>(stage.codes + 2 * T * code_bytes<KVB>(D));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  int max_end = 0;
  for (int r = 0; r < RT; ++r) max_end = max(max_end, ends[r]);
  // Q, rows past nrows and columns past D zero: 16-byte cp.async copies
  // (waited for with the first tile's), else value by value
  if (max_end > 0 && D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    for (int i = tid; i < RT * (D / 4); i += THREADS) {
      const int r = i / (D / 4), c = i % (D / 4);
      if (r < nrows)
        cp_async16(qs + r * KS + 4 * c, q + (long long)r * D + 4 * c);
      else
        *reinterpret_cast<float4*>(qs + r * KS + 4 * c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else if (max_end > 0) {
#pragma unroll 8
    for (int i = tid; i < RT * Dp; i += THREADS) {
      const int r = i / Dp, d = i % Dp;
      qs[r * KS + d] = (r < nrows && d < D) ? q[(long long)r * D + d] : 0.f;
    }
  }
  for (int i = tid; i < T * (Dp - D); i += THREADS)  // K's zero pad columns
    ks[(i / (Dp - D)) * KS + D + i % (Dp - D)] = 0.f;
  if (tid < RT) { ms[tid] = aq::FLASH_MASK; ls[tid] = 0.f; }

  // scores: rows 4*rg .. 4*rg+3, positions pg + TPR*j, j < PPT;
  // p @ v: rows 4*rg .. 4*rg+3, columns 4*(cg + TPR*j) .. +3, j < NC
  const int rg = tid / TPR, pg = tid % TPR, cg = tid % TPR;
  int my_end[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) my_end[i] = ends[4 * rg + i];
  const int thread_end = max(max(my_end[0], my_end[1]), max(my_end[2], my_end[3]));

  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (vec && max_end > 0) {                  // stage tile 0
    resolve_rows(kv, 0, min(T, max_end), rows);
    __syncthreads();
    stage.issue(kv, rows, min(T, max_end), D);
    stage.stash(min(T, max_end), D);
  }
  for (int t0 = 0; t0 < max_end; t0 += T) {
    const int tn = min(T, max_end - t0);
    const int t1 = t0 + T, tn1 = min(T, max_end - t1);   // the next tile
    cp_async_wait_all();
    if (vec) {
      __syncthreads();
      stage.land(tn, D, KS, VS, ks, vs);
      if (tn1 > 0) resolve_rows(kv, t1, tn1, rows);
      __syncthreads();
      if (tn1 > 0) stage.issue(kv, rows, tn1, D);
    } else {
      resolve_rows(kv, t0, tn, rows);
      __syncthreads();
      for (int i = tid; i < tn * D; i += THREADS) {
        const int p = i / D, d = i % D;
        const long long row = rows[p];
        ks[p * KS + d] = aq::kv_value<KVB>(kv.k, kv.ks, row, kv.row_bytes,
                                           kv.srow_bytes, d);
        vs[p * VS + d] = aq::kv_value<KVB>(kv.v, kv.vs, row, kv.row_bytes,
                                           kv.srow_bytes, d);
      }
      __syncthreads();
    }

    if (t0 < thread_end) {  // 4 x PPT score chains, d in order
      float sacc[4][PPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PPT; ++j) sacc[i][j] = 0.f;
      const float* qp = qs + 4 * rg * KS;
#pragma unroll 4
      for (int d = 0; d < Dp; d += 4) {
        float4 kv4[PPT];
#pragma unroll
        for (int j = 0; j < PPT; ++j)
          kv4[j] = *reinterpret_cast<const float4*>(ks + (pg + TPR * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qp + i * KS + d);
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            sacc[i][j] = fmaf(qv.x, kv4[j].x, sacc[i][j]);
            sacc[i][j] = fmaf(qv.y, kv4[j].y, sacc[i][j]);
            sacc[i][j] = fmaf(qv.z, kv4[j].z, sacc[i][j]);
            sacc[i][j] = fmaf(qv.w, kv4[j].w, sacc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        *reinterpret_cast<float4*>(ss + (pg + TPR * j) * PS + 4 * rg) = make_float4(
            __fmul_rn(sacc[0][j], scale), __fmul_rn(sacc[1][j], scale),
            __fmul_rn(sacc[2][j], scale), __fmul_rn(sacc[3][j], scale));
    }
    __syncthreads();

    {  // softmax: warp w owns rows w, w + 8, ..., lane = position
      constexpr int NR = RT / (THREADS / 32);
      float sv[NR];
      bool valid[NR], active[NR];
      int row[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        row[j] = warp + j * (THREADS / 32);
        active[j] = t0 < ends[row[j]];
        valid[j] = lane < tn && t0 + lane < ends[row[j]];
        sv[j] = valid[j] ? ss[lane * PS + row[j]] : aq::FLASH_MASK;
      }
      aq::flash_softmax<NR>(sv, valid, active, row, ms, ls, cs, lane);
#pragma unroll
      for (int j = 0; j < NR; ++j) ss[lane * PS + row[j]] = sv[j];
    }
    __syncthreads();

    int n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      n[i] = min(tn, my_end[i] - t0);
      const float c = cs[4 * rg + i];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fmul_rn(acc[i][j][e], c);
    }
    const int pn = min(tn, thread_end - t0);
#pragma unroll 2
    for (int p = 0; p < pn; ++p) {
      float4 vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = 4 * (cg + TPR * j);
        vv[j] = col < Dp ? *reinterpret_cast<const float4*>(vs + p * VS + col)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 p4 = *reinterpret_cast<const float4*>(ss + p * PS + 4 * rg);
      const float prs[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p >= n[i]) continue;
        const float pr = prs[i];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          acc[i][j][0] = fmaf(pr, vv[j].x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pr, vv[j].y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pr, vv[j].z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pr, vv[j].w, acc[i][j][3]);
        }
      }
    }
    if (vec && tn1 > 0) stage.stash(tn1, D);
  }
  __syncthreads();
  const bool out_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d0 = 4 * (cg + TPR * j);
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = aq::flash_out(acc[i][j][e], ls[r], my_end[i]);
      float* dst = out + (long long)r * D + d0;
      if (out_vec && d0 < D) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d0 + e < D) dst[e] = o[e];
      }
    }
  }
}

// Row block of a (batch, kv-head) pair: blockIdx.z counts down from the
// last (heaviest) block, so the heavy blocks start first.
template <int KVB, int NC>
__device__ void prefill_block(const float* __restrict__ q, const aq::KVView& kv,
                              int offset, int chunk_len, int cap, bool vec,
                              float* __restrict__ out, int Hkv, int C, int G,
                              int D, float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * RT;
  const int R = C * G;
  const int nrows = min(RT, R - r0);
  int* ends = smem_ends(sm, D);
  if (threadIdx.x < RT) {
    const int c = (r0 + threadIdx.x) / G;
    ends[threadIdx.x] =
        (threadIdx.x < nrows && c < chunk_len) ? min(offset + c + 1, cap) : 0;
  }
  __syncthreads();
  const long long row0 = ((long long)b * Hkv + h) * R + r0;
  prefill_rows<KVB, NC>(q + row0 * D, kv, D, scale, nrows, vec,
                        out + row0 * D, sm);
}

template <int KVB, int NC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_prefill_kernel(const float* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, const void* __restrict__ k_scale,
                     const void* __restrict__ v_scale,
                     const int* __restrict__ offset,
                     const int* __restrict__ chunk_len, float* __restrict__ out,
                     int S, int Hkv, int C, int G, int D, float scale, bool vec) {
  const int h = blockIdx.x, b = blockIdx.y;
  const aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h,
                                         (long long)b * S);
  prefill_block<KVB, NC>(q, kv, offset[b], chunk_len[b], S, vec, out, Hkv, C,
                         G, D, scale);
}

template <int KVB, int NC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_prefill_paged_kernel(const float* __restrict__ q,
                           const void* __restrict__ k, const void* __restrict__ v,
                           const void* __restrict__ k_scale,
                           const void* __restrict__ v_scale,
                           const int* __restrict__ page_table,
                           const int* __restrict__ offset,
                           const int* __restrict__ chunk_len,
                           float* __restrict__ out, int page, int max_pages,
                           int Hkv, int C, int G, int D, float scale, bool vec) {
  const int h = blockIdx.x, b = blockIdx.y;
  aq::KVView kv = aq::kv_view<KVB>(k, v, k_scale, v_scale, Hkv, D, h, 0);
  kv.pt = page_table + (long long)b * max_pages;
  kv.page = page;
  prefill_block<KVB, NC>(q, kv, offset[b], chunk_len[b], page * max_pages, vec,
                         out, Hkv, C, G, D, scale);
}

// 16-byte tile loads: both caches aligned and a whole number of 16-byte
// chunks per head row (KVB 4 needs D % 32, which flash_shapes_ok checks).
bool vec_ok(const void* k, const void* v, int D, int kv_bits) {
  const bool aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return aligned && (kv_bits == 4 || (kv_bits == 8 ? D % 16 : D % 4) == 0);
}

template <int KVB, typename K, typename... Args>
int launch(K kernel, int B, int Hkv, int C, int G, int D, cudaStream_t s,
           Args... args) {
  const int smem = (int)sizeof(float) * smem_floats<KVB>(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B, (C * G + RT - 1) / RT);
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// f(kv format, NC) for the format code and head dim.
template <typename F>
int with_format(int kv_bits, int D, F f) {
  return aq::with_kv_format(kv_bits, [&](auto fmt) {
    const int Dp = padded(D);
    if (Dp <= 4 * TPR) return f(fmt, std::integral_constant<int, 1>());
    if (Dp <= 8 * TPR) return f(fmt, std::integral_constant<int, 2>());
    return f(fmt, std::integral_constant<int, 4>());
  });
}

}  // namespace

extern "C" int aq_flash_prefill(const float* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const int* offset, const int* chunk_len,
                                float* out, int B, int S, int Hkv, int C, int G,
                                int D, float scale, int kv_bits, void* stream) {
  if (!aq::flash_shapes_ok(D, kv_bits)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0 || C * G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(k, v, D, kv_bits);
  return with_format(kv_bits, D, [&](auto fmt, auto nc) {
    constexpr int KVB = decltype(fmt)::value, NC = decltype(nc)::value;
    return launch<KVB>(flash_prefill_kernel<KVB, NC>, B, Hkv, C, G, D, s, q, k, v,
                  k_scale, v_scale, offset, chunk_len, out, S, Hkv, C, G, D,
                  scale, vec);
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
  if (B == 0 || Hkv == 0 || C * G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(k, v, D, kv_bits);
  return with_format(kv_bits, D, [&](auto fmt, auto nc) {
    constexpr int KVB = decltype(fmt)::value, NC = decltype(nc)::value;
    return launch<KVB>(flash_prefill_paged_kernel<KVB, NC>, B, Hkv, C, G, D, s, q,
                  k, v, k_scale, v_scale, page_table, offset, chunk_len, out,
                  page, max_pages, Hkv, C, G, D, scale, vec);
  });
}
