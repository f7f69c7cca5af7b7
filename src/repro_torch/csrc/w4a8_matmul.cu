// y = a_scale * sum_g scale_g * (x_q . (c - off) + rowsum_g(x_q) * (off - zp_g))
// The weight-activation packed matmul of the W4A4 / W4A8 serving path.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::w4a8_matmul
// (Pallas body _w4a8_kernel) and holds to the plain oracle
// repro/kernels/ref.py::quant_matmul_ref, which quantizes each activation
// row with ONE whole-row scale.  (The TPU kernel takes a scale per
// (token, 512-wide K slab) when it tiles K; that is an artifact of its
// tiling and is not reproduced.)  x (M, K) float32; packed (K/8*BITS, N)
// uint8; scale/zp (K/g, N) float32; a_bits 2..8; y (M, N) float32.
//
// The pinned arithmetic, the same in every body and equal to the plain
// version bit for bit: per group g the integer dot of the activation codes
// with the centred weight codes (exact in int32, in any order), then the
// float32 term scale_g * (float(dot_g) + float(rsum_g) * (off - zp_g)) with
// explicitly rounded intrinsics (nvcc cannot contract them into FMAs), the
// terms added in group order from +0, and the sum times a_scale.
//
// Packed layout: packed row r holds codes k = r * P + t at bits t * BITS,
// P = 8 / BITS codes a byte.  Four consecutive packed rows of a column,
// gathered into one word by a 4x4 byte transpose (aq::transpose4x4), give
// after (word >> t * BITS) & mask one code per byte, 4 K-codes P apart: a
// dp4a operand.  The activation codes are staged in the matching order.
//
// Launches:
//  1. act_quant (common.cuh, shared with w8a8_matmul): one block per row,
//     the row's scale a_scale = max(bound, 1e-8) / qmax (IEEE division,
//     a NaN row keeps NaN), its int8 codes (round half to even) and their
//     per-group row sums rsum (M, K/g) int32; at decode it also zeroes the
//     decode body's counters.
//  2. M <= 8, decode.  What bounds it is the packed weight stream, K*N*BITS/8
//     bytes plus 8*K*N/g of scale and zero point, at 3.35 TB/s.
//     w4a8_decode: a block owns 64 columns and two sets of whole groups in
//     turn; its 16 slots (8 warps x 2 lane halves) split a set's quads of
//     packed rows.  A lane issues 16-byte loads (16 columns of one packed
//     row; a warp reads whole sectors), all of a tile's loads before it
//     uses one and the next tile's before it computes this one.  The 4
//     lanes of a quad swap words through shared memory so each holds 4
//     rows x 4 columns, transpose them, split the codes with shift and
//     mask, and take them raw into dp4a.s32.u32 against the activation
//     codes staged once a tile in shared memory (dot(x, c - off) =
//     dot(x, c) - off * rsum, exact in int32).  The slots' int32 dots meet
//     in shared memory, and each group's float32 term goes to a workspace
//     terms (G, M, N).  A group too long for one tile is walked in chunks;
//     groups whose quads straddle a group boundary (2-bit codes, g % 16 ==
//     8) see zero activation codes outside their group.  The last block of
//     a column slab to finish (a counter per slab) adds each of the slab's
//     outputs' G terms in group order and scales it.
//  2'. M > 8, tile.  What bounds it is the 2*M*K*N int8 operations at
//     1,979 TOP/s.  w4a8_mma: 128x128 output tiles, 8 warps of 64x32,
//     mma.sync.m16n8k32 s8 x s8 -> s32 over 128-deep K slabs; the next
//     slab's global loads are issued before the current slab's MMAs
//     (register staging).  Weight codes are unpacked, centred to int8
//     (c - off) and transposed into column-major rows on their way into
//     shared memory; rows are padded to 144 bytes, which makes the fragment
//     loads conflict-free.  At every group end the int32 fragments are
//     flushed through the float32 term into float32 accumulators and reset.
//     A group that ends inside a 32-deep MMA step (g % 32 != 0) splits the
//     step: each piece runs with the activation fragments of the other
//     group zeroed (each fragment register holds 4 K-codes, and group ends
//     are multiples of 8).
// Ragged M, N and K are masked with zero codes, which add nothing.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;

// dot += 4 signed bytes of a x 4 unsigned bytes of b
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One byte per code: bits t*BITS.. of each byte of `w`.
template <int BITS>
__device__ __forceinline__ uint32_t codes_at(uint32_t w, int t) {
  constexpr uint32_t MASK = ((1u << BITS) - 1u) * 0x01010101u;
  return (w >> (t * BITS)) & MASK;
}

// 16 bytes of packed row `row`, columns col .. col+15, zero past the rows or
// N.  `vec`: N % 16 == 0 and packed 16-byte aligned.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ packed,
                                        int row, int col, int rows, int N,
                                        bool vec) {
  if (row >= rows || col >= N) return make_uint4(0u, 0u, 0u, 0u);
  const uint8_t* p = packed + (long long)row * N + col;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (col + b < N) w[b / 4] |= (uint32_t)__ldg(p + b) << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// decode body (M <= DEC_MMAX)
// ---------------------------------------------------------------------------

// DEC_COLS columns a block; DEC_SLOTS quad slots (8 warps x 2 lane halves);
// DEC_U quads a slot per tile, so DEC_QUADS = DEC_SLOTS * DEC_U quads of
// activation codes staged per tile; a block walks DEC_SETS group sets, the
// next tile's loads in flight while it computes one, at two blocks an SM
// (measured on the H100 against 1-4 sets, 2-8 quads a slot, 1-4 blocks an
// SM, 128-column blocks, no-L1-allocate loads and the small loads issued a
// tile ahead: none ran faster, and more quads or blocks spill registers).
constexpr int DEC_MMAX = 8, DEC_COLS = 64, DEC_SLOTS = 16, DEC_U = 4,
              DEC_QUADS = DEC_SLOTS * DEC_U, DEC_SETS = 2, DEC_MIN_BLOCKS = 2;

// Slots per group: the least power of two whose DEC_U quads each cover the
// group's quads, at most DEC_SLOTS (longer groups take several chunks).
__host__ __device__ __forceinline__ int dec_slots_per_group(int quads) {
  int spg = 1;
  while (spg < DEC_SLOTS && DEC_U * spg < quads) spg *= 2;
  return spg;
}

// The P activation words of one quad (4P codes from xr[k0]): word t, byte i
// = code k0 + i*P + t.  A 4-code word outside [lo, hi) (another group, or
// past K) is zero.
template <int BITS>
__device__ __forceinline__ void quad_words(const int8_t* __restrict__ xr,
                                           int k0, int lo, int hi,
                                           uint32_t (&out)[8 / BITS]) {
  constexpr int P = 8 / BITS;
  uint32_t w[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int k = k0 + 4 * p;
    w[p] = (k >= lo && k + 4 <= hi)
               ? __ldg(reinterpret_cast<const unsigned int*>(xr + k)) : 0u;
  }
  if constexpr (P == 1) {
    out[0] = w[0];
  } else if constexpr (P == 2) {
    out[0] = __byte_perm(w[0], w[1], 0x6420);
    out[1] = __byte_perm(w[0], w[1], 0x7531);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned sel = t | ((4 + t) << 4);
      out[t] = __byte_perm(__byte_perm(w[0], w[1], sel),
                           __byte_perm(w[2], w[3], sel), 0x5410);
    }
  }
}

// Where a tile sits: the group set, the chunk of its groups' quads, and
// this lane's group gi and first quad.
struct DecTile {
  int set, chunk, gi, q_first;
};

__device__ __forceinline__ DecTile dec_tile(int tile, int set0, int chunks,
                                            int gpb, int j, int R) {
  DecTile t;
  t.set = set0 + tile / chunks;
  t.chunk = tile % chunks;
  t.gi = t.set * gpb + j;
  t.q_first = t.gi * R / 4;
  return t;
}

// This lane's DEC_U 16-byte loads of a tile: quads lq0 + spg * u of group
// gi, packed row 4 * quad + s, columns col .. col + 15.
__device__ __forceinline__ void dec_load(uint4 (&v)[DEC_U],
                                         const uint8_t* __restrict__ packed,
                                         const DecTile& t, int G, int lq0,
                                         int spg, int quads, int s, int col,
                                         int rows, int N, bool vec) {
#pragma unroll
  for (int u = 0; u < DEC_U; ++u) {
    const int lq = lq0 + spg * u;
    v[u] = (t.gi < G && lq < quads)
               ? load16(packed, 4 * (t.q_first + lq) + s, col, rows, N, vec)
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Terms loaded at once by the fold, before it adds them in order.
constexpr int FOLD_BATCH = 16;

template <int BITS, int MR>
__global__ void __launch_bounds__(THREADS, DEC_MIN_BLOCKS)
w4a8_decode_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ a_scale,
                   const int* __restrict__ rsum,
                   const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale,
                   const float* __restrict__ zp, float* __restrict__ terms,
                   unsigned* __restrict__ done, float* __restrict__ y, int M,
                   int K, int N, int group, bool vec) {
  constexpr int P = 8 / BITS, OFF = 1 << (BITS - 1);
  // the staged activation codes [DEC_QUADS][MR][P] and, after the last
  // tile of a set, the slots' int32 dots [DEC_SLOTS][MR][DEC_COLS]
  constexpr int XS_WORDS = DEC_QUADS * MR * P, RED_WORDS = DEC_SLOTS * MR * DEC_COLS;
  __shared__ __align__(16) uint32_t sbuf[XS_WORDS > RED_WORDS ? XS_WORDS : RED_WORDS];
  __shared__ int rs_s[DEC_SLOTS][MR];               // the set's row sums
  __shared__ __align__(16) uint4 xch[WARPS][8][5];  // quad swaps, padded
  auto xs = reinterpret_cast<uint32_t(*)[MR][P]>(sbuf);
  auto red = reinterpret_cast<int(*)[MR][DEC_COLS]>(sbuf);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = lane / 4, s = lane % 4;             // lane quad, row in quad
  const int cb = c % 4, sl = 2 * warp + c / 4;      // 16-column block, slot
  const int G = K / group, R = group / 8 * BITS;    // packed rows a group
  const int quads = (R + 3) / 4, rows = K / 8 * BITS;
  const int spg = dec_slots_per_group(quads), gpb = DEC_SLOTS / spg;
  const int j = sl / spg, sp = sl % spg, qpc = DEC_U * spg;
  const int n0 = blockIdx.x * DEC_COLS, col = n0 + 16 * cb;
  const int sets = (G + gpb - 1) / gpb, set0 = blockIdx.y * DEC_SETS;
  const int chunks = (quads + qpc - 1) / qpc;
  const int tiles = min(DEC_SETS, sets - set0) * chunks;

  int acc[MR][4] = {};
  float esc[4], ezp[4];
  uint4 v[DEC_U], vn[DEC_U];
  DecTile t = dec_tile(0, set0, chunks, gpb, j, R);
  dec_load(v, packed, t, G, sp, spg, quads, s, col, rows, N, vec);
  for (int tile = 0; tile < tiles; ++tile) {
    const int g0 = t.set * gpb, lq_base = t.chunk * qpc;
    const bool more = tile + 1 < tiles;
    DecTile tn;
    if (more) {                                     // next tile's loads in flight
      tn = dec_tile(tile + 1, set0, chunks, gpb, j, R);
      dec_load(vn, packed, tn, G, tn.chunk * qpc + sp, spg, quads, s, col,
               rows, N, vec);
    }
    if (t.chunk == 0) {
      // the epilogue's (group, column) pairs, at most 4 a thread: their
      // scale and zero point load while the weights stream
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tid + THREADS * i, gg = g0 + p / DEC_COLS, n = n0 + p % DEC_COLS;
        const bool ok = p < gpb * DEC_COLS && gg < G && n < N;
        esc[i] = ok ? __ldg(scale + (long long)gg * N + n) : 0.f;
        ezp[i] = ok ? __ldg(zp + (long long)gg * N + n) : 0.f;
      }
    }
    __syncthreads();                                // last tile's reads done
    for (int i = tid; i < DEC_QUADS * MR; i += THREADS) {
      const int qs = i / MR, m = i % MR;
      const int gg = g0 + qs / qpc, lq = lq_base + qs % qpc;
      uint32_t w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) w[p] = 0u;
      if (m < M && gg < G && lq < quads)
        quad_words<BITS>(xq + (long long)m * K, 4 * (gg * R / 4 + lq) * P,
                         gg * group, (gg + 1) * group, w);
#pragma unroll
      for (int p = 0; p < P; ++p) xs[qs][m][p] = w[p];
    }
    if (t.chunk == 0 && tid < gpb * MR) {
      const int gg = g0 + tid / MR, m = tid % MR;
      rs_s[tid / MR][m] = m < M && gg < G ? __ldg(rsum + (long long)m * G + gg) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < DEC_U; ++u) {
      // lane s has row s of the quad, 16 columns; after the swap it has
      // rows 0..3 of columns 4s..4s+3 of the 16
      xch[warp][c][s] = v[u];
      __syncwarp();
      uint32_t r[4], cw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = reinterpret_cast<const uint32_t*>(&xch[warp][c][i])[s];
      __syncwarp();
      aq::transpose4x4(r, cw);                      // cw[jj]: column 4s + jj
      const uint32_t(*xw)[P] = xs[j * qpc + sp + spg * u];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const uint32_t code = codes_at<BITS>(cw[jj], p);
#pragma unroll
          for (int m = 0; m < MR; ++m) acc[m][jj] = dp4a_su(xw[m][p], code, acc[m][jj]);
        }
    }
    if (t.chunk == chunks - 1) {                    // the set's groups are done
      __syncthreads();                              // xs reads done: red reuses it
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        *reinterpret_cast<int4*>(&red[sl][m][16 * cb + 4 * s]) =
            make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[m][jj] = 0;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tid + THREADS * i, jg = p / DEC_COLS, cc = p % DEC_COLS;
        const int gg = g0 + jg, n = n0 + cc;
        if (p >= gpb * DEC_COLS || gg >= G || n >= N) continue;
        const float offz = __fsub_rn((float)OFF, ezp[i]);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (m >= M) break;
          int dot = 0;
          for (int q = 0; q < spg; ++q) dot += red[jg * spg + q][m][cc];
          const int rs = rs_s[jg][m];
          dot -= OFF * rs;                          // centre: exact in int32
          const float tm = __fadd_rn(__int2float_rn(dot),
                                     __fmul_rn(__int2float_rn(rs), offz));
          terms[((long long)gg * M + m) * N + n] = __fmul_rn(esc[i], tm);
        }
      }
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < DEC_U; ++u) v[u] = vn[u];
      t = tn;
    }
  }

  // The slab's last block to finish folds its terms:
  // y[m][n] = ((0 + terms[0][m][n]) + terms[1][m][n] + ...) * a_scale[m]
  __shared__ bool last;
  __threadfence();                                  // this block's terms out
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                                  // the others' terms in
  const long long mn = (long long)M * N;
  for (int i = tid; i < MR * DEC_COLS; i += THREADS) {
    const int m = i / DEC_COLS, n = n0 + i % DEC_COLS;
    if (m >= M || n >= N) continue;
    const float* tp = terms + (long long)m * N + n;
    float acc = 0.f;
    for (int g0 = 0; g0 < G; g0 += FOLD_BATCH) {
      float tv[FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        tv[u] = g0 + u < G ? __ldcg(tp + (g0 + u) * mn) : 0.f;
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        if (g0 + u < G) acc = __fadd_rn(acc, tv[u]);
    }
    y[(long long)m * N + n] = __fmul_rn(acc, a_scale[m]);
  }
}

// ---------------------------------------------------------------------------
// tile body (M > DEC_MMAX): int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int TBM = 128, TBN = 128, TBK = 128, TLDS = TBK + 16;

template <int BITS>
struct Stage {            // one K slab's global loads, held in registers
  int4 a[4];              // four 16-byte chunks of the x_q tile
  uint4 b[BITS / 2];      // BITS/2 packed rows x 16 columns: 4 codes each
};

// B task of this thread: 16 columns (block cb) x 4 K-codes (quad kq).  A
// warp covers 2 column blocks x 16 quads, so each packed row it reads is 32
// contiguous bytes: whole sectors.
__device__ __forceinline__ void b_task(int& cb, int& kq) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  cb = lane % 2 + 2 * (warp % 4);
  kq = lane / 2 + 16 * (warp / 4);
}

template <int BITS>
__device__ __forceinline__ void load_stage(Stage<BITS>& st,
                                           const int8_t* __restrict__ xq,
                                           const uint8_t* __restrict__ packed,
                                           int m0, int n0, int k0, int M,
                                           int K, int N, bool x_vec,
                                           bool w_vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + THREADS * i;
    const int gm = m0 + c / 8, k = k0 + 16 * (c % 8);
    if (gm < M && x_vec && k + 16 <= K) {
      st.a[i] = __ldg(reinterpret_cast<const int4*>(xq + (long long)gm * K + k));
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (gm < M)
        for (int j = 0; j < 16; ++j)
          if (k + j < K)
            v[j / 4] |= (uint32_t)(uint8_t)xq[(long long)gm * K + k + j]
                        << (8 * (j % 4));
      st.a[i] = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
    }
  }
  int cb, kq;
  b_task(cb, kq);
  const int row0 = (k0 + 4 * kq) / (8 / BITS), rows = K / 8 * BITS;
#pragma unroll
  for (int r = 0; r < BITS / 2; ++r)
    st.b[r] = load16(packed, row0 + r, n0 + 16 * cb, rows, N, w_vec);
}

template <int BITS>
__device__ __forceinline__ void store_stage(const Stage<BITS>& st, int8_t* As,
                                            int8_t* Bs) {
  constexpr int P = 8 / BITS, OFF = 1 << (BITS - 1);
  // (c + 0x80 - off) ^ 0x80 per byte: c - off as int8, no carry between bytes
  constexpr uint32_t CADD = (uint32_t)(0x80 - OFF) * 0x01010101u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + THREADS * i;
    *reinterpret_cast<int4*>(As + (c / 8) * TLDS + 16 * (c % 8)) = st.a[i];
  }
  int cb, kq;
  b_task(cb, kq);
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4) {
    uint32_t e[4], col[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {      // code jj of the quad: row jj / P
      const uint4 b = st.b[jj / P];
      const uint32_t w = c4 == 0 ? b.x : c4 == 1 ? b.y : c4 == 2 ? b.z : b.w;
      e[jj] = codes_at<BITS>(w, jj % P);
    }
    aq::transpose4x4(e, col);             // col[j]: column 4*c4 + j, 4 codes
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(Bs + (16 * cb + 4 * c4 + j) * TLDS + 4 * kq) =
          (col[j] + CADD) ^ 0x80808080u;
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Group gi's int32 fragments through the float32 term into `fac`, then
// reset.  Fragment i of an m16n8 tile: row g (+8 for i >= 2), column
// 2t + i % 2; row0 / col0 are this thread's g / 2t of the first tile.
__device__ __forceinline__ void flush_group(
    int (&acc)[4][4][4], float (&fac)[4][4][4], const int* __restrict__ rsum,
    const float* __restrict__ scale, const float* __restrict__ zp, float off,
    int gi, int G, int row0, int col0, int M, int N) {
  float rs[4][2], sc[4][2], oz[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + mt * 16 + 8 * h;
      rs[mt][h] = gm < M ? __int2float_rn(rsum[(long long)gm * G + gi]) : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = col0 + nt * 8 + e;
      const bool ok = gn < N;
      sc[nt][e] = ok ? __ldg(scale + (long long)gi * N + gn) : 0.f;
      oz[nt][e] = ok ? __fsub_rn(off, __ldg(zp + (long long)gi * N + gn)) : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float term = __fadd_rn(__int2float_rn(acc[mt][nt][i]),
                                     __fmul_rn(rs[mt][i / 2], oz[nt][i % 2]));
        fac[mt][nt][i] = __fadd_rn(fac[mt][nt][i], __fmul_rn(sc[nt][i % 2], term));
        acc[mt][nt][i] = 0;
      }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
w4a8_mma_kernel(const int8_t* __restrict__ xq,
                const float* __restrict__ a_scale,
                const int* __restrict__ rsum,
                const uint8_t* __restrict__ packed,
                const float* __restrict__ scale,
                const float* __restrict__ zp, float* __restrict__ y, int M,
                int K, int N, int group, bool x_vec, bool w_vec) {
  __shared__ __align__(16) int8_t As[TBM * TLDS];   // [m][k]
  __shared__ __align__(16) int8_t Bs[TBN * TLDS];   // [n][k], centred codes
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;           // 2 x 4 warps of 64 x 32
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int G = K / group;
  const float off = (float)(1 << (BITS - 1));
  const int row0 = m0 + wm * 64 + g, col0 = n0 + wn * 32 + 2 * t;
  int acc[4][4][4] = {};                            // [m16][n8][fragment]
  float fac[4][4][4] = {};
  int gi = 0, gend = group;                         // current group, its end

  Stage<BITS> st;
  load_stage<BITS>(st, xq, packed, m0, n0, 0, M, K, N, x_vec, w_vec);
  for (int k0 = 0; k0 < K; k0 += TBK) {
    store_stage<BITS>(st, As, Bs);
    __syncthreads();
    if (k0 + TBK < K)
      load_stage<BITS>(st, xq, packed, m0, n0, k0 + TBK, M, K, N, x_vec, w_vec);
    for (int kb = 0; kb < TBK && k0 + kb < K; kb += 32) {
      const int kbase = k0 + kb, kend = min(kbase + 32, K);
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* c0 = Bs + (wn * 32 + nt * 8 + g) * TLDS + kb + 4 * t;
        b[nt][0] = lds32(c0);
        b[nt][1] = lds32(c0 + 16);
      }
      // one piece per group the step meets: one when 32 divides g
      for (int lo = kbase; lo < kend;) {
        const int hi = min(kend, gend);
        const bool whole = lo == kbase && hi == kbase + 32;
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int8_t* r0 = As + (wm * 64 + mt * 16 + g) * TLDS + kb + 4 * t;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // register r: row g (+8 if r odd), K-codes 4t (+16 if r >= 2)
            const int kk = kbase + 4 * t + 16 * (r / 2);
            const uint32_t v = lds32(r0 + 8 * TLDS * (r % 2) + 16 * (r / 2));
            a[mt][r] = whole || (kk >= lo && kk < hi) ? v : 0u;
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};\n"
                : "+r"(acc[mt][nt][0]), "+r"(acc[mt][nt][1]),
                  "+r"(acc[mt][nt][2]), "+r"(acc[mt][nt][3])
                : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                  "r"(b[nt][0]), "r"(b[nt][1]));
        if (hi == gend) {
          flush_group(acc, fac, rsum, scale, zp, off, gi, G, row0, col0, M, N);
          ++gi;
          gend += group;
        }
        lo = hi;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + wm * 64 + mt * 16 + g + 8 * (i / 2);
      if (gm >= M) continue;
      const float sa = a_scale[gm];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + wn * 32 + nt * 8 + 2 * t + i % 2;
        if (gn < N) y[(long long)gm * N + gn] = __fmul_rn(fac[mt][nt][i], sa);
      }
    }
}

// w4a8_matmul's workspace, carved from one buffer: the activation codes
// (M, K) int8, a_scale (M,) float32, the per-group row sums (M, G) int32
// and, for the decode body, the per-group terms (G, M, N) float32 and one
// counter per column slab.  Each part starts 256-byte aligned; `bytes` is
// the size the buffer needs.
struct Workspace {
  int8_t* xq;
  float* a_scale;
  int* rsum;
  float* terms;
  unsigned* done;
  int ndone;
  long long bytes;
};

Workspace carve(uint8_t* base, int M, int K, int N, int group) {
  const long long G = K / group;
  const bool dec = M <= DEC_MMAX;
  const int ndone = dec ? (N + DEC_COLS - 1) / DEC_COLS : 0;
  const long long sizes[5] = {(long long)M * K, 4LL * M, 4LL * M * G,
                              dec ? 4LL * G * M * N : 0LL, 4LL * ndone};
  long long off[5], total = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = total;
    total += (sizes[i] + 255) / 256 * 256;
  }
  Workspace w{};
  w.ndone = ndone;
  w.bytes = total;
  if (base != nullptr) {
    w.xq = reinterpret_cast<int8_t*>(base + off[0]);
    w.a_scale = reinterpret_cast<float*>(base + off[1]);
    w.rsum = reinterpret_cast<int*>(base + off[2]);
    w.terms = reinterpret_cast<float*>(base + off[3]);
    w.done = reinterpret_cast<unsigned*>(base + off[4]);
  }
  return w;
}

template <int BITS>
cudaError_t launch_main(const Workspace& w, const uint8_t* packed,
                        const float* scale, const float* zp, float* y, int M,
                        int K, int N, int group, cudaStream_t s) {
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  if (M > DEC_MMAX) {
    const bool x_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(w.xq) % 16 == 0;
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    w4a8_mma_kernel<BITS><<<grid, THREADS, 0, s>>>(w.xq, w.a_scale, w.rsum,
                                                   packed, scale, zp, y, M, K,
                                                   N, group, x_vec, w_vec);
    return cudaGetLastError();
  }
  const int G = K / group;
  const int gpb = DEC_SLOTS / dec_slots_per_group((group / 8 * BITS + 3) / 4);
  const int sets = (G + gpb - 1) / gpb;
  dim3 grid(w.ndone, (sets + DEC_SETS - 1) / DEC_SETS);
#define AQ_DEC(MR)                                                            \
  w4a8_decode_kernel<BITS, MR><<<grid, THREADS, 0, s>>>(                      \
      w.xq, w.a_scale, w.rsum, packed, scale, zp, w.terms, w.done, y, M, K,   \
      N, group, w_vec)
  if (M == 1) AQ_DEC(1);
  else if (M == 2) AQ_DEC(2);
  else if (M <= 4) AQ_DEC(4);
  else AQ_DEC(8);
#undef AQ_DEC
  return cudaGetLastError();
}

}  // namespace

extern "C" long long aq_w4a8_workspace_bytes(int M, int K, int N, int group) {
  return carve(nullptr, M, K, N, group).bytes;
}

// `workspace`: workspace_bytes bytes, at least aq_w4a8_workspace_bytes.
extern "C" int aq_w4a8_matmul(const float* x, void* workspace,
                              long long workspace_bytes, const uint8_t* packed,
                              const float* scale, const float* zp, float* y,
                              int M, int K, int N, int bits, int group,
                              int a_bits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (group <= 0 || K % group) return (int)cudaErrorInvalidValue;
  const Workspace w = carve(static_cast<uint8_t*>(workspace), M, K, N, group);
  if (workspace == nullptr || workspace_bytes < w.bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qmax = (float)((1 << (a_bits - 1)) - 1);
  aq::act_quant_kernel<<<M, aq::ACT_THREADS, 0, s>>>(
      x, w.xq, w.a_scale, w.rsum, K, group, qmax, w.done, w.ndone);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (bits) {
    case 2:
      return (int)launch_main<2>(w, packed, scale, zp, y, M, K, N, group, s);
    case 4:
      return (int)launch_main<4>(w, packed, scale, zp, y, M, K, N, group, s);
    case 8:
      return (int)launch_main<8>(w, packed, scale, zp, y, M, K, N, group, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
