// y = x @ ((unpack(packed) - zp) * scale): the weight-only packed matmul.
//
// Replaces the TPU kernel repro/kernels/dequant_matmul.py::dequant_matmul
// (the Pallas body _kernel / _unpack_block).  It runs every linear of the
// a16 serving path: x (M, K) float32, packed (K/8*BITS, N) uint8,
// scale/zp (K/g, N) float32, y (M, N) float32.
//
// What bounds it on an H100: at decode (M <= 8) the packed weight stream,
// K*N*BITS/8 bytes plus 8*K*N/g bytes of scale and zero point, against
// 3.35 TB/s.  At prefill (M in the hundreds) the 2*M*K*N float32
// multiply-adds against the 67 TFLOP/s of the CUDA cores: x is float32, so
// there is no tensor-core path that keeps float32 accuracy (no TF32).
//
// The pinned arithmetic.  A row of y is the same bit for bit whatever M is
// and whichever body runs, so that chunked admission and preemption, which
// recompute a token's K/V at another M, see the same numbers.  Every
// weight is (code - zp) * scale with separate float32 roundings, as the
// plain version computes it; K is cut into splits of SPLIT = 512 rows; in
// each split y[m][n] is an fmaf chain over its rows in increasing order,
// from +0; the splits' chains are added left to right,
// ((c0 + c1) + c2) + ..., with __fadd_rn.  That order rules out the tensor
// cores (an MMA adds in its own order): the prefill body is CUDA-core
// float32 work, and its speed comes from reuse in registers and shared
// memory and from keeping loads in flight.
//
// Two bodies:
//  * decode (M <= 8): no reuse of a weight across rows to speak of, so the
//    weight stream is all that counts and it needs many loads in flight.
//    A block of 256 threads owns 256 columns and one split, a thread one
//    column (a warp reads 32 contiguous bytes of each packed byte row), so
//    that the M chains of a column-split are all a thread computes and
//    enough warps are resident to hide latency (88K threads at
//    4096->11008).  A thread walks the split's units of 8 rows in batches
//    of 16 / BITS units, all of a batch's 16 byte loads issued before the
//    first use (more per batch cost occupancy and ran slower); x of the
//    split sits in shared memory.  Each split's chains go to a
//    float32 workspace (splits, M, N) and a second launch adds them in
//    split order (no atomics: the result is deterministic); a single split
//    writes y directly.
//  * tile (M > 8): a BM x BN output tile a block, 8 x 8 outputs a thread
//    (two 4-row by two 4-column quads, BM/2 and BN/2 apart, so the
//    float4 reads of a quarter warp fall in distinct banks), which reads
//    four float4s from shared memory for every 64 fmaf (8 x 4: one
//    column quad, three float4s for 32 fmaf).  K goes in slabs of BK = 32
//    rows through a ring of S stages: 16-byte cp.async copies of x's rows
//    and of the packed weight bytes for slab t + S are in flight while
//    slab t computes (plain loads where a row is not 16-byte aligned: N %
//    16 != 0 for the bytes).  Slab t + 1 is made ready in the same step:
//    x transposed to K-major and every weight of the slab dequantized
//    once, from the staged bytes, into a second compute buffer, 4 rows x 4
//    columns a thread (one 32-bit load a byte row, 16-byte stores; the
//    scales and zero points were loaded into registers a slab earlier), so
//    one barrier a slab suffices.  At each split's end a thread hands its
//    chains on: into y (y = c0, then y = y + c_s, which the thread alone
//    reads and writes) when the block walks all of K, or into the
//    workspace slot of the split when K is cut across blocks at split
//    boundaries (grid z), which split_sum_kernel adds in split order, as
//    the decode body does.  Two tile shapes: 128x128 at 8 x 8 outputs a
//    thread with a 2-stage ring (256 threads, two blocks an SM) and 64x64
//    at 8 x 4 with a 4-stage ring (128 threads, three blocks an SM at w4),
//    the deeper ring for the narrow linears whose few blocks leave one
//    block an SM.  choose_tile picks the shape and the number of K chunks
//    from (M, K, N) and the SM count alone: 64x64 where 128x128 tiles
//    cannot fill the SMs, K cut until every resident slot has four blocks.
//    Every shape and cut runs the same chains in the same order, so all
//    give the same bits.  The compute loop compiles to nothing but fmaf
//    and 16-byte shared loads (2048 and 128 a slab of the 128x128 tile).
//    Rows past M and columns past N are zero and never stored; rows past K
//    are zero x times zero weights, and fmaf(0, 0, acc) returns acc exactly
//    (acc is never -0).  A NaN in a row of x stays in that row.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int SPLIT = 512;
// decode body
constexpr int DEC_MMAX = 8, DEC_THREADS = 256;
// split sums
constexpr int SUM_THREADS = 256;
// tile body: K rows a slab
constexpr int BK = 32;

__device__ __forceinline__ float weight(int code, float z, float sc) {
  return __fmul_rn(__fsub_rn((float)code, z), sc);
}

template <int BITS, int MR>
__global__ void __launch_bounds__(DEC_THREADS)
dequant_decode_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ scale,
                      const float* __restrict__ zp, float* __restrict__ part,
                      int M, int K, int N, int group) {
  constexpr int UB = 16 / BITS;                  // units per batch
  __shared__ __align__(16) float xs[SPLIT][MR];  // x[m][k0 + k] at xs[k][m]
  const int n = blockIdx.x * DEC_THREADS + threadIdx.x;
  const int k0 = blockIdx.y * SPLIT;
  const int kn = min(SPLIT, K - k0), units = kn / 8;
  for (int i = threadIdx.x; i < kn * MR; i += DEC_THREADS) {
    const int k = i / MR, m = i % MR;
    xs[k][m] = m < M ? x[(long long)m * K + k0 + k] : 0.f;
  }
  __syncthreads();
  if (n >= N) return;
  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;
  const uint8_t* col = packed + (long long)(k0 / 8) * BITS * N + n;
  for (int u0 = 0; u0 < units; u0 += UB) {
    uint32_t w[UB][BITS];                        // byte b of unit uu
#pragma unroll
    for (int uu = 0; uu < UB; ++uu)
#pragma unroll
      for (int b = 0; b < BITS; ++b)
        w[uu][b] = u0 + uu < units
                       ? (uint32_t)__ldg(col + ((long long)(u0 + uu) * BITS + b) * N)
                       : 0u;
#pragma unroll
    for (int uu = 0; uu < UB; ++uu) {
      if (u0 + uu >= units) break;
      const long long gi = (k0 + 8LL * (u0 + uu)) / group;  // g % 8 == 0
      const float sc = __ldg(scale + gi * N + n), z = __ldg(zp + gi * N + n);
      const int kk = 8 * (u0 + uu);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // code i: bits i*BITS .. of the unit's little-endian bytes
        const int code = (int)((w[uu][i * BITS / 8] >> (i * BITS % 8)) &
                               ((1u << BITS) - 1u));
        const float wv = weight(code, z, sc);
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[m] = fmaf(xs[kk + i][m], wv, acc[m]);
      }
    }
  }
  float* out = part + (long long)blockIdx.y * M * N + n;
#pragma unroll
  for (int m = 0; m < MR; ++m)
    if (m < M) out[(long long)m * N] = acc[m];
}

// y = ((part[0] + part[1]) + part[2]) + ...
__global__ void __launch_bounds__(SUM_THREADS)
split_sum_kernel(const float* __restrict__ part, float* __restrict__ y,
                 long long mn, int splits) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[k * mn + i]);
  y[i] = s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  // src_bytes 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Shared memory of a BM x BN tile block: S ring stages (x's rows as
// copied, [BM][XP] floats; the slab's packed bytes, [PR][BN]), then two
// compute buffers (x K-major [BK][BM]; the dequantized weights [BK][BN]).
template <int BM, int BN, int TN, int S, int BITS>
struct Tile {
  static constexpr int THREADS = (BM / 8) * (BN / TN);
  static constexpr int XP = BK + 4;         // x row stride: float4 reads of
                                            // 8 consecutive rows hit 8 banks
  static constexpr int PR = BK / 8 * BITS;  // packed rows a slab
  static constexpr int X_BYTES = BM * XP * 4;
  static constexpr int STAGE = X_BYTES + PR * BN;
  static constexpr int CB = BK * (BM + BN) * 4;
  static constexpr int SMEM = S * STAGE + 2 * CB;
  static_assert(STAGE % 16 == 0 && CB % 16 == 0, "16-byte aligned parts");
};

// part == nullptr: the block walks all of K and folds each split's chains
// into y.  Otherwise it walks splits [z * spb, z * spb + spb) and writes
// each split's chains to part[split] (splits x M x N).
template <int BM, int BN, int TN, int S, int BITS, int MINB>
__global__ void __launch_bounds__(Tile<BM, BN, TN, S, BITS>::THREADS, MINB)
dequant_tile_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zp, float* __restrict__ y,
                    float* __restrict__ part, int M, int K, int N, int group,
                    int spb, int x16, int p16, int v4) {
  using T = Tile<BM, BN, TN, S, BITS>;
  constexpr int THREADS = T::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int splits = (K + SPLIT - 1) / SPLIT;
  const int s0 = blockIdx.z * spb;
  const int kb = s0 * SPLIT, ke = min(min(s0 + spb, splits) * SPLIT, K);
  const int slabs = (ke - kb + BK - 1) / BK;
  const long long prows = (long long)(ke / 8) * BITS;  // ke % 8 == 0

  auto xr = [&](int t) {
    return reinterpret_cast<float*>(smem + (t % S) * T::STAGE);
  };
  auto pk = [&](int t) { return smem + (t % S) * T::STAGE + T::X_BYTES; };
  auto xs = [&](int t) {
    return reinterpret_cast<float*>(smem + S * T::STAGE + (t & 1) * T::CB);
  };
  auto ws = [&](int t) { return xs(t) + BK * BM; };

  // The thread's parts of a slab's copies, fixed for the block: x chunk j
  // (16 bytes) is row xrow + j * XROWS, quad xq of the slab's row; packed
  // chunk j is chunk tid + j * THREADS of the slab's PR x BN bytes.
  constexpr int XQ = BK / 4, XROWS = THREADS / XQ, XCH = BM / XROWS;
  static_assert(XROWS * XQ == THREADS && XCH * XROWS == BM, "x chunks");
  constexpr int PQ = BN / 16, PCH = (T::PR * PQ + THREADS - 1) / THREADS;
  const int xq = tid % XQ, xrow = tid / XQ;
  const float* xsrc = x + (long long)(m0 + xrow) * K + 4 * xq;
  unsigned xin = 0;                    // bit j: chunk j's row lies below M
#pragma unroll
  for (int j = 0; j < XCH; ++j)
    if (m0 + xrow + j * XROWS < M) xin |= 1u << j;

  // Copy slab t's x rows and packed bytes into ring stage t % S and commit
  // them as one group (an empty group past the last slab).
  auto load = [&](int t) {
    if (t < slabs) {
      const int k0 = kb + t * BK;
      const bool kin = k0 + 4 * xq < ke;   // K % 8 == 0: whole chunks
      float* xd = xr(t) + xrow * T::XP + 4 * xq;
#pragma unroll
      for (int j = 0; j < XCH; ++j) {
        const bool ok = kin && (xin >> j & 1u);
        const float* src = xsrc + (long long)j * XROWS * K + k0;
        float* d = xd + j * XROWS * T::XP;
        if (x16) {
          cp_async16(d, ok ? src : x, ok ? 16 : 0);
        } else {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) v = make_float4(src[0], src[1], src[2], src[3]);
          *reinterpret_cast<float4*>(d) = v;
        }
      }
      uint8_t* pd = pk(t);
      const long long r0 = (long long)(k0 / 8) * BITS;
      if (p16) {
#pragma unroll
        for (int j = 0; j < PCH; ++j) {
          const int i = tid + j * THREADS;
          if (PCH * THREADS == T::PR * PQ || i < T::PR * PQ) {
            const int r = i / PQ, c = 16 * (i % PQ);
            const bool ok = r0 + r < prows && n0 + c < N;  // N % 16 == 0
            cp_async16(pd + r * BN + c,
                       ok ? packed + (r0 + r) * N + n0 + c : packed,
                       ok ? 16 : 0);
          }
        }
      } else {
        for (int i = tid; i < T::PR * BN; i += THREADS) {
          const int r = i / BN, c = i % BN;
          pd[i] = (r0 + r < prows && n0 + c < N)
                      ? __ldg(packed + (r0 + r) * N + n0 + c) : (uint8_t)0;
        }
      }
    }
    cp_async_commit();
  };

  // Weight tasks: a (unit, half, column quad) is 4 rows x 4 columns of a
  // slab; the thread's quad cq is fixed, its (unit, half) pairs are wrest +
  // d * WREST.
  constexpr int WQ = BN / 4, WREST = THREADS / WQ;
  constexpr int WT = (BK / 8) * 2 / WREST;     // tasks a thread a slab
  static_assert(WT * WREST == (BK / 8) * 2, "weight tasks");
  const int cq = tid % WQ, wrest = tid / WQ, qn = n0 + 4 * cq;
  unsigned qin = 0;                    // bit c: column qn + c lies below N
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (qn + c < N) qin |= 1u << c;

  // Scales and zero points of the thread's tasks of slab t, loaded a slab
  // ahead of their use; 0 for a column or unit out of range.
  float tsc[WT][4], tzp[WT][4];
  auto fetch = [&](int t) {
    const int u0 = (kb + t * BK) / 8;
#pragma unroll
    for (int d = 0; d < WT; ++d) {
      const int gu = u0 + (wrest + d * WREST) / 2;
      const bool uin = t < slabs && 8 * gu < ke;
      const long long o = (long long)(8 * gu / group) * N + qn;
      if (uin && v4 && qin == 15u) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(scale + o));
        const float4 b = __ldg(reinterpret_cast<const float4*>(zp + o));
        tsc[d][0] = a.x; tsc[d][1] = a.y; tsc[d][2] = a.z; tsc[d][3] = a.w;
        tzp[d][0] = b.x; tzp[d][1] = b.y; tzp[d][2] = b.z; tzp[d][3] = b.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = uin && (qin >> c & 1u);
          tsc[d][c] = ok ? __ldg(scale + o + c) : 0.f;
          tzp[d][c] = ok ? __ldg(zp + o + c) : 0.f;
        }
      }
    }
  };

  // Ring stage t % S -> compute buffer t & 1: x transposed to K-major, the
  // slab's weights dequantized (0 outside the matrix), 4 columns a store.
  auto convert = [&](int t) {
    if (t >= slabs) return;
    const float* xsrc_s = xr(t);
    float* xd = xs(t);
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int i = tid + j * THREADS, m = i % BM, c = 4 * (i / BM);
      const float4 v =
          *reinterpret_cast<const float4*>(xsrc_s + m * T::XP + c);
      xd[(c + 0) * BM + m] = v.x;
      xd[(c + 1) * BM + m] = v.y;
      xd[(c + 2) * BM + m] = v.z;
      xd[(c + 3) * BM + m] = v.w;
    }
    const uint8_t* psrc = pk(t);
    float* wd = ws(t);
    const int u0 = (kb + t * BK) / 8;
    constexpr int HB = BITS / 2;                // bytes of half a unit
#pragma unroll
    for (int d = 0; d < WT; ++d) {
      const int rest = wrest + d * WREST, u = rest / 2, h = rest % 2;
      const bool uin = 8 * (u0 + u) < ke;
      uint32_t word[4];                         // byte c: column qn + c
#pragma unroll
      for (int b = 0; b < HB; ++b)
        word[b] = *reinterpret_cast<const uint32_t*>(
            psrc + (u * BITS + h * HB + b) * BN + 4 * cq);
      uint32_t half[4];                         // column c's 4 codes
      if constexpr (HB == 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) half[c] = word[0] >> (8 * c);
      } else if constexpr (HB == 2) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          half[c] = __byte_perm(word[0], word[1], c | (c + 4) << 4);
      } else {
        aq::transpose4x4(word, half);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // code 4h + r of the unit: bits r*BITS .. of the half's bytes
          const int code = (int)((half[c] >> (r * BITS)) & ((1u << BITS) - 1u));
          v[c] = uin && (qin >> c & 1u) ? weight(code, tzp[d][c], tsc[d][c])
                                         : 0.f;
        }
        *reinterpret_cast<float4*>(wd + (u * 8 + 4 * h + r) * BN + 4 * cq) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Hand split s's chains on (see the file's header) and restart them.
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + (j / 4) * (BN / (TN / 4)) + tx * 4 + j % 4;
        if (gm < M && gn < N) {
          const long long o = (long long)gm * N + gn;
          if (part != nullptr)
            part[(long long)s * M * N + o] = acc[i][j];
          else
            y[o] = s == 0 ? acc[i][j] : __fadd_rn(y[o], acc[i][j]);
        }
        acc[i][j] = 0.f;
      }
    }
  };

#pragma unroll
  for (int t = 0; t < S; ++t) load(t);
  fetch(0);
  cp_async_wait<S - 1>();
  __syncthreads();
  convert(0);
  fetch(1);
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<S - 2>();  // this thread's copies of slab t + 1
    // all copies of slab t + 1 landed; slab t converted; slab t - 1's
    // compute and slab t's ring stage done with
    __syncthreads();
    load(t + S);
    convert(t + 1);
    fetch(t + 2);
    const float* a = xs(t);
    const float* b = ws(t);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * BM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + kk * BM + BM / 2 + ty * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 bq = *reinterpret_cast<const float4*>(
            b + kk * BN + q * (BN / (TN / 4)) + tx * 4);
        bv[4 * q] = bq.x; bv[4 * q + 1] = bq.y;
        bv[4 * q + 2] = bq.z; bv[4 * q + 3] = bq.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    const int k_next = kb + (t + 1) * BK;
    if (k_next % SPLIT == 0 || t == slabs - 1) store((k_next - 1) / SPLIT);
  }
  if (slabs == 0) store(0);   // K == 0: y = +0
}

// ---- the host's choice of tile body ----------------------------------------

int sm_count() {
  static int known[32];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 32) return 132;
  int n = known[dev];
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                       dev) == cudaSuccess)
    known[dev] = n;
  return n > 0 ? n : 132;
}

// The two tile shapes: 128x128 (8 x 8 outputs a thread, 2-stage ring) and
// 64x64 (8 x 4, 4-stage ring), with the blocks an SM holds at w4, as
// Tile<>::SMEM gives them.
struct Shape {
  int bm, bn, per_sm;
};
constexpr Shape SHAPES[2] = {{128, 128, 2}, {64, 64, 3}};

struct Choice {
  int shape;   // index into SHAPES; -1: the decode body
  int chunks;  // K chunks across blocks (grid z); 1: fold into y
  int spb;     // splits a chunk
};

int tiles(const Shape& sh, int M, int N) {
  return ((M + sh.bm - 1) / sh.bm) * ((N + sh.bn - 1) / sh.bn);
}

// 64x64 when 128x128 tiles, even with K cut at every whole split, cannot
// give each SM a block, or when M <= 64 would leave half of a 128-row tile
// empty; else 128x128.  K is then cut into as many chunks (whole splits
// each) as it takes to give every resident slot four blocks, so that the
// last wave is short, and no more than the splits.
Choice choose_tile(int M, int K, int N) {
  if (M <= DEC_MMAX) return {-1, 1, 1};
  const int splits = max(1, (K + SPLIT - 1) / SPLIT), sms = sm_count();
  const int whole = max(1, K / SPLIT);
  const int s = M <= 64 || (long long)tiles(SHAPES[0], M, N) * whole < sms;
  const long long slots = 4LL * sms * SHAPES[s].per_sm;
  const long long t = tiles(SHAPES[s], M, N);
  const int want = (int)std::min<long long>(splits, (slots + t - 1) / t);
  const int spb = (splits + want - 1) / want;
  return {s, (splits + spb - 1) / spb, spb};
}

long long workspace_floats(int M, int K, int N) {
  const long long splits = max(1, (K + SPLIT - 1) / SPLIT);
  if (M <= DEC_MMAX) return splits > 1 ? splits * M * N : 0;
  return choose_tile(M, K, N).chunks > 1 ? splits * M * N : 0;
}

cudaError_t sum_splits(const float* part, float* y, int M, int N, int splits,
                       cudaStream_t s) {
  const long long mn = (long long)M * N;
  split_sum_kernel<<<(unsigned)((mn + SUM_THREADS - 1) / SUM_THREADS),
                     SUM_THREADS, 0, s>>>(part, y, mn, splits);
  return cudaGetLastError();
}

template <int BM, int BN, int TN, int S, int BITS, int MINB>
cudaError_t launch_tile(const float* x, const uint8_t* packed,
                        const float* scale, const float* zp, float* y,
                        float* part, int M, int K, int N, int group,
                        const Choice& c, cudaStream_t s) {
  using T = Tile<BM, BN, TN, S, BITS>;
  auto kernel = dequant_tile_kernel<BM, BN, TN, S, BITS, MINB>;
  static bool raised = false;   // the shared-memory limit, once
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int p16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const int v4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(zp) % 16 == 0;
  float* dst = c.chunks > 1 ? part : nullptr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, c.chunks);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(x, packed, scale, zp, y, dst, M,
                                           K, N, group, c.spb, x16, p16, v4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || c.chunks == 1) return err;
  return sum_splits(part, y, M, N, max(1, (K + SPLIT - 1) / SPLIT), s);
}

template <int BITS>
cudaError_t launch(const float* x, const uint8_t* packed, const float* scale,
                   const float* zp, float* y, float* part, int M, int K, int N,
                   int group, cudaStream_t s) {
  const Choice c = choose_tile(M, K, N);
  if (workspace_floats(M, K, N) > 0 && part == nullptr)
    return cudaErrorInvalidValue;
  switch (c.shape) {
    case 0:
      return launch_tile<128, 128, 8, 2, BITS, 2>(x, packed, scale, zp, y,
                                                  part, M, K, N, group, c, s);
    case 1:
      return launch_tile<64, 64, 4, 4, BITS, 2>(x, packed, scale, zp, y, part,
                                                M, K, N, group, c, s);
    default:
      break;
  }
  const int splits = max(1, (K + SPLIT - 1) / SPLIT);
  float* dst = splits > 1 ? part : y;
  dim3 grid((N + DEC_THREADS - 1) / DEC_THREADS, splits);
#define AQ_DEC(MR)                                                            \
  dequant_decode_kernel<BITS, MR><<<grid, DEC_THREADS, 0, s>>>(               \
      x, packed, scale, zp, dst, M, K, N, group)
  if (M == 1) AQ_DEC(1);
  else if (M == 2) AQ_DEC(2);
  else if (M <= 4) AQ_DEC(4);
  else AQ_DEC(8);
#undef AQ_DEC
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, y, M, N, splits, s);
}

}  // namespace

// The body aq_dequant_matmul runs at (M, K, N), as body | BM << 8 |
// BN << 16 | K chunks << 24: body 0 decode, 1 tile, 2 tile with K cut
// across blocks (BM, BN 0 for decode).
extern "C" long long aq_dequant_plan(int M, int K, int N) {
  const Choice c = choose_tile(M, K, N);
  if (c.shape < 0) return 0;
  const Shape& sh = SHAPES[c.shape];
  return (long long)(c.chunks > 1 ? 2 : 1) | (long long)sh.bm << 8 |
         (long long)sh.bn << 16 | (long long)c.chunks << 24;
}

// The bytes of aq_dequant_matmul's float32 workspace: ceil(K / 512) x M x
// N when the decode body has more than one split or the tile body cuts K
// across blocks, else 0.
extern "C" long long aq_dequant_workspace_bytes(int M, int K, int N) {
  return 4 * workspace_floats(M, K, N);
}

// part: aq_dequant_workspace_bytes(M, K, N) bytes (nullptr when that is 0).
extern "C" int aq_dequant_matmul(const float* x, const uint8_t* packed,
                                 const float* scale, const float* zp,
                                 float* y, float* part, int M, int K, int N,
                                 int bits, int group, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return (int)launch<2>(x, packed, scale, zp, y, part, M, K, N, group, s);
    case 4: return (int)launch<4>(x, packed, scale, zp, y, part, M, K, N, group, s);
    case 8: return (int)launch<8>(x, packed, scale, zp, y, part, M, K, N, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
