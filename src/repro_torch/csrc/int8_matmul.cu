// y = (float(x_q . w_q) * x_scale) * w_scale: the int8 x int8 matmuls.
//
// Replaces the TPU kernels repro/kernels/int8_matmul.py::int8_matmul
// (Pallas body _int8_kernel) and ::w8a8_matmul (_w8a8_kernel), and holds to
// the plain oracles repro/kernels/ref.py::int8_matmul_ref and
// ::w8a8_dynamic_ref.  x_q (M, K) int8; x_scale (M) float32, one per row;
// w_q (K, N) int8, row-major; w_scale (N) float32; y (M, N) float32.
// w8a8 takes x (M, K) float32 and first runs the whole-row activation
// pre-pass of common.cuh at qmax 127, as w8a8_dynamic_ref quantizes (the
// TPU kernel's per-(token, K slab) scale is an artifact of its tiling and
// is not reproduced); its codes and scales go to a workspace laid out here
// (aq_w8a8_workspace_bytes).
//
// The int32 dot is exact in any order, so the only float work is the
// epilogue, written with explicitly rounded intrinsics in the plain
// version's order, __fmul_rn(__fmul_rn(__int2float_rn(acc), x_scale),
// w_scale), which nvcc cannot contract: every body agrees with the plain
// version, and a row of y is the same at every M, bit for bit.
//
// Three bodies, chosen by shape in the C entry (aq_int8_body says which):
//  * decode (M <= 8): what bounds it is the K*N weight stream at 3.35 TB/s,
//    so it keeps many 16-byte loads in flight and does little work a byte.
//    A warp owns 128 columns and takes 32-deep K steps of them; a lane
//    loads 16 columns of 8 rows (4 rows and the 4 rows 16 further), the
//    next step's loads in flight while it computes this one, transposes
//    4x4 bytes (aq::transpose4x4) into column words and runs
//    mma.sync.m16n8k32 s8 with the weights as A (16 columns a tile, the
//    lane's 16 columns spread over 8 tiles) and the <= 8 activation rows
//    as B (n8; absent rows are zero codes).  The 8 warps of a block split
//    its K range by steps; the blocks of a cluster split K, as many as
//    bring the blocks to about one an SM (2 at 4096->11008, 4 at N =
//    4096: fewer, longer streams ran faster than more blocks).  The
//    int32 sums meet in shared memory, then across the cluster through
//    distributed shared memory, where each block adds its share of the
//    columns over the cluster and runs the epilogue: one launch, no
//    workspace, exact.
//  * wgmma (M > 8, K > 0, K % 16 == 0, N % 16 == 0, x_q and w_q 16-byte
//    aligned, which every llama-7b linear meets): what bounds it is the
//    2*M*K*N int8 operations at 1,979 TOP/s, a rate only wgmma fed by TMA
//    reaches.
//    For s8 wgmma takes its shared-memory operands K-major only, and w_q
//    is N-major, so the product is computed transposed, y^T = w_q^T x_q^T:
//    the weights are wgmma's A, from registers; x_q (K-major as it lies)
//    is B, straight from shared memory.  One block an SM walks 128 x 128
//    output tiles (persistent).  Its producer warp keeps a ring of 4
//    128-deep K slabs in flight with TMA (cp.async.bulk.tensor, 128-byte
//    swizzle, zero fill past M, N and K) under full / empty mbarriers; its
//    consumer warpgroup issues two wgmma.m64n128k32.s32.s8.s8 a 32-deep
//    step.  A thread gathers its A fragments from the landed row-major w
//    tile, 4 rows x 4 columns a 32-bit load, and transposes them with byte
//    perms.  Which A row is which column is free, so a thread's four A
//    rows (two m64 halves x rows g, g + 8) are 4 adjacent columns: one 4x4
//    block gives all its A registers of a 4-deep K chunk, and its
//    accumulators hold 4 adjacent columns of a row, stored as one float4
//    (a warp writes whole 128-byte rows, so no staging is needed).  The
//    rows of a 4x4 block are read in the order i ^ (t & 2), which with the
//    swizzle makes every load conflict-free.  The other way, a warpgroup
//    rewriting each landed w tile K-major into a second buffer, costs a
//    shared-memory round trip a byte and a barrier a slab; it was not
//    built.
//  * mma_sync (M > 8, any other shape): 128x128 tiles, 8 warps of 64x32,
//    mma.sync.m16n8k32 over 64-deep K slabs staged through registers and
//    masked with zero codes; each thread transposes 4x4 byte blocks of w_q
//    on the way into shared memory (rows padded to 80 bytes).
// The choice is by shape only: no launch failure is caught and retried.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

enum Body { BODY_DECODE = 0, BODY_WGMMA = 1, BODY_MMA_SYNC = 2 };

__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// d += a (16x32 s8, row) . b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// decode body (M <= 8)
// ---------------------------------------------------------------------------

constexpr int DEC_MMAX = 8, DEC_WARPS = 8, DEC_THREADS = 32 * DEC_WARPS,
              DEC_COLS = 128, DEC_CLUSTER = 8, DEC_LD = DEC_COLS + 4;

// 16 columns n.. of row k of the (K, N) int8 matrix w, zero past K or N.
// VEC: N % 16 == 0 and w 16-byte aligned, so a chunk is one 16-byte load.
template <bool VEC>
__device__ __forceinline__ void load_w16(uint32_t (&v)[4],
                                         const int8_t* __restrict__ w, int k,
                                         int n, int K, int N) {
  v[0] = v[1] = v[2] = v[3] = 0u;
  if (k >= K) return;
  const int8_t* row = w + (long long)k * N;
  if constexpr (VEC) {
    if (n < N) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + n));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (n + j < N) v[j / 4] |= (uint32_t)(uint8_t)row[n + j] << (8 * (j % 4));
  }
}

// Row m, columns k..k+3 of the (M, K) int8 matrix x as one word, zero past
// M or K.  VEC: K % 16 == 0 and x 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ uint32_t load_x4(const int8_t* __restrict__ x,
                                            int m, int k, int M, int K) {
  if (m >= M) return 0u;
  const int8_t* row = x + (long long)m * K;
  if constexpr (VEC) {
    return k < K ? __ldg(reinterpret_cast<const unsigned*>(row + k)) : 0u;
  } else {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k + j < K) v |= (uint32_t)(uint8_t)row[k + j] << (8 * j);
    return v;
  }
}

// A lane's share of K step s: rows 32s + 4t + i and 32s + 16 + 4t + i
// (i < 4) of w, columns n..n+15; and its B fragment, row g of x at
// columns 32s + 4t.. and 32s + 16 + 4t..
struct Step {
  uint32_t w[8][4];
  uint32_t b[2];
};

template <bool VEC>
__device__ __forceinline__ void load_step(Step& st,
                                          const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w, int s,
                                          int g, int t, int n, int M, int K,
                                          int N) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    load_w16<VEC>(st.w[i], w, 32 * s + 4 * t + i, n, K, N);
    load_w16<VEC>(st.w[4 + i], w, 32 * s + 16 + 4 * t + i, n, K, N);
  }
  st.b[0] = load_x4<VEC>(x, g, 32 * s + 4 * t, M, K);
  st.b[1] = load_x4<VEC>(x, g, 32 * s + 16 + 4 * t, M, K);
}

template <bool VEC>
__global__ void __launch_bounds__(DEC_THREADS, 2)
int8_decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ wq, const float* __restrict__ ws,
                   float* __restrict__ y, int M, int K, int N) {
  // red[warp][m * DEC_LD + p], column f at p = (f % 16) * 8 + f / 16: a
  // warp's stores of one fragment register hit 32 distinct banks
  __shared__ int red[DEC_WARPS][DEC_MMAX * DEC_LD];
  __shared__ int part[DEC_MMAX * DEC_COLS];           // the block's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n = blockIdx.x * DEC_COLS + 16 * g;       // the lane's 16 columns
  const int steps = (K + 31) / 32, per = (steps + cs - 1) / cs;
  const int s_end = min(steps, (rank + 1) * per);
  // tile T, register 2h + e: column 16g + 2T + h, row 2t + e
  int acc[8][4] = {};
  Step cur, nxt;
  int s = rank * per + warp;
  if (s < s_end) load_step<VEC>(cur, xq, wq, s, g, t, n, M, K, N);
  if (s + DEC_WARPS < s_end)
    load_step<VEC>(nxt, xq, wq, s + DEC_WARPS, g, t, n, M, K, N);
  for (; s < s_end; s += DEC_WARPS) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {             // columns 16g + 4u .. + 3
      const uint32_t r0[4] = {cur.w[0][u], cur.w[1][u], cur.w[2][u], cur.w[3][u]};
      const uint32_t r1[4] = {cur.w[4][u], cur.w[5][u], cur.w[6][u], cur.w[7][u]};
      uint32_t c0[4], c1[4];                  // column words, K 4t.. / 16+4t..
      aq::transpose4x4(r0, c0);
      aq::transpose4x4(r1, c1);
      mma_s8(acc[2 * u], c0[0], c0[1], c1[0], c1[1], cur.b[0], cur.b[1]);
      mma_s8(acc[2 * u + 1], c0[2], c0[3], c1[2], c1[3], cur.b[0], cur.b[1]);
    }
    if (s + DEC_WARPS < s_end) {
      cur = nxt;
      if (s + 2 * DEC_WARPS < s_end)
        load_step<VEC>(nxt, xq, wq, s + 2 * DEC_WARPS, g, t, n, M, K, N);
    }
  }
#pragma unroll
  for (int T = 0; T < 8; ++T)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[warp][(2 * t + e) * DEC_LD + (2 * T + h) * 8 + g] = acc[T][2 * h + e];
  __syncthreads();
  for (int i = tid; i < M * DEC_COLS; i += DEC_THREADS) {
    const int m = i / DEC_COLS, p = i % DEC_COLS;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) sum += red[w][m * DEC_LD + p];
    part[m * DEC_COLS + (p % 8) * 16 + p / 8] = sum;
  }
  cluster.sync();
  // block `rank` finishes columns f0 .. f0 + nf - 1 over the whole cluster
  const int fper = (DEC_COLS + cs - 1) / cs;
  const int f0 = rank * fper, nf = min(fper, DEC_COLS - f0);
  for (int i = tid; i < M * nf; i += DEC_THREADS) {
    const int m = i / nf, f = f0 + i % nf;
    const int col = blockIdx.x * DEC_COLS + f;
    int sum = 0;
    for (int r = 0; r < cs; ++r)
      sum += cluster.map_shared_rank(part, r)[m * DEC_COLS + f];
    if (col < N) y[(long long)m * N + col] = epilogue(sum, xs[m], ws[col]);
  }
  cluster.sync();                     // no block leaves while others read it
}

// ---------------------------------------------------------------------------
// wgmma body (M > 8, TMA-able shapes)
// ---------------------------------------------------------------------------

// A block is one consumer warpgroup and one producer warp; a tile is 128 x
// 128 and a ring stage holds its w box, then its x box.
constexpr int WG_THREADS = 128, WG_BK = 128, WG_BOX = 128 * 128,
              WG_STAGES = 4, WG_STAGE = 2 * WG_BOX,
              WG_BLOCK = WG_THREADS + 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One TMA box of `map` at (c0 innermost, c1) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory descriptor of a K-major operand in TMA's 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1,024 bytes apart (the leading offset is
// unused in this layout).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators' reads and writes between the wgmma fences.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64x128 s32) (+)= a (64x32 s8, registers) . b (32x128 s8, K-major in
// shared memory at descriptor db); accumulate = 0 starts the sum.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The ring (1,024-byte aligned for the swizzle), its 2 * WG_STAGES
// mbarriers and the alignment slack.
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8 + 1024;

__global__ void __launch_bounds__(WG_BLOCK, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  float* __restrict__ y, int M, int K, int N, int tiles_m,
                  int tiles) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;   // stage s at s * WG_STAGE
  const uint32_t bars = ring + WG_STAGES * WG_STAGE;  // full[s], empty[s]
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const int kslabs = (K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (WG_STAGES + s), 4);  // an arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_THREADS) {  // ---- producer: one lane loads
    if (threadIdx.x != WG_THREADS) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile / tiles_m) * 128;
      const int m0 = (tile % tiles_m) * 128;
      for (int kb = 0; kb < kslabs; ++kb, ++it) {
        const int s = it % WG_STAGES;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (WG_STAGES + s), ((it / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full, WG_STAGE);
        tma_load(ring + s * WG_STAGE, &wmap, full, n0, kb * WG_BK);
        tma_load(ring + s * WG_STAGE + WG_BOX, &xmap, full, kb * WG_BK, m0);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, q = 8 * warp + g;  // columns 4q..4q+3
  // byte offsets in a 16-row block of the w tile of rows 4t + (i ^ (t & 2)),
  // columns 4q..4q+3, in the 128-byte swizzle (chunk ^= row % 8)
  uint32_t off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * t + (i ^ (t & 2));
    off[i] = r * 128 + ((((q >> 2) ^ (r & 7))) << 4) + ((q & 3) << 2);
  }
  // byte perms that undo the row order: rows (2, 3, 0, 1) when t & 2
  const uint32_t sel0 = (t & 2) ? 0x1054u : 0x5410u;
  const uint32_t sel1 = (t & 2) ? 0x3276u : 0x7632u;
  // acc[j]: wgmma half j; A row g + 8h of half j is column 4q + 2j + h
  int acc[2][64] = {};
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile / tiles_m) * 128;
    const int m0 = (tile % tiles_m) * 128;
    int prev = -1;                      // the stage the last step read
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    for (int kb = 0; kb < kslabs; ++kb, ++it) {
      const int s = it % WG_STAGES;
      mbar_wait(bars + 8 * s, (it / WG_STAGES) & 1);
      const uint8_t* wt = ring_ptr + s * WG_STAGE;
      const uint32_t xt = ring + s * WG_STAGE + WG_BOX;
#pragma unroll
      for (int ks = 0; ks < WG_BK / 32; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int b = 0; b < 2; ++b) {     // K rows 32ks + 16b + 4t ..
          const uint8_t* blk = wt + (32 * ks + 16 * b) * 128;
          uint32_t r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = *reinterpret_cast<const uint32_t*>(blk + off[i]);
          const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
          const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
          const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
          const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
          a[0][2 * b] = __byte_perm(t0, t1, sel0);      // column 4q
          a[0][2 * b + 1] = __byte_perm(t0, t1, sel1);  // 4q + 1
          a[1][2 * b] = __byte_perm(t2, t3, sel0);      // 4q + 2
          a[1][2 * b + 1] = __byte_perm(t2, t3, sel1);  // 4q + 3
        }
        const uint64_t db = sw128_desc(xt + 32 * ks);
        const int accumulate = (kb | ks) != 0;
        wgmma_fence();
        wgmma_m64n128k32(acc[0], a[0], db, accumulate);
        wgmma_m64n128k32(acc[1], a[1], db, accumulate);
        wgmma_commit();
        wgmma_wait<1>();                  // the step before has finished
        if (ks == 0 && prev >= 0 && lane == 0)
          mbar_arrive(bars + 8 * (WG_STAGES + prev));
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(bars + 8 * (WG_STAGES + prev));
    // epilogue: register 4c + 2h + e of half j is column 4q + 2j + h,
    // row 8c + 2t + e; a thread's 4 columns of a row are one float4
    const int col = n0 + 4 * q;
    if (col < N) {
      const float w0 = ws[col], w1 = ws[col + 1], w2 = ws[col + 2],
                  w3 = ws[col + 3];
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * c + 2 * t + e;
          if (m < M) {
            const float sx = xs[m];
            float4 o;
            o.x = epilogue(acc[0][4 * c + e], sx, w0);
            o.y = epilogue(acc[0][4 * c + 2 + e], sx, w1);
            o.z = epilogue(acc[1][4 * c + e], sx, w2);
            o.w = epilogue(acc[1][4 * c + 2 + e], sx, w3);
            *reinterpret_cast<float4*>(y + (long long)m * N + col) = o;
          }
        }
    }
  }
}

// ---------------------------------------------------------------------------
// mma_sync body (M > 8, any shape)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 64, LDS = BK + 16;

// Row k, columns n..n+3 of the (K, N) int8 matrix w as one word (byte j =
// column n + j), zero past K or N.  `word_ok`: N % 4 == 0 and w is 4-byte
// aligned, so an in-range quad is one 32-bit load.
__device__ __forceinline__ uint32_t load_cols4(const int8_t* __restrict__ w,
                                               int k, int n, int K, int N,
                                               bool word_ok) {
  if (k >= K) return 0u;
  const int8_t* row = w + (long long)k * N;
  if (word_ok && n < N)
    return __ldg(reinterpret_cast<const unsigned int*>(row + n));
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) v |= (uint32_t)(uint8_t)row[n + j] << (8 * j);
  return v;
}

struct Stage {          // one K slab's global loads, held in registers
  int4 a[2];            // two 16-byte chunks of the x_q tile
  uint32_t b[2][4];     // two 4x4 blocks of the w_q tile, as rows
};

__device__ __forceinline__ void load_stage(Stage& st,
                                           const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq,
                                           int m0, int n0, int k0, int M,
                                           int K, int N, bool x_vec,
                                           bool w_word) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + THREADS * i;
    const int gm = m0 + c / 4, k = k0 + 16 * (c % 4);
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = threadIdx.x + THREADS * i, l = blk % 32, wid = blk / 32;
    const int kq = l % 4 + 4 * (wid % 4), nq = l / 4 + 8 * (wid / 4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st.b[i][r] = load_cols4(wq, k0 + 4 * kq + r, n0 + 4 * nq, K, N, w_word);
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, int8_t* As,
                                            int8_t* Bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + THREADS * i;
    *reinterpret_cast<int4*>(As + (c / 4) * LDS + 16 * (c % 4)) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = threadIdx.x + THREADS * i, l = blk % 32, wid = blk / 32;
    const int kq = l % 4 + 4 * (wid % 4), nq = l / 4 + 8 * (wid / 4);
    uint32_t col[4];
    aq::transpose4x4(st.b[i], col);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(Bs + (4 * nq + j) * LDS + 4 * kq) = col[j];
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
int8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const int8_t* __restrict__ wq, const float* __restrict__ ws,
                float* __restrict__ y, int M, int K, int N, bool x_vec,
                bool w_word) {
  __shared__ __align__(16) int8_t As[BM * LDS];   // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];   // [n][k]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;         // 2 x 4 warps of 64 x 32
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4][4] = {};                          // [m16][n8][fragment]
  Stage st;
  load_stage(st, xq, wq, m0, n0, 0, M, K, N, x_vec, w_word);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_stage(st, As, Bs);
    __syncthreads();
    if (k0 + BK < K) load_stage(st, xq, wq, m0, n0, k0 + BK, M, K, N, x_vec, w_word);
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* r0 = As + (wm * 64 + mt * 16 + g) * LDS + kb + 4 * t;
        a[mt][0] = lds32(r0);
        a[mt][1] = lds32(r0 + 8 * LDS);
        a[mt][2] = lds32(r0 + 16);
        a[mt][3] = lds32(r0 + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* c0 = Bs + (wn * 32 + nt * 8 + g) * LDS + kb + 4 * t;
        b[nt][0] = lds32(c0);
        b[nt][1] = lds32(c0 + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                 b[nt][0], b[nt][1]);
    }
    __syncthreads();
  }
  // fragment i of an m16n8 tile: row g (+8 for i >= 2), column 2t + i % 2
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + wm * 64 + mt * 16 + g + 8 * (i / 2);
      if (gm >= M) continue;
      const float sx = xs[gm];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + wn * 32 + nt * 8 + 2 * t + i % 2;
        if (gn < N) y[(long long)gm * N + gn] = epilogue(acc[mt][nt][i], sx, ws[gn]);
      }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda at link time).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D int8 tensor map of a row-major (rows, cols) matrix, 128 x 128 byte
// boxes in the 128-byte swizzle, zero fill outside.
bool make_map(CUtensorMap* map, const int8_t* base, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, 128}, estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<int8_t*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The TMA and 16-byte load precondition: 16-byte aligned bases and rows.
bool vec_ok(const int8_t* xq, const int8_t* wq, int K, int N) {
  return K % 16 == 0 && N % 16 == 0 && aligned16(xq) && aligned16(wq);
}

// K == 0 stays off TMA, which takes no empty dimension (y is then zeros).
Body choose(const int8_t* xq, const int8_t* wq, int M, int K, int N) {
  if (M <= DEC_MMAX) return BODY_DECODE;
  return K > 0 && vec_ok(xq, wq, K, N) ? BODY_WGMMA : BODY_MMA_SYNC;
}

template <bool VEC>
cudaError_t launch_decode(const int8_t* xq, const float* xs, const int8_t* wq,
                          const float* ws, float* y, int M, int K, int N,
                          cudaStream_t s) {
  // K splits so that the column slabs' blocks come to about one an SM, at
  // most 8, each with at least one 32-deep step a warp
  const int slabs = (N + DEC_COLS - 1) / DEC_COLS, steps = (K + 31) / 32;
  int cs = max(1, min(DEC_CLUSTER, (sm_count() + slabs / 2) / slabs));
  while (cs > 1 && cs * DEC_WARPS > steps) --cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, cs);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_decode_kernel<VEC>, xq, xs, wq, ws, y,
                            M, K, N);
}

cudaError_t launch_wgmma(const int8_t* xq, const float* xs, const int8_t* wq,
                         const float* ws, float* y, int M, int K, int N,
                         cudaStream_t s) {
  if (!aligned16(y)) return cudaErrorInvalidValue;   // float4 stores
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, xq, M, K) || !make_map(&wmap, wq, K, N))
    return cudaErrorNotSupported;
  // the ring's shared-memory limit is raised once per device
  static std::atomic<unsigned> ready{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((ready.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(int8_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WG_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 32) ready.fetch_or(1u << dev);
  }
  const int tiles_m = (M + 127) / 128;
  const int tiles = tiles_m * ((N + 127) / 128);
  // persistent: one block an SM walks the tiles, M fastest, so the blocks
  // running at once share their w tiles in L2
  const int grid = min(tiles, sm_count());
  int8_wgmma_kernel<<<grid, WG_BLOCK, WG_SMEM, s>>>(xmap, wmap, xs, ws, y, M,
                                                    K, N, tiles_m, tiles);
  return cudaGetLastError();
}

cudaError_t launch_int8(const int8_t* xq, const float* xs, const int8_t* wq,
                        const float* ws, float* y, int M, int K, int N,
                        cudaStream_t s) {
  const bool vec = vec_ok(xq, wq, K, N);
  switch (choose(xq, wq, M, K, N)) {
    case BODY_DECODE:
      return vec ? launch_decode<true>(xq, xs, wq, ws, y, M, K, N, s)
                 : launch_decode<false>(xq, xs, wq, ws, y, M, K, N, s);
    case BODY_WGMMA:
      return launch_wgmma(xq, xs, wq, ws, y, M, K, N, s);
    default: {
      const bool x_vec = K % 16 == 0 && aligned16(xq);
      const bool w_word = N % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 4 == 0;
      dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
      int8_mma_kernel<<<grid, THREADS, 0, s>>>(xq, xs, wq, ws, y, M, K, N,
                                               x_vec, w_word);
      return cudaGetLastError();
    }
  }
}

// w8a8_matmul's workspace: the activation codes (M, K) int8, then x_scale
// (M,) float32 at the next 256-byte boundary.
long long w8a8_codes_bytes(int M, int K) {
  return ((long long)M * K + 255) / 256 * 256;
}

}  // namespace

// Which body a call with these operands takes: 0 decode, 1 wgmma,
// 2 mma_sync.
extern "C" int aq_int8_body(int M, int K, int N, const int8_t* xq,
                            const int8_t* wq) {
  return (int)choose(xq, wq, M, K, N);
}

extern "C" int aq_int8_matmul(const int8_t* xq, const float* x_scale,
                              const int8_t* wq, const float* w_scale,
                              float* y, int M, int K, int N, void* stream) {
  if (M == 0 || N == 0) return 0;
  return (int)launch_int8(xq, x_scale, wq, w_scale, y, M, K, N,
                          static_cast<cudaStream_t>(stream));
}

extern "C" long long aq_w8a8_workspace_bytes(int M, int K) {
  return w8a8_codes_bytes(M, K) + 4LL * M;
}

// `workspace`: workspace_bytes bytes, at least aq_w8a8_workspace_bytes,
// 256-byte aligned.
extern "C" int aq_w8a8_matmul(const float* x, void* workspace,
                              long long workspace_bytes, const int8_t* wq,
                              const float* w_scale, float* y, int M, int K,
                              int N, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (workspace == nullptr || workspace_bytes < aq_w8a8_workspace_bytes(M, K) ||
      reinterpret_cast<uintptr_t>(workspace) % 256 != 0)
    return (int)cudaErrorInvalidValue;
  int8_t* xq = static_cast<int8_t*>(workspace);
  float* x_scale = reinterpret_cast<float*>(static_cast<uint8_t*>(workspace) +
                                            w8a8_codes_bytes(M, K));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  aq::act_quant_kernel<<<M, aq::ACT_THREADS, 0, s>>>(x, xq, x_scale, nullptr,
                                                     K, K, 127.f, nullptr, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_int8(xq, x_scale, wq, w_scale, y, M, K, N, s);
}
