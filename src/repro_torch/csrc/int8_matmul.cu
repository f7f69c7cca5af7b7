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
// is not reproduced).
//
// The int32 dot is exact in any order, so the only float work is the
// epilogue, written with explicitly rounded intrinsics in the plain
// version's order, __fmul_rn(__fmul_rn(__int2float_rn(acc), x_scale),
// w_scale), which nvcc cannot contract: kernel and plain version agree bit
// for bit.
//
// Two bodies:
//  * int8_mma (M > 8): one 128x128 output tile per block, 8 warps of 64x32
//    outputs, mma.sync.m16n8k32 s8 x s8 -> s32 on the int8 tensor cores
//    over 64-deep K slabs in shared memory; the next slab's global loads
//    are issued before the current slab's MMAs (register staging).  The
//    MMA's B operand wants 4 consecutive K bytes of one column per
//    register while w_q is row-major, so each thread transposes 4x4 byte
//    blocks with __byte_perm (aq::transpose4x4) on the way into shared
//    memory.  Rows are padded to 80 bytes, which makes the fragment loads
//    conflict-free.
//  * int8_decode (M <= 8): no tile reuse, so the weight stream is all that
//    counts, and it needs many loads in flight.  A block owns 32 columns
//    and 512 rows of K (a split of K); each thread takes 4 columns (one
//    32-bit load per row, a warp reads 4 rows x 32 bytes, whole sectors)
//    and 4 quads of 4 rows, issues all 16 loads before using one,
//    transposes as above and reduces with dp4a against the x codes staged
//    in shared memory.  The 32 partial sums of a column meet in shared
//    memory and go to an int32 workspace (K / 512, M, N); int8_reduce then
//    adds the splits (exact in any order) and runs the epilogue.
// Ragged M, N and K are masked with zero codes, which add nothing.
//
// What bounds it on an H100: at decode the K*N weight bytes at 3.35 TB/s;
// at M = 512 the 2*M*K*N int8 operations at 1,979 TOP/s, a rate only
// wgmma fed by TMA reaches (not used in this first version).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 64, LDS = BK + 16;
// Decode body: M <= DEC_MMAX rows, DEC_COLS columns and DEC_KQ quads of K
// (4 * DEC_KQ = 512 rows, the K split the wrapper sizes the workspace by)
// per block.
constexpr int DEC_MMAX = 8, DEC_COLS = 32, DEC_QUADS = DEC_COLS / 4,
              DEC_SLICES = THREADS / DEC_QUADS, DEC_UNROLL = 4,
              DEC_KQ = DEC_SLICES * DEC_UNROLL;

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

// Row m, columns k..k+3 of the (M, K) int8 matrix x as one word, zero past
// K.  `word_ok`: K % 4 == 0 and x is 4-byte aligned.
__device__ __forceinline__ uint32_t load_row4(const int8_t* __restrict__ x,
                                              int m, int k, int K,
                                              bool word_ok) {
  const int8_t* row = x + (long long)m * K;
  if (word_ok && k < K)
    return __ldg(reinterpret_cast<const unsigned int*>(row + k));
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K) v |= (uint32_t)(uint8_t)row[k + j] << (8 * j);
  return v;
}

__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

__global__ void __launch_bounds__(THREADS)
int8_decode_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   int* __restrict__ part, int M, int K, int N, bool x_word,
                   bool w_word) {
  __shared__ int x_s[DEC_MMAX][DEC_KQ];             // the split's x codes
  __shared__ int red[DEC_SLICES][DEC_MMAX][DEC_COLS];
  const int cq = threadIdx.x % DEC_QUADS, slice = threadIdx.x / DEC_QUADS;
  const int n = blockIdx.x * DEC_COLS + 4 * cq;
  const int q0 = blockIdx.y * DEC_KQ;               // the split's first quad
  uint32_t r[DEC_UNROLL][4];
#pragma unroll
  for (int u = 0; u < DEC_UNROLL; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[u][i] = load_cols4(wq, 4 * (q0 + slice + DEC_SLICES * u) + i, n, K,
                           N, w_word);
  for (int i = threadIdx.x; i < M * DEC_KQ; i += THREADS)
    x_s[i / DEC_KQ][i % DEC_KQ] =
        (int)load_row4(xq, i / DEC_KQ, 4 * (q0 + i % DEC_KQ), K, x_word);
  __syncthreads();
  int acc[DEC_MMAX][4] = {};
#pragma unroll
  for (int u = 0; u < DEC_UNROLL; ++u) {
    uint32_t c[4];
    aq::transpose4x4(r[u], c);
#pragma unroll
    for (int m = 0; m < DEC_MMAX; ++m) {
      if (m < M) {
        const int xv = x_s[m][slice + DEC_SLICES * u];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(xv, (int)c[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < DEC_MMAX; ++m)
    if (m < M)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[slice][m][4 * cq + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < M * DEC_COLS; i += THREADS) {
    const int m = i / DEC_COLS, l = i % DEC_COLS;
    const int col = blockIdx.x * DEC_COLS + l;
    if (col >= N) continue;
    int s = 0;
    for (int sl = 0; sl < DEC_SLICES; ++sl) s += red[sl][m][l];
    part[((long long)blockIdx.y * M + m) * N + col] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
int8_reduce_kernel(const int* __restrict__ part, const float* __restrict__ xs,
                   const float* __restrict__ ws, float* __restrict__ y, int M,
                   int N, int splits) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  int s = 0;
  for (int k = 0; k < splits; ++k) s += part[k * mn + i];
  y[i] = epilogue(s, xs[i / N], ws[i % N]);
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
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+r"(acc[mt][nt][0]), "+r"(acc[mt][nt][1]),
                "+r"(acc[mt][nt][2]), "+r"(acc[mt][nt][3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                "r"(b[nt][0]), "r"(b[nt][1]));
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

// `part`: the decode body's int32 workspace, max(1, ceil(K / 512)) x M x N
// (the wrapper allocates it for M <= 8).
cudaError_t launch_int8(const int8_t* xq, const float* xs, const int8_t* wq,
                        const float* ws, float* y, int* part, int M, int K,
                        int N, cudaStream_t s) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xq);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(wq);
  const bool x_vec = K % 16 == 0 && xa % 16 == 0;
  const bool x_word = K % 4 == 0 && xa % 4 == 0;
  const bool w_word = N % 4 == 0 && wa % 4 == 0;
  if (M <= DEC_MMAX) {
    const int splits = max(1, (K + 4 * DEC_KQ - 1) / (4 * DEC_KQ));
    dim3 grid((N + DEC_COLS - 1) / DEC_COLS, splits);
    int8_decode_kernel<<<grid, THREADS, 0, s>>>(xq, wq, part, M, K, N, x_word,
                                                w_word);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long mn = (long long)M * N;
    int8_reduce_kernel<<<(unsigned)((mn + THREADS - 1) / THREADS), THREADS, 0,
                         s>>>(part, xs, ws, y, M, N, splits);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int8_mma_kernel<<<grid, THREADS, 0, s>>>(xq, xs, wq, ws, y, M, K, N,
                                             x_vec, w_word);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int aq_int8_matmul(const int8_t* xq, const float* x_scale,
                              const int8_t* wq, const float* w_scale,
                              float* y, int* part, int M, int K, int N,
                              void* stream) {
  return (int)launch_int8(xq, x_scale, wq, w_scale, y, part, M, K, N,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int aq_w8a8_matmul(const float* x, int8_t* xq, float* x_scale,
                              const int8_t* wq, const float* w_scale,
                              float* y, int* part, int M, int K, int N,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  aq::act_quant_kernel<<<M, aq::ACT_THREADS, 0, s>>>(x, xq, x_scale, nullptr,
                                                     K, K, 127.f, nullptr, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_int8(xq, x_scale, wq, w_scale, y, part, M, K, N, s);
}
