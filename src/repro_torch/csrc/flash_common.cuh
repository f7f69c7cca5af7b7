// Block body shared by flash_decode.cu and flash_prefill.cu.
//
// A block owns up to RT query rows of one (batch, kv-head) pair; row r
// attends the cache positions [0, end[r]) of that pair and end[r] == 0 means
// a zero output row.  Decode gives its G folded query heads end = cur_len;
// prefill gives chunk row (c, g) end = offset + c + 1 while c < chunk_len.
// Sharing the body is what makes a one-token prefill chunk equal decode on
// the same cache bit for bit.
//
// The KV walk is a loop inside the block (the TPU kernel's sequential grid
// axis): tiles of T = 32 positions up to max_r end[r], so work and reads
// stop at the valid prefix.  Each tile is read from the cache as stored
// (int8 codes * per-(token, head) float32 scale, or float32) and
// dequantized into shared memory; no float copy of the cache is ever
// written to device memory.  Scores are float32 dots scaled by 1/sqrt(D)
// after the sum, as the plain version does; the softmax is online in
// float32 (running max, running sum, rescale by exp(m_old - m_new)) with
// the reference's -1e30 initial max.  A masked position never enters the
// p @ v sum at all (a NaN left in a stale slot cannot leak through 0 * NaN).
//
// Threads: 4 warps.  Scores: lane = position in the tile, warp = row
// (RT / 4 rows each), rows padded by one float in shared memory against
// bank conflicts.  p @ v: thread t owns head-dim columns t and t + 128 for
// all RT rows, so D <= 256.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aq {

constexpr int FLASH_T = 32;
constexpr int FLASH_THREADS = 128;
constexpr float FLASH_MASK = -1e30f;

template <int RT>
__host__ __device__ inline int flash_smem_bytes(int D) {
  return (int)sizeof(float) *
         (RT * (D + 1) + FLASH_T * (D + 1) + FLASH_T * D + RT * FLASH_T + 3 * RT) +
         (int)sizeof(int) * RT;
}

// The per-row prefix lengths, last in shared memory; the caller fills them
// (zeros for rows past nrows) and synchronises before flash_rows.
template <int RT>
__device__ __forceinline__ int* flash_ends(float* smem, int D) {
  return reinterpret_cast<int*>(
      smem + RT * (D + 1) + FLASH_T * (D + 1) + FLASH_T * D + RT * FLASH_T + 3 * RT);
}

// kv: (b, h)-offset base of the cache entry; position p of that pair is at
// element p * Hkv * D (codes / floats) and p * Hkv (scales).
template <int RT, bool INT8>
__device__ void flash_rows(const float* __restrict__ q, const void* __restrict__ kv_k,
                           const void* __restrict__ kv_v,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, int Hkv, int D,
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
  const long long stride = (long long)Hkv * D;
  __syncthreads();

  for (int t0 = 0; t0 < max_end; t0 += FLASH_T) {
    const int tn = min(FLASH_T, max_end - t0);
    for (int i = tid; i < tn * D; i += FLASH_THREADS) {
      int p = i / D, d = i % D;
      long long e = (long long)(t0 + p) * stride + d;
      float kf, vf;
      if (INT8) {
        long long si = (long long)(t0 + p) * Hkv;
        kf = (float)static_cast<const int8_t*>(kv_k)[e] * k_scale[si];
        vf = (float)static_cast<const int8_t*>(kv_v)[e] * v_scale[si];
      } else {
        kf = static_cast<const float*>(kv_k)[e];
        vf = static_cast<const float*>(kv_v)[e];
      }
      ks[p * (D + 1) + d] = kf;
      vs[p * D + d] = vf;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp * RPW + j;
      const int pos = t0 + lane;
      const bool valid = lane < tn && pos < ends[r];
      float s = FLASH_MASK;
      if (valid) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot = fmaf(qs[r * (D + 1) + d], ks[lane * (D + 1) + d], dot);
        s = dot * scale;
      }
      if (t0 >= ends[r]) {                   // no valid position in this tile
        ps[r * FLASH_T + lane] = 0.f;
        if (lane == 0) cs[r] = 1.f;
        continue;
      }
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = valid ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * FLASH_T + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[r] = corr;
        ls[r] = __fadd_rn(__fmul_rn(ls[r], corr), sum);
        ms[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = tid + c * FLASH_THREADS;
      if (d >= D) continue;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float a = acc[c][r] * cs[r];
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
        out[(long long)r * D + d] = ends[r] > 0 ? acc[c][r] / fmaxf(ls[r], 1e-30f) : 0.f;
  }
}

}  // namespace aq
