// Per-group asymmetric RTN quantization of a weight and its packing along K.
//
// Replaces the TPU kernel repro/kernels/quantize_pack.py::quantize_pack
// (Pallas body _kernel, _pack_block) and holds to the plain oracle
// repro/kernels/ref.py::quantize_pack_ref.  w (B, K, N) float32, finite
// (B = 1 for one matrix); per matrix, group of `group` rows along K and
// column n:
//     scale = max(wmax - wmin, 1e-8) / (2^BITS - 1)      (IEEE division)
//     zp    = rint(-wmin / scale)
//     code  = clip(rint(w / scale) + zp, 0, 2^BITS - 1)
// rint rounds half to even, as torch.round and jnp.round do; every step
// is an explicitly rounded intrinsic (__fsub_rn, __fdiv_rn, __fadd_rn), so
// nvcc can neither contract nor turn a quotient into a reciprocal multiply.
// The 8 codes of K rows 8u .. 8u+7 go little-endian into the BITS bytes
// packed[(u*BITS + b), n] (repro_torch/core/packing.py, the layout
// common.cuh reads).  Outputs: packed (B, K/8*BITS, N) uint8, scale and zp
// (B, K/group, N) float32, all equal byte for byte to the plain version.
//
// What bounds it on an H100: the bytes, 4*K*N read plus K*N*BITS/8 +
// 8*N*K/g written a matrix, at 3.35 TB/s; the float work is a few
// operations an element.  So each weight is read from HBM once, with
// 16-byte loads along N, and the launch covers a whole stack of matrices
// (a layer's experts, a stack of layers): grid (N / columns a block,
// K / group, B).
//
// A block is 4 warps; a warp is 32 / LANES column quads x LANES row
// lanes (lane = row lane * quads + quad).  For a group of 64, 128 or 256
// rows (UPT = group / 64 units of 8 rows a row lane, 8 lanes: one load
// instruction reads 8 rows x 64 contiguous bytes, 64 columns a block) the
// thread keeps its UPT units' 8 x 4 weights in registers: it folds min and
// max over them, the row lanes fold theirs with xor shuffles (min and max
// are exact in any order), every lane then holds its columns' scale and
// zero point, and it codes and packs its units from registers, writing
// each packed byte row of its 4 columns as one 4-byte store (row lane 0
// writes scale and zp as 16-byte stores).  Any other group (g 8 .. 56, a
// K-wide g 0) takes UPT = 0 with 16 lanes (32 columns a block, twice the
// blocks for a long group): the row lanes stride through the group for
// min and max and read each unit again to pack it (on an H100 SXM, 16
// lanes ran slower than 8 at g 128 and faster at g 0).  N % 4 != 0 (or a
// pointer off 16 bytes) takes VEC = 1: one column a quad, 4-byte loads
// and byte stores.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4, THREADS = 32 * WARPS;

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// The codes of one unit (8 rows x VEC columns), packed: BITS byte rows of
// VEC bytes at packed[row + b][n ..].
template <int BITS, int VEC>
__device__ __forceinline__ void pack_unit(const float (&v)[8][VEC],
                                          const float (&sc)[VEC],
                                          const float (&z)[VEC],
                                          uint8_t* __restrict__ out,
                                          long long N) {
  const float levels = (float)((1 << BITS) - 1);
  uint64_t lane[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    lane[c] = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float q = fminf(
          fmaxf(__fadd_rn(rintf(__fdiv_rn(v[r][c], sc[c])), z[c]), 0.f),
          levels);
      lane[c] |= (uint64_t)(unsigned)q << (r * BITS);
    }
  }
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    if constexpr (VEC == 4) {
      const uint32_t word = (uint32_t)((lane[0] >> (8 * b)) & 0xFF) |
                            (uint32_t)((lane[1] >> (8 * b)) & 0xFF) << 8 |
                            (uint32_t)((lane[2] >> (8 * b)) & 0xFF) << 16 |
                            (uint32_t)((lane[3] >> (8 * b)) & 0xFF) << 24;
      *reinterpret_cast<uint32_t*>(out + b * N) = word;
    } else {
      out[b * N] = (uint8_t)(lane[0] >> (8 * b));
    }
  }
}

template <int BITS, int UPT, int VEC, int LANES>
__global__ void __launch_bounds__(THREADS)
quantize_pack_kernel(const float* __restrict__ w, uint8_t* __restrict__ packed,
                     float* __restrict__ scale, float* __restrict__ zp, int K,
                     int N, int group) {
  constexpr int QUADS = 32 / LANES;   // column groups (of VEC) a warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rl = lane / QUADS, quad = lane % QUADS;
  const int n = ((blockIdx.x * WARPS + warp) * QUADS + quad) * VEC;
  const int gi = blockIdx.y, units = group / 8;
  const long long groups = K / group;
  const long long mat = blockIdx.z;
  const float* wg = w + (mat * K + (long long)gi * group) * N + n;
  uint8_t* pg = packed + (mat * (K / 8) + (long long)gi * units) * BITS * N + n;
  const bool on = n < N;  // VEC 4: N % 4 == 0, so a quad is in or out
  const float inf = __int_as_float(0x7f800000);
  float mx[VEC], mn[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) { mx[c] = -inf; mn[c] = inf; }

  float v[UPT > 0 ? UPT : 1][8][VEC];  // the row lane's units (UPT > 0)
  if (on) {
    if constexpr (UPT > 0) {
#pragma unroll
      for (int i = 0; i < UPT; ++i)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          load_row<VEC>(wg + (long long)((rl * UPT + i) * 8 + r) * N, v[i][r]);
#pragma unroll
      for (int i = 0; i < UPT; ++i)
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            mx[c] = fmaxf(mx[c], v[i][r][c]);
            mn[c] = fminf(mn[c], v[i][r][c]);
          }
    } else {
#pragma unroll 4
      for (int k = rl; k < group; k += LANES) {
        float t[VEC];
        load_row<VEC>(wg + (long long)k * N, t);
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          mx[c] = fmaxf(mx[c], t[c]);
          mn[c] = fminf(mn[c], t[c]);
        }
      }
    }
  }
  // the row lanes of a quad: the lane bits above the quad's
#pragma unroll
  for (int o = QUADS; o < 32; o <<= 1)
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], o));
      mn[c] = fminf(mn[c], __shfl_xor_sync(0xffffffffu, mn[c], o));
    }
  if (!on) return;
  const float levels = (float)((1 << BITS) - 1);
  float sc[VEC], z[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    sc[c] = __fdiv_rn(fmaxf(__fsub_rn(mx[c], mn[c]), 1e-8f), levels);
    z[c] = rintf(__fdiv_rn(-mn[c], sc[c]));
  }
  if (rl == 0) {
    const long long o = (mat * groups + gi) * N + n;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(scale + o) = make_float4(sc[0], sc[1], sc[2], sc[3]);
      *reinterpret_cast<float4*>(zp + o) = make_float4(z[0], z[1], z[2], z[3]);
    } else {
      scale[o] = sc[0];
      zp[o] = z[0];
    }
  }
  if constexpr (UPT > 0) {
#pragma unroll
    for (int i = 0; i < UPT; ++i)
      pack_unit<BITS, VEC>(v[i], sc, z,
                           pg + (long long)(rl * UPT + i) * BITS * N, N);
  } else {
    for (int u = rl; u < units; u += LANES) {
      float t[8][VEC];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        load_row<VEC>(wg + (long long)(8 * u + r) * N, t[r]);
      pack_unit<BITS, VEC>(t, sc, z, pg + (long long)u * BITS * N, N);
    }
  }
}

template <int BITS, int UPT, int VEC, int LANES>
cudaError_t launch3(const float* w, uint8_t* packed, float* scale, float* zp,
                    int B, int K, int N, int group, cudaStream_t s) {
  constexpr int COLS = WARPS * (32 / LANES) * VEC;
  dim3 grid((N + COLS - 1) / COLS, K / group, B);
  quantize_pack_kernel<BITS, UPT, VEC, LANES><<<grid, THREADS, 0, s>>>(
      w, packed, scale, zp, K, N, group);
  return cudaGetLastError();
}

template <int BITS, int VEC>
cudaError_t launch2(const float* w, uint8_t* packed, float* scale, float* zp,
                    int B, int K, int N, int group, cudaStream_t s) {
  switch (group) {
    case 64: return launch3<BITS, 1, VEC, 8>(w, packed, scale, zp, B, K, N, group, s);
    case 128: return launch3<BITS, 2, VEC, 8>(w, packed, scale, zp, B, K, N, group, s);
    case 256: return launch3<BITS, 4, VEC, 8>(w, packed, scale, zp, B, K, N, group, s);
    default: return launch3<BITS, 0, VEC, 16>(w, packed, scale, zp, B, K, N, group, s);
  }
}

template <int BITS>
cudaError_t launch(const float* w, uint8_t* packed, float* scale, float* zp,
                   int B, int K, int N, int group, cudaStream_t s) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(zp) % 16 == 0;
  return vec ? launch2<BITS, 4>(w, packed, scale, zp, B, K, N, group, s)
             : launch2<BITS, 1>(w, packed, scale, zp, B, K, N, group, s);
}

}  // namespace

// w (B, K, N) -> packed (B, K/8*bits, N), scale and zp (B, K/group, N); one
// launch for the whole batch.
extern "C" int aq_quantize_pack(const float* w, uint8_t* packed, float* scale,
                                float* zp, int B, int K, int N, int bits,
                                int group, void* stream) {
  if (B == 0 || K == 0 || N == 0) return 0;
  if (group <= 0 || group % 8 != 0 || K % group != 0 || K / group > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return (int)launch<2>(w, packed, scale, zp, B, K, N, group, s);
    case 4: return (int)launch<4>(w, packed, scale, zp, B, K, N, group, s);
    case 8: return (int)launch<8>(w, packed, scale, zp, B, K, N, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
