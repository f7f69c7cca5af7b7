// Shared helpers of the two packed-weight matmul kernels.
//
// Packed layout (repro_torch/core/packing.py): the 8 codes of K rows
// 8u .. 8u+7 of column n sit little-endian in the BITS bytes
// packed[(u * BITS + b) * N + n], b = 0 .. BITS-1; code j occupies bits
// j*BITS .. j*BITS+BITS-1 of that 64-bit lane.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aq {

// The 64-bit lane holding the 8 codes of unit `u`, column `n`.
template <int BITS>
__device__ __forceinline__ uint64_t load_unit(const uint8_t* __restrict__ packed,
                                              long long u, int n, int N) {
  uint64_t lane = 0;
#pragma unroll
  for (int b = 0; b < BITS; ++b)
    lane |= (uint64_t)packed[(u * BITS + b) * (long long)N + n] << (8 * b);
  return lane;
}

template <int BITS>
__device__ __forceinline__ int unit_code(uint64_t lane, int j) {
  return (int)((lane >> (j * BITS)) & ((1u << BITS) - 1u));
}

}  // namespace aq
