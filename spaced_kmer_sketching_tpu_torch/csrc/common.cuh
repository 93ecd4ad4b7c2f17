// Shared definitions of the port's Hopper kernels.
//
// Keys are 128-bit values held as `kw` (1..4) planes of uint32 words,
// little-endian: word 0 holds bits 0-31.  A stacked operand of shape
// (kw, rows, width) is one contiguous buffer whose plane q starts at
// q * rows * width.  The all-ones value in every carried word is the
// sentinel: a canonical masked key is never all-ones (both strands would
// have to be all-ones under the mask, i.e. the window all-T forward AND
// all-A, which is impossible; ops/pallas/compact.py:14-21 of the JAX
// package), so "valid" means "not all-ones in the carried words".
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sks {

constexpr uint32_t SENT = 0xFFFFFFFFu;
constexpr int LANES = 128;        // windows (or slots) per candidate row
constexpr unsigned FULL = 0xFFFFFFFFu;

// First launch error since the last call, as the int every C entry returns.
inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// Lexicographic a < b over KW words, the highest word most significant.
template <int KW>
__device__ __forceinline__ bool lex_less(const uint32_t (&a)[KW],
                                         const uint32_t (&b)[KW]) {
#pragma unroll
  for (int q = KW - 1; q > 0; --q) {
    if (a[q] != b[q]) return a[q] < b[q];
  }
  return a[0] < b[0];
}

}  // namespace sks
