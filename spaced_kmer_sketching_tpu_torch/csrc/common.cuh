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

// Block-wide exclusive scan over ballots, in two calls.  A block's slots
// are s = j * blockDim.x + warp * 32 + lane, so group (j, warp) holds 32
// consecutive slots and the groups' order is the slots' order.  Each warp
// publishes the ballot of each group it holds (scan_publish); scan_groups
// then turns the `groups` counts of wsum (groups <= 128) into exclusive
// offsets and returns the total, and a slot's offset is wsum[group] +
// __popc(ballot & lanes below it).  wsum holds groups + 1 ints; both
// __syncthreads() are inside scan_groups, and the caller syncs once more
// before publishing into wsum again.
__device__ __forceinline__ void scan_publish(int group, unsigned ballot,
                                             int* wsum) {
  if ((threadIdx.x & 31) == 0) wsum[group] = __popc(ballot);
}

__device__ __forceinline__ int scan_groups(int groups, int* wsum) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int v[4], s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = lane * 4 + k;
      v[k] = g < groups ? wsum[g] : 0;
      s += v[k];
    }
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = lane * 4 + k;
      if (g < groups) wsum[g] = run;
      run += v[k];
    }
    if (lane == 31) wsum[groups] = incl;
  }
  __syncthreads();
  return wsum[groups];
}

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
