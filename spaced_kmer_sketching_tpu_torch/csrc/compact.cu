// K2 and K3: order-preserving compaction of sentinel-holed key planes.
//
// K2 compact_rows replaces spaced_kmer_sketching_tpu/ops/pallas/compact.py::
// _compact_rows_kernel (entry compact_rows): each 128-slot row moves its
// valid entries to the front, in order, keeps the first k_out, fills the
// rest with all-ones, and optionally reports min(valid, k_out) per row.
// K3 compact_global replaces compact.py::_compact_global_kernel (entry
// compact_global): valid entries of a whole (G, n) row move to the front in
// order, followed by the sentinel tail.  The JAX kernel stops at 1024 rows
// of 128 (scoped VMEM) and falls back to XLA; this kernel takes any n.
//
// What bounds them on an H100: bytes.  Both read kw words per slot once and
// write each valid word once, with a handful of integer operations per
// slot.  K2 is one warp per row (four coalesced 128-byte loads per word
// plane, four __ballot_sync for the ranks), so it runs at the copy rate.
// K3 is a block-wide scan per genome (one block of 1024 threads walks the
// row in 1024-slot steps, carrying the running offset), which keeps the
// code a single launch with no scratch but uses only G of the 132 SMs:
// at the main path's n = 65,536-131,072 it is bounded by the serial step
// count (~100 steps of two __syncthreads), not by bandwidth.  A multi-block
// decoupled look-back scan is the next step if K3 shows in the profile.
#include "common.cuh"

namespace sks {
namespace {

constexpr int ROWS_PER_BLOCK = 8;      // warps per block in K2
constexpr int GLOBAL_THREADS = 1024;   // threads per genome in K3

template <int KW>
__global__ void compact_rows_kernel(const uint32_t* __restrict__ in,
                                    int64_t nrows, int k_out,
                                    uint32_t* __restrict__ out,
                                    int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= nrows) return;            // whole warps only
  const int64_t in_plane = nrows * LANES;
  const int64_t out_plane = nrows * k_out;
  const uint32_t* src = in + row * LANES;
  uint32_t* dst = out + row * k_out;

  uint32_t v[4][KW];
  unsigned bal[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bool valid = false;
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      v[j][q] = src[q * in_plane + j * 32 + lane];
      valid |= v[j][q] != SENT;
    }
    bal[j] = __ballot_sync(FULL, valid);
  }
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rank = base + __popc(bal[j] & below);
    if (((bal[j] >> lane) & 1u) && rank < k_out) {
#pragma unroll
      for (int q = 0; q < KW; ++q) dst[q * out_plane + rank] = v[j][q];
    }
    base += __popc(bal[j]);
  }
  const int filled = min(base, k_out);
  for (int s = filled + lane; s < k_out; s += 32) {
#pragma unroll
    for (int q = 0; q < KW; ++q) dst[q * out_plane + s] = SENT;
  }
  if (counts != nullptr && lane == 0) counts[row] = filled;
}

template <int KW>
__global__ void __launch_bounds__(GLOBAL_THREADS) compact_global_kernel(
    const uint32_t* __restrict__ in, int64_t n, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t plane = static_cast<int64_t>(gridDim.x) * n;
  const uint32_t* src = in + static_cast<int64_t>(blockIdx.x) * n;
  uint32_t* dst = out + static_cast<int64_t>(blockIdx.x) * n;
  __shared__ int wsum[GLOBAL_THREADS / 32];
  const unsigned below = (1u << lane) - 1u;

  int64_t offset = 0;                  // valid entries written so far
  for (int64_t step = 0; step < n; step += GLOBAL_THREADS) {
    const int64_t i = step + threadIdx.x;
    uint32_t v[KW];
    bool valid = false;
    if (i < n) {
#pragma unroll
      for (int q = 0; q < KW; ++q) {
        v[q] = src[q * plane + i];
        valid |= v[q] != SENT;
      }
    }
    const unsigned bal = __ballot_sync(FULL, valid);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < GLOBAL_THREADS / 32; ++w) {
      const int c = wsum[w];
      before += (w < warp) ? c : 0;
      all += c;
    }
    if (valid) {
      const int64_t pos = offset + before + __popc(bal & below);
#pragma unroll
      for (int q = 0; q < KW; ++q) dst[q * plane + pos] = v[q];
    }
    offset += all;
    __syncthreads();                   // wsum is rewritten next step
  }
  for (int64_t i = offset + threadIdx.x; i < n; i += GLOBAL_THREADS) {
#pragma unroll
    for (int q = 0; q < KW; ++q) dst[q * plane + i] = SENT;
  }
}

template <int KW>
void launch_rows(const uint32_t* in, int64_t nrows, int k_out, uint32_t* out,
                 int32_t* counts, cudaStream_t stream) {
  const int64_t blocks = (nrows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  compact_rows_kernel<KW><<<static_cast<unsigned>(blocks),
                            ROWS_PER_BLOCK * 32, 0, stream>>>(
      in, nrows, k_out, out, counts);
}

template <int KW>
void launch_global(const uint32_t* in, int g, int64_t n, uint32_t* out,
                   cudaStream_t stream) {
  compact_global_kernel<KW><<<g, GLOBAL_THREADS, 0, stream>>>(in, n, out);
}

}  // namespace
}  // namespace sks

// in (kw, nrows, 128) u32 -> out (kw, nrows, k_out) u32; counts (nrows,)
// i32 or null.
extern "C" int sks_compact_rows(const void* in, int kw, int64_t nrows,
                                int k_out, void* out, void* counts,
                                void* stream) {
  if (nrows <= 0 || k_out < 1 || k_out > sks::LANES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto* c = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: sks::launch_rows<1>(i, nrows, k_out, o, c, s); break;
    case 2: sks::launch_rows<2>(i, nrows, k_out, o, c, s); break;
    case 3: sks::launch_rows<3>(i, nrows, k_out, o, c, s); break;
    case 4: sks::launch_rows<4>(i, nrows, k_out, o, c, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return sks::last_error();
}

// in, out (kw, g, n) u32.
extern "C" int sks_compact_global(const void* in, int kw, int g, int64_t n,
                                  void* out, void* stream) {
  if (g <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: sks::launch_global<1>(i, g, n, o, s); break;
    case 2: sks::launch_global<2>(i, g, n, o, s); break;
    case 3: sks::launch_global<3>(i, g, n, o, s); break;
    case 4: sks::launch_global<4>(i, g, n, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return sks::last_error();
}
