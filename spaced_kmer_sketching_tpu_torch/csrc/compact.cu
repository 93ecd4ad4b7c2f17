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
// K3 spreads every row over many blocks, so that every SM takes part at
// any G: a row is cut into tiles of 2,048 slots, one block a tile, in three
// launches.  The first counts each tile's valid slots (warp sums) into
// a scratch array; the second, one block a row, turns a row's counts
// into exclusive offsets in place and its total beside them (a block scan
// a round of 1,024 tiles); the third reads its tile again, ranks its valid
// slots by ballots and one block scan, writes them at offset + rank, and
// writes the sentinels of its own output range past the row's total.  Only
// the offset scan is serial in the row length, one round for every
// 2,097,152 slots of a row; the second read of the input and the count
// array are the price of the order.
#include "common.cuh"

namespace sks {
namespace {

constexpr int ROWS_PER_BLOCK = 8;      // warps per block in K2
constexpr int SCAN_THREADS = 256;      // K3
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_PER = 8;            // slots a thread
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_PER;   // 2,048 slots a block
constexpr int OFFSET_THREADS = 1024;   // K3's offset scan, one block a row

// K3's tiles a row of n slots.
__host__ __device__ inline int64_t global_tiles(int64_t n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

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
__device__ __forceinline__ bool slot_valid(const uint32_t* src, int64_t plane,
                                           int64_t s) {
  bool valid = false;
#pragma unroll
  for (int q = 0; q < KW; ++q) valid |= src[q * plane + s] != SENT;
  return valid;
}

// K3, launch 1: counts[row * tiles + tile] = valid slots of the tile.
template <int KW>
__global__ void __launch_bounds__(SCAN_THREADS) compact_count_kernel(
    const uint32_t* __restrict__ in, int64_t n,
    int32_t* __restrict__ counts) {
  const int64_t plane = static_cast<int64_t>(gridDim.y) * n;
  const uint32_t* src = in + static_cast<int64_t>(blockIdx.y) * n;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * SCAN_TILE;
  int c = 0;
#pragma unroll
  for (int j = 0; j < SCAN_PER; ++j) {
    const int64_t s = t0 + j * SCAN_THREADS + threadIdx.x;
    c += s < n && slot_valid<KW>(src, plane, s);
  }
  __shared__ int red[SCAN_WARPS];
  c = __reduce_add_sync(FULL, c);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < SCAN_WARPS; ++w) sum += red[w];
    counts[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] = sum;
  }
}

// K3, launch 2, one block a row: the row's tile counts become exclusive
// offsets in place, and totals[row] their sum.
__global__ void __launch_bounds__(OFFSET_THREADS) compact_offset_kernel(
    int32_t* __restrict__ counts, int64_t tiles,
    int32_t* __restrict__ totals) {
  __shared__ int wsum[OFFSET_THREADS / 32 + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  int base = 0;
  for (int64_t t0 = 0; t0 < tiles; t0 += OFFSET_THREADS) {
    const int64_t t = t0 + threadIdx.x;
    const int c = t < tiles ? row[t] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = wsum[lane];
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += y;
      }
      wsum[lane] = wi - w;
      if (lane == 31) wsum[32] = wi;
    }
    __syncthreads();
    if (t < tiles) row[t] = base + wsum[warp] + incl - c;
    base += wsum[32];
    __syncthreads();                  // wsum is written again
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = base;
}

// K3, launch 3: the tile's valid slots at the tile's offset, in order, and
// the sentinels of the tile's output range past the row's total.
template <int KW>
__global__ void __launch_bounds__(SCAN_THREADS) compact_scatter_kernel(
    const uint32_t* __restrict__ in, int64_t n,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ totals,
    uint32_t* __restrict__ out) {
  __shared__ int wsum[SCAN_WARPS * SCAN_PER + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t plane = static_cast<int64_t>(gridDim.y) * n;
  const uint32_t* src = in + static_cast<int64_t>(blockIdx.y) * n;
  uint32_t* dst = out + static_cast<int64_t>(blockIdx.y) * n;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * SCAN_TILE;
  const int64_t t1 = t0 + SCAN_TILE < n ? t0 + SCAN_TILE : n;
  const int64_t offset =
      offsets[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x];
  const int64_t total = totals[blockIdx.y];

  uint32_t v[SCAN_PER][KW];
  unsigned valid = 0;                 // bit j: slot j is valid
#pragma unroll
  for (int j = 0; j < SCAN_PER; ++j) {
    const int64_t s = t0 + j * SCAN_THREADS + threadIdx.x;
    bool ok = false;
    if (s < t1) {
#pragma unroll
      for (int q = 0; q < KW; ++q) {
        v[j][q] = src[q * plane + s];
        ok |= v[j][q] != SENT;
      }
    }
    valid |= static_cast<unsigned>(ok) << j;
    scan_publish(j * SCAN_WARPS + warp, __ballot_sync(FULL, ok), wsum);
  }
  scan_groups(SCAN_WARPS * SCAN_PER, wsum);
#pragma unroll
  for (int j = 0; j < SCAN_PER; ++j) {
    const unsigned bal = __ballot_sync(FULL, valid >> j & 1);
    if (valid >> j & 1) {
      const int64_t pos = offset + wsum[j * SCAN_WARPS + warp] +
                          __popc(bal & below);
#pragma unroll
      for (int q = 0; q < KW; ++q) dst[q * plane + pos] = v[j][q];
    }
  }
  for (int64_t s = (total > t0 ? total : t0) + threadIdx.x; s < t1;
       s += SCAN_THREADS) {
#pragma unroll
    for (int q = 0; q < KW; ++q) dst[q * plane + s] = SENT;
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
int launch_global(const uint32_t* in, int g, int64_t n, int32_t* scratch,
                  uint32_t* out, cudaStream_t stream) {
  const int64_t tiles = global_tiles(n);
  int32_t* totals = scratch + g * tiles;
  const dim3 grid(static_cast<unsigned>(tiles), g);
  compact_count_kernel<KW><<<grid, SCAN_THREADS, 0, stream>>>(in, n, scratch);
  int err = last_error();
  if (err != 0) return err;
  compact_offset_kernel<<<g, OFFSET_THREADS, 0, stream>>>(scratch, tiles,
                                                          totals);
  err = last_error();
  if (err != 0) return err;
  compact_scatter_kernel<KW><<<grid, SCAN_THREADS, 0, stream>>>(
      in, n, scratch, totals, out);
  return last_error();
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

// int32 elements of K3's scratch for g rows of n slots: the tile counts
// (g, ceil(n / 2,048)), then the g row totals.
extern "C" int64_t sks_compact_global_scratch(int g, int64_t n) {
  return static_cast<int64_t>(g) * (sks::global_tiles(n) + 1);
}

// in, out (kw, g, n) u32; scratch sks_compact_global_scratch(g, n) int32.
extern "C" int sks_compact_global(const void* in, int kw, int g, int64_t n,
                                  void* scratch, void* out, void* stream) {
  if (g <= 0 || g > 65535 || n <= 0 || sks::global_tiles(n) > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* c = static_cast<int32_t*>(scratch);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return sks::launch_global<1>(i, g, n, c, o, s);
    case 2: return sks::launch_global<2>(i, g, n, c, o, s);
    case 3: return sks::launch_global<3>(i, g, n, c, o, s);
    case 4: return sks::launch_global<4>(i, g, n, c, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
