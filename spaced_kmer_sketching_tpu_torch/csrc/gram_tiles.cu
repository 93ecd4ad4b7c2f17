// K6: exact all-pairs Gram of a sorted packed (key, gid) stream.
//
// Replaces spaced_kmer_sketching_tpu/ops/pallas/gram_tiles.py::
// gram_tile_scan_fused (:275; body _scan_kernel :128) and, above the
// fused kernel's gp <= 1024 gate, the XLA scan ops/gram._gram_chunks_packed
// (gram.py:56-70).  The stream holds pw (<= 5) u32 planes of
// (key << gidbits) | gid (ops/gram._pack_gid_planes), ascending, with the
// sentinels (guard bit 31 of word pw-1 set) at the back.  Output entry
// (a, b) counts the keys shared by genomes a and b; the diagonal holds the
// sketch sizes.  Full mode fills (gp, gp); split mode fills only rows
// < split and columns >= split, as an (split, gp - split) block.
//
// Equal keys are contiguous and every run holds each gid at most once,
// in ascending gid order, so the count for (a, b) is the number of runs
// that contain both.  The TPU kernel sees 128 lanes per grid step and so
// carries open runs across chunks (the eql/eqp flags and the P carry);
// here no chunking exists.  A grid of (128 x 128 gid output tile) x
// (segment of the stream) blocks: each block keeps its tile as int32 in
// 64 KB of dynamic shared memory, takes the runs that START in its
// segment (a run start is a valid entry whose key, word 0's low gidbits
// masked, differs from the previous entry's), walks each such run to its
// end, finds the entries whose gids fall in the tile's row and column
// ranges, and adds 1 for every such (row, column) pair.  Segments split
// runs only at their starts, so each run is counted once per tile; at
// the end each block atomicAdds its nonzero cells into the int32 result.
// Integer atomics are order-free, so the result is bit-exact.  In full
// mode only tiles on or above the diagonal run, and off-diagonal tiles
// also add into their mirror.
//
// What bounds it on an H100: shared-memory atomics.  The work is the sum
// over runs of (entries in the row range) x (entries in the column range)
// per tile -- in all, the sum of the output matrix, dense for related
// genomes -- plus one read of the stream per tile row-and-column pair.
// The run walk is one thread per run, so a key held by every genome
// serialises its run on one thread.  The int8 tensor-core form (sum over
// runs of H^T H on run multi-hots) is later work.
#include "common.cuh"

namespace sks {
namespace {

constexpr int GT = 128;                      // gids per output tile side
constexpr int GRAM_THREADS = 256;
constexpr int GRAM_SMEM = GT * GT * sizeof(int32_t);    // 64 KB

template <int PW>
__device__ __forceinline__ void load_key(const uint32_t* sw, int64_t n,
                                         int64_t i, uint32_t gmask,
                                         uint32_t (&k)[PW]) {
#pragma unroll
  for (int q = 0; q < PW; ++q) k[q] = sw[q * n + i];
  k[0] &= ~gmask;
}

template <int PW>
__device__ __forceinline__ bool same_key(const uint32_t (&a)[PW],
                                         const uint32_t (&b)[PW]) {
  bool eq = true;
#pragma unroll
  for (int q = 0; q < PW; ++q) eq &= a[q] == b[q];
  return eq;
}

template <int PW>
__global__ void __launch_bounds__(GRAM_THREADS) gram_tile_kernel(
    const uint32_t* __restrict__ sw, int64_t n, int gidbits, int col_tiles,
    int c0, int ncols, int64_t seg, int sym, int32_t* __restrict__ out) {
  extern __shared__ int32_t acc[];
  const int tr = blockIdx.y / col_tiles;
  const int tc = blockIdx.y % col_tiles;
  if (sym && tr > tc) return;
  const uint32_t r0 = tr * GT;                // first row gid
  const uint32_t cg0 = c0 + tc * GT;          // first column gid
  const uint32_t top = (r0 > cg0 ? r0 : cg0) + GT;   // past both ranges
  const uint32_t gmask = (1u << gidbits) - 1u;
  for (int e = threadIdx.x; e < GT * GT; e += blockDim.x) acc[e] = 0;
  __syncthreads();

  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * seg;
  const int64_t s1 = s0 + seg < n ? s0 + seg : n;
  for (int64_t i = s0 + threadIdx.x; i < s1; i += blockDim.x) {
    if (sw[(PW - 1) * n + i] >> 31) continue;          // sentinel
    uint32_t key[PW];
    load_key<PW>(sw, n, i, gmask, key);
    if (i > 0) {
      uint32_t prev[PW];
      load_key<PW>(sw, n, i - 1, gmask, prev);
      if (same_key<PW>(prev, key)) continue;            // not a run start
    }
    // i starts a run: its entries with gids in the row range are
    // [a0, a1), those in the column range [b0, b1) (gids ascend).  A
    // sentinel never matches a valid key (its guard bit differs).
    int64_t a0 = -1, a1 = -1, b0 = -1, b1 = -1;
    for (int64_t j = i; j < n; ++j) {
      uint32_t kj[PW];
      load_key<PW>(sw, n, j, gmask, kj);
      if (!same_key<PW>(kj, key)) break;
      const uint32_t g = sw[j] & gmask;
      if (g >= top) break;
      if (g >= r0 && g < r0 + GT) {
        if (a0 < 0) a0 = j;
        a1 = j + 1;
      }
      if (g >= cg0 && g < cg0 + GT) {
        if (b0 < 0) b0 = j;
        b1 = j + 1;
      }
    }
    if (a0 < 0 || b0 < 0) continue;
    for (int64_t a = a0; a < a1; ++a) {
      int32_t* row = acc + ((sw[a] & gmask) - r0) * GT;
      for (int64_t b = b0; b < b1; ++b) {
        atomicAdd(row + ((sw[b] & gmask) - cg0), 1);
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < GT * GT; e += blockDim.x) {
    const int32_t v = acc[e];
    if (v == 0) continue;
    const int64_t a = r0 + e / GT;
    const int64_t b = cg0 + e % GT;
    atomicAdd(out + a * ncols + (b - c0), v);
    if (sym && tr != tc) atomicAdd(out + b * ncols + a, v);
  }
}

// Full mode (split == 0): (gp / 128)^2 tiles, those below the diagonal
// return at once; split mode: rows < split, columns >= split.
template <int PW>
int gram_tiles(const uint32_t* sw, int64_t n, int gidbits, int gp, int split,
               int64_t seg, int32_t* out, cudaStream_t stream) {
  const int sym = split == 0;
  const int row_tiles = (sym ? gp : split) / GT;
  const int col_tiles = (gp - split) / GT;
  auto kern = gram_tile_kernel<PW>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GRAM_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((n + seg - 1) / seg),
                  static_cast<unsigned>(row_tiles * col_tiles));
  kern<<<grid, GRAM_THREADS, GRAM_SMEM, stream>>>(
      sw, n, gidbits, col_tiles, split, gp - split, seg, sym, out);
  return last_error();
}

}  // namespace
}  // namespace sks

// sw (pw, n) u32 sorted packed stream; out int32, zeroed by the caller:
// (gp, gp) when split == 0, else (split, gp - split).  gp and split are
// multiples of 128; every gid is < gp; seg entries per block.
extern "C" int sks_gram_tiles(const void* sw, int pw, int64_t n, int gidbits,
                              int gp, int split, int64_t seg, void* out,
                              void* stream) {
  if (n <= 0 || seg <= 0 || gidbits < 1 || gidbits > 31 || gp <= 0 ||
      gp % sks::GT != 0 || split < 0 || split >= gp ||
      split % sks::GT != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w = static_cast<const uint32_t*>(sw);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return sks::gram_tiles<1>(w, n, gidbits, gp, split, seg, o, s);
    case 2: return sks::gram_tiles<2>(w, n, gidbits, gp, split, seg, o, s);
    case 3: return sks::gram_tiles<3>(w, n, gidbits, gp, split, seg, o, s);
    case 4: return sks::gram_tiles<4>(w, n, gidbits, gp, split, seg, o, s);
    case 5: return sks::gram_tiles<5>(w, n, gidbits, gp, split, seg, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
