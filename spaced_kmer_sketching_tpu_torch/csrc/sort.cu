// K4: batched lexicographic ascending sort of multi-word keys, K8: the
// same sort with alternating run directions, K5 / K10: merges of
// ascending runs, and K9: tile sorts cut to a share and merged (the
// second half of this file).
//
// K4 replaces spaced_kmer_sketching_tpu/ops/pallas/sort.py::bitonic_sort_128
// (kernels _sort_kernel, _tile_sort_kernel, _merge_round_kernel,
// _merge_finish_kernel), batched over genomes as the JAX finish's vmap
// does (ops/sketch.py:554).  Each of G rows of N keys (N a power of two,
// >= 1024; kw words, the highest most significant, all-ones sentinels
// last) is sorted by a bitonic network:
//   * tile_sort: one block sorts a 2048-key tile in shared memory through
//     every stage up to the tile size, alternating direction between
//     tiles so neighbours form bitonic sequences;
//   * for each larger stage k: one global pass per distance j >= 2048
//     (one thread per compare-exchange pair, in device memory), then
//     tile_merge finishes distances 1024..1 in shared memory.
// Tiles never cross rows (the tile divides N), and the direction of a
// pair is fixed by its row-local index, so all G rows sort in one launch
// per pass.
//
// What bounds it on an H100: bytes and launches.  N = 65,536 (the main
// path's size) takes 1 tile sort + 15 global passes + 5 tile merges, 21
// launches; each
// global pass reads and writes every key once (G * N * kw * 8 bytes, ~4 MB
// at G = 8, kw = 2, a few microseconds at 3.35 TB/s, so launch latency is
// of the same order).  The design keeps every pass whose pairs lie inside
// one tile in shared memory (121 of the 136 passes at N = 65,536, in 6
// launches) and leaves wgmma, TMA and radix variants to later work.
#include "common.cuh"

namespace sks {
namespace {

constexpr int SORT_THREADS = 1024;
constexpr int TILE = 2 * SORT_THREADS;   // keys per shared-memory tile
constexpr int PASS_THREADS = 256;
constexpr int64_t TRUNC_TILE = 32768;    // K9's tile (the JAX TILE_ELEMS)

template <int KW>
__device__ __forceinline__ void exchange_smem(uint32_t* sm, int tile, int i,
                                              int p, bool asc) {
  uint32_t a[KW], b[KW];
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    a[q] = sm[q * tile + i];
    b[q] = sm[q * tile + p];
  }
  if (asc ? lex_less<KW>(b, a) : lex_less<KW>(a, b)) {
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      sm[q * tile + i] = b[q];
      sm[q * tile + p] = a[q];
    }
  }
}

// Whether the run holding flat index i sorts descending: with alt > 0,
// the runs of n entries alternate ascending / descending within each
// segment of alt runs (K8); with alt == 0 every run ascends (K4).
__device__ __forceinline__ bool run_desc(int64_t i, int64_t n, int64_t alt) {
  return alt > 0 && (((i / n) % alt) & 1);
}

// Bitonic passes at distances j0, j0/2, ..., 1 of stage `k` on the tile
// in shared memory; local0 is the tile's first row-local index, and desc
// inverts every comparator (the whole tile lies in one run).
template <int KW>
__device__ void tile_passes(uint32_t* sm, int tile, int64_t local0,
                            int64_t k, int j0, bool desc) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int i = 2 * p - (p & (j - 1));
      const bool asc = (((local0 + i) & k) == 0) != desc;
      exchange_smem<KW>(sm, tile, i, i + j, asc);
    }
    __syncthreads();
  }
}

template <int KW>
__device__ void load_tile(uint32_t* sm, const uint32_t* src, int64_t total,
                          int tile) {
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
#pragma unroll
    for (int q = 0; q < KW; ++q) sm[q * tile + e] = src[q * total + e];
  }
  __syncthreads();
}

template <int KW>
__device__ void store_tile(const uint32_t* sm, uint32_t* dst, int64_t total,
                           int tile) {
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
#pragma unroll
    for (int q = 0; q < KW; ++q) dst[q * total + e] = sm[q * tile + e];
  }
}

template <int KW>
__global__ void __launch_bounds__(SORT_THREADS) tile_sort_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int64_t n, int64_t alt, int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile<KW>(sm, in + base, total, tile);
  const int64_t local0 = base & (n - 1);
  const bool desc = run_desc(base, n, alt);
  for (int k = 2; k <= tile; k <<= 1) {
    tile_passes<KW>(sm, tile, local0, k, k >> 1, desc);
  }
  store_tile<KW>(sm, out + base, total, tile);
}

template <int KW>
__global__ void __launch_bounds__(SORT_THREADS) tile_merge_kernel(
    uint32_t* __restrict__ data, int64_t total, int64_t n, int64_t alt,
    int64_t k, int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile<KW>(sm, data + base, total, tile);
  tile_passes<KW>(sm, tile, base & (n - 1), k, tile >> 1,
                  run_desc(base, n, alt));
  store_tile<KW>(sm, data + base, total, tile);
}

template <int KW>
__global__ void global_pass_kernel(uint32_t* __restrict__ data, int64_t total,
                                   int64_t n, int64_t alt, int64_t k,
                                   int64_t j) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total / 2) return;
  const int64_t i = 2 * p - (p & (j - 1));
  const int64_t partner = i + j;
  const bool asc = (((i & (n - 1)) & k) == 0) != run_desc(i, n, alt);
  uint32_t a[KW], b[KW];
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    a[q] = data[q * total + i];
    b[q] = data[q * total + partner];
  }
  if (asc ? lex_less<KW>(b, a) : lex_less<KW>(a, b)) {
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      data[q * total + i] = b[q];
      data[q * total + partner] = a[q];
    }
  }
}

// Sorts each of the g runs of n entries (n a power of two); alt as
// run_desc's.
template <int KW>
int sort_rows(const uint32_t* in, uint32_t* out, int64_t g, int64_t n,
              int64_t alt, cudaStream_t stream) {
  const int64_t total = g * n;
  const int tile = static_cast<int>(n < TILE ? n : TILE);
  const size_t smem = sizeof(uint32_t) * KW * tile;
  const unsigned tiles = static_cast<unsigned>(total / tile);
  tile_sort_kernel<KW><<<tiles, SORT_THREADS, smem, stream>>>(in, out, total,
                                                             n, alt, tile);
  int err = last_error();
  const unsigned pass_blocks =
      static_cast<unsigned>((total / 2 + PASS_THREADS - 1) / PASS_THREADS);
  for (int64_t k = 2 * static_cast<int64_t>(tile); k <= n && !err; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile && !err; j >>= 1) {
      global_pass_kernel<KW><<<pass_blocks, PASS_THREADS, 0, stream>>>(
          out, total, n, alt, k, j);
      err = last_error();
    }
    if (!err) {
      tile_merge_kernel<KW><<<tiles, SORT_THREADS, smem, stream>>>(
          out, total, n, alt, k, tile);
      err = last_error();
    }
  }
  return err;
}


// ---------------------------------------------------------------------------
// K5 merge_runs: replaces spaced_kmer_sketching_tpu/ops/pallas/sort.py::
// merge_sorted_runs (:477; kernels _merge_round_kernel via _merge_round
// :355/:379, _merge_finish_kernel via _merge_finish :337/:343, and the XLA
// passes _merge_pass_xla :391).  One stream of n = R * L entries (pw <= 5
// planes, word pw-1 most significant; n and L powers of two) whose R runs
// of L entries are each ascending becomes one ascending stream.
// K10 merge_pair: replaces sort.py::merge_pair_streams (:432; first pass
// fused XLA :452-456, the rest _merge_finish_kernel): two ascending
// streams of N entries become one of 2N.
//
// Both run the stages k = 2L .. n of a bitonic sort in its all-ascending
// form: a stage starts with a FLIP pass that pairs entry i of each k-block
// with its mirror k-1-i (so two ascending halves need no reversal), then
// half-cleaner passes at distances k/4 .. 1, all ascending.  The runs are
// never re-sorted: stages below 2L are skipped.  The TPU kernel reverses
// odd runs into bitonic pairs instead; the flip folds that reversal into
// the first pass's loads.  K10 is one stage (k = 2N) whose flip pass reads
// A[i] and B[N-1-i] from the two input buffers.
//
// What bounds them on an H100: bytes.  Every global pass reads and writes
// each entry once (n * pw * 8 bytes; 67 MB at config 2's n = 128 * 32,768,
// pw = 2, ~20 us at 3.35 TB/s).  As in K4, stages and distances whose
// pairs stay inside a 2,048-entry tile run in shared memory (one launch
// per stage for all distances below the tile); the rest are one launch
// per distance.  At config 2 that is 7 stages: 7 flip passes, 49 global
// half-cleaners and 7 tile finishes.  Index arithmetic is int64 (n reaches
// 2,048 * 32,768 = 67M entries).  Fusing several distances per pass in
// registers is later work.
//
// K8 sort_runs: replaces sort.py::sort_runs_128 (:220; kernels
// _multi_run_sort_kernel :189 and, for odd run layouts, _tile_sort :172).
// It is K4's network with every comparator of an odd run (by its index
// within the row) inverted, so odd runs come out descending; the finish
// fallback _finish_runs (ops/sketch.py) sorts G rows of nblocks runs in
// one launch.  K9 sort_truncate: replaces sort.py::sort_truncate_128
// (:249): K4's sort of every 32,768-entry tile, one pass that keeps each
// tile's capacity / t smallest entries, then K5's merge of those runs
// inside each row's capacity-entry segment.  What bounds both: bytes, as
// for K4 (each pass reads and writes every entry), and at the finish's
// small shapes launch latency.

// Half-cleaners at distances j0, j0/2, ..., 1 on the tile, ascending.
template <int KW>
__device__ void clean_smem(uint32_t* sm, int tile, int j0) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int i = 2 * p - (p & (j - 1));
      exchange_smem<KW>(sm, tile, i, i + j, true);
    }
    __syncthreads();
  }
}

// Stage k (k <= tile) on the tile: the flip pass, then the half-cleaners.
template <int KW>
__device__ void merge_stage_smem(uint32_t* sm, int tile, int k) {
  const int half = k >> 1;
  for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
    const int q = p & (half - 1);
    const int base = (p - q) * 2;
    exchange_smem<KW>(sm, tile, base + q, base + k - 1 - q, true);
  }
  __syncthreads();
  clean_smem<KW>(sm, tile, k >> 2);
}

// Stages k0 .. tile, whole inside each tile: reads in, writes out.
template <int KW>
__global__ void __launch_bounds__(SORT_THREADS) merge_tile_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int k0, int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile<KW>(sm, in + base, total, tile);
  for (int k = k0; k <= tile; k <<= 1) merge_stage_smem<KW>(sm, tile, k);
  store_tile<KW>(sm, out + base, total, tile);
}

// The half-cleaners j0 .. 1 of a stage, in place, one tile per block.
template <int KW>
__global__ void __launch_bounds__(SORT_THREADS) clean_tile_kernel(
    uint32_t* __restrict__ data, int64_t total, int j0, int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile<KW>(sm, data + base, total, tile);
  clean_smem<KW>(sm, tile, j0);
  store_tile<KW>(sm, data + base, total, tile);
}

template <int KW>
__device__ __forceinline__ void order_pair(const uint32_t* src_i,
                                           const uint32_t* src_p,
                                           int64_t src_plane, uint32_t* dst,
                                           int64_t dst_plane, int64_t i,
                                           int64_t p) {
  uint32_t a[KW], b[KW];
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    a[q] = src_i[q * src_plane];
    b[q] = src_p[q * src_plane];
  }
  const bool swap = lex_less<KW>(b, a);
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    dst[q * dst_plane + i] = swap ? b[q] : a[q];
    dst[q * dst_plane + p] = swap ? a[q] : b[q];
  }
}

// The flip pass of stage k over the whole stream; in may equal out (each
// thread reads its own pair before writing it).
template <int KW>
__global__ void flip_pass_kernel(const uint32_t* in, uint32_t* out,
                                 int64_t total, int64_t k) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total / 2) return;
  const int64_t half = k >> 1;
  const int64_t q = p & (half - 1);
  const int64_t base = (p - q) * 2;
  const int64_t i = base + q, partner = base + k - 1 - q;
  order_pair<KW>(in + i, in + partner, total, out, total, i, partner);
}

// A half-cleaner pass at distance j, in place.
template <int KW>
__global__ void clean_pass_kernel(uint32_t* data, int64_t total, int64_t j) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total / 2) return;
  const int64_t i = 2 * p - (p & (j - 1));
  order_pair<KW>(data + i, data + i + j, total, data, total, i, i + j);
}

// K10's flip pass: out[i] = min(A[i], B[N-1-i]), out[N+i] = the max.
template <int KW>
__global__ void pair_flip_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int64_t half) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= half) return;
  uint32_t x[KW], y[KW];
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    x[q] = a[q * half + p];
    y[q] = b[q * half + half - 1 - p];
  }
  const bool swap = lex_less<KW>(y, x);
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    out[q * 2 * half + p] = swap ? y[q] : x[q];
    out[q * 2 * half + half + p] = swap ? x[q] : y[q];
  }
}

inline unsigned pass_blocks(int64_t pairs) {
  return static_cast<unsigned>((pairs + PASS_THREADS - 1) / PASS_THREADS);
}

// The rest of stage k once its flip pass has run: global half-cleaners
// down to the tile size, then one tile launch for the distances below.
template <int KW>
int finish_stage(uint32_t* data, int64_t total, int64_t k, int tile,
                 cudaStream_t stream) {
  int err = 0;
  for (int64_t j = k >> 2; j >= tile && !err; j >>= 1) {
    clean_pass_kernel<KW><<<pass_blocks(total / 2), PASS_THREADS, 0, stream>>>(
        data, total, j);
    err = last_error();
  }
  if (err) return err;
  const int j0 = static_cast<int>(k / 4 < tile / 2 ? k / 4 : tile / 2);
  clean_tile_kernel<KW><<<static_cast<unsigned>(total / tile), SORT_THREADS,
                          sizeof(uint32_t) * KW * tile, stream>>>(
      data, total, j0, tile);
  return last_error();
}

// Merges the ascending runs of `run` entries inside each segment of seg
// entries (seg divides total): the stages k = 2 * run .. seg.
template <int KW>
int merge_runs(const uint32_t* in, uint32_t* out, int64_t total, int64_t run,
               int64_t seg, cudaStream_t stream) {
  const int tile = static_cast<int>(seg < TILE ? seg : TILE);
  int64_t k = 2 * run;
  const uint32_t* src = in;
  int err = 0;
  if (k <= tile) {
    merge_tile_kernel<KW><<<static_cast<unsigned>(total / tile), SORT_THREADS,
                            sizeof(uint32_t) * KW * tile, stream>>>(
        in, out, total, static_cast<int>(k), tile);
    err = last_error();
    src = out;
    k = 2 * static_cast<int64_t>(tile);
  }
  for (; k <= seg && !err; k <<= 1) {
    flip_pass_kernel<KW><<<pass_blocks(total / 2), PASS_THREADS, 0, stream>>>(
        src, out, total, k);
    err = last_error();
    src = out;
    if (!err) err = finish_stage<KW>(out, total, k, tile, stream);
  }
  return err;
}

template <int KW>
int merge_pair(const uint32_t* a, const uint32_t* b, uint32_t* out,
               int64_t half, cudaStream_t stream) {
  const int64_t total = 2 * half;
  const int tile = static_cast<int>(total < TILE ? total : TILE);
  pair_flip_kernel<KW><<<pass_blocks(half), PASS_THREADS, 0, stream>>>(
      a, b, out, half);
  const int err = last_error();
  return err ? err : finish_stage<KW>(out, total, total, tile, stream);
}

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// K9's cut: the first `cut` entries of each of `rows` sorted tiles of
// `tile` entries, packed one after another.
template <int KW>
__global__ void truncate_kernel(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out, int64_t rows,
                                int64_t tile, int64_t cut) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * cut) return;
  const int64_t src = e / cut * tile + e % cut;
#pragma unroll
  for (int q = 0; q < KW; ++q) out[q * rows * cut + e] = in[q * rows * tile + src];
}

template <int KW>
int sort_truncate(const uint32_t* in, uint32_t* sorted, uint32_t* cut_buf,
                  uint32_t* out, int g, int64_t m, int64_t capacity,
                  cudaStream_t stream) {
  const int64_t tiles = g * (m / TRUNC_TILE);
  const int64_t cut = capacity / (m / TRUNC_TILE);
  int err = sort_rows<KW>(in, sorted, tiles, TRUNC_TILE, 0, stream);
  if (err) return err;
  truncate_kernel<KW><<<pass_blocks(tiles * cut), PASS_THREADS, 0, stream>>>(
      sorted, cut_buf, tiles, TRUNC_TILE, cut);
  err = last_error();
  return err ? err : merge_runs<KW>(cut_buf, out, g * capacity, cut, capacity,
                                    stream);
}

}  // namespace
}  // namespace sks

// in, out (kw, g, n) u32, n a power of two >= 1024; out may not alias in.
extern "C" int sks_sort_rows(const void* in, void* out, int kw, int g,
                             int64_t n, void* stream) {
  if (g <= 0 || n < 1024 || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return sks::sort_rows<1>(i, o, g, n, 0, s);
    case 2: return sks::sort_rows<2>(i, o, g, n, 0, s);
    case 3: return sks::sort_rows<3>(i, o, g, n, 0, s);
    case 4: return sks::sort_rows<4>(i, o, g, n, 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5: in, out (pw, n) u32, the runs of `run` entries ascending; each
// segment of seg entries is merged into one ascending run.  run and seg
// powers of two, 2 * run <= seg, seg divides n.  out may not alias in.
extern "C" int sks_merge_runs(const void* in, void* out, int pw, int64_t n,
                              int64_t run, int64_t seg, void* stream) {
  if (!sks::pow2(seg) || !sks::pow2(run) || 2 * run > seg || n % seg != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return sks::merge_runs<1>(i, o, n, run, seg, s);
    case 2: return sks::merge_runs<2>(i, o, n, run, seg, s);
    case 3: return sks::merge_runs<3>(i, o, n, run, seg, s);
    case 4: return sks::merge_runs<4>(i, o, n, run, seg, s);
    case 5: return sks::merge_runs<5>(i, o, n, run, seg, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K10: a, b (pw, half) u32 ascending, half a power of two -> out
// (pw, 2 * half) ascending.  out may not alias a or b.
extern "C" int sks_merge_pair(const void* a, const void* b, void* out, int pw,
                              int64_t half, void* stream) {
  if (!sks::pow2(half)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return sks::merge_pair<1>(x, y, o, half, s);
    case 2: return sks::merge_pair<2>(x, y, o, half, s);
    case 3: return sks::merge_pair<3>(x, y, o, half, s);
    case 4: return sks::merge_pair<4>(x, y, o, half, s);
    case 5: return sks::merge_pair<5>(x, y, o, half, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8: in, out (kw, g, m) u32; each row's runs of `run` entries (a power of
// two >= 128 dividing m) sorted independently, run i of the row ascending
// if i is even and descending if odd.  out may not alias in.
extern "C" int sks_sort_runs(const void* in, void* out, int kw, int g,
                             int64_t m, int64_t run, void* stream) {
  if (g <= 0 || run < 128 || !sks::pow2(run) || m % run != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t runs = g * (m / run);
  switch (kw) {
    case 1: return sks::sort_rows<1>(i, o, runs, run, m / run, s);
    case 2: return sks::sort_rows<2>(i, o, runs, run, m / run, s);
    case 3: return sks::sort_rows<3>(i, o, runs, run, m / run, s);
    case 4: return sks::sort_rows<4>(i, o, runs, run, m / run, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9: in (kw, g, m) u32, m = t * 32768 with t >= 2 a power of two;
// out (kw, g, capacity) u32: per row, the capacity / t smallest entries of
// each 32,768-entry tile, merged ascending (capacity / t a power of two
// >= 128).  Scratch: sorted (kw, g, m), cut (kw, g, capacity).
extern "C" int sks_sort_truncate(const void* in, void* sorted, void* cut,
                                 void* out, int kw, int g, int64_t m,
                                 int64_t capacity, void* stream) {
  const int64_t t = m / sks::TRUNC_TILE;
  if (g <= 0 || m % sks::TRUNC_TILE != 0 || t < 2 || !sks::pow2(t) ||
      capacity % t != 0 || capacity / t < 128 || !sks::pow2(capacity / t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* so = static_cast<uint32_t*>(sorted);
  auto* c = static_cast<uint32_t*>(cut);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return sks::sort_truncate<1>(i, so, c, o, g, m, capacity, s);
    case 2: return sks::sort_truncate<2>(i, so, c, o, g, m, capacity, s);
    case 3: return sks::sort_truncate<3>(i, so, c, o, g, m, capacity, s);
    case 4: return sks::sort_truncate<4>(i, so, c, o, g, m, capacity, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
