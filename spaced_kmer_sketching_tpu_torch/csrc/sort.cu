// K4: batched lexicographic ascending sort of multi-word keys (a register
// tile sort, then K5's merge levels), K8: the same sort with alternating
// run directions (a bitonic network), K5 / K10: merge-path merges of
// ascending runs, and K9: tile sorts cut to a share and merged by K5 (the
// second half of this file).
//
// K4 replaces spaced_kmer_sketching_tpu/ops/pallas/sort.py::bitonic_sort_128
// (kernels _sort_kernel, _tile_sort_kernel, _merge_round_kernel,
// _merge_finish_kernel), batched over genomes as the JAX finish's vmap
// does (ops/sketch.py:554).  Each of G rows of N keys (N a power of two,
// >= 1024; kw words, the highest most significant, all-ones sentinels
// last) is sorted in two steps:
//   * reg_tile_sort: one CTA of up to 1,024 threads sorts a tile of T
//     keys (16,384 at kw <= 2, 8,192 at kw 3-4: one 132 KB buffer in
//     shared memory; the whole row when N < T; T / 4 when tiles of T
//     would leave more than half the SMs idle, sort_tile).  Each thread
//     loads E keys (16 at kw <= 2, 8 at kw 3-4) into registers and sorts
//     them with a fully unrolled bitonic network whose indices are
//     compile-time constants; then the block merges its threads' runs by
//     merge path, log2(threads) levels, each thread finding its diagonal
//     and merging its E outputs in registers between two barriers;
//   * a row of N > T then takes K5's merge levels (merge_level, launched
//     as sort_level_kernel so that a profile tells K4 from K5), log2(N / T)
//     launches alternating between out and a scratch buffer the caller
//     gives.
// So N = 65,536 at G = 2 (the timed shape, quarter tiles) takes 5
// launches at kw <= 2 where the bitonic network took 21, and a full grid of
// rows of N <= T (phase 8(b)'s 128 x 16,384) one.
//
// What bounds it on an H100: the work inside one CTA a tile, not bytes.
// A sort of G = 2 rows of 65,536 two-word keys moves 2.1 MB (0.6 us at
// 3.35 TB/s); the bitonic network spent ~0.1 ms on it in 21 launches, 66
// shared-memory passes a tile each ending in a block barrier.  The
// register network compares without barriers and a merge level costs one
// barrier pair for E outputs a thread, but each of the ten in-block
// levels still issues ~35 instructions and ~2 scattered shared-memory
// reads a key (the diagonal search, the serial merge), so one 16,384-key
// tile takes ~60 us in its CTA.  On an H100 80GB HBM3 at 700 W: phase
// 8(b)'s 128 x 16,384 (128 CTAs) 0.066 ms a call on the device, ~9 ms
// over its 119 calls, from ~34; the timed shape 0.072 ms with 8 tiles of
// 16,384 (8 SMs busy) and 0.044 with 32 quarter tiles and four K5 levels,
// which sort_tile therefore picks (PERF.md).
#include "common.cuh"

namespace sks {
namespace {

// K8's bitonic network (alt > 0 below; see K8's note further down):
//   * tile_sort: one block sorts a 2048-key tile in shared memory through
//     every stage up to the tile size;
//   * for each larger stage k: one global pass per distance j >= 2048 (one
//     thread per compare-exchange pair, in device memory), then tile_merge
//     finishes distances 1024..1 in shared memory.
// Tiles never cross runs (the tile divides the run), and the direction of
// a pair is fixed by its index, so all runs sort in one launch per pass.
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

// Whether the run holding flat index i sorts descending: the runs of n
// entries alternate ascending / descending within each segment of alt
// runs (K8; alt == 1, or 0, makes every run ascend).
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

// K8: sorts each of the g runs of n entries (n a power of two) by the
// bitonic network; alt as run_desc's.
template <int KW>
int bitonic_sort_runs(const uint32_t* in, uint32_t* out, int64_t g, int64_t n,
                      int64_t alt, cudaStream_t stream) {
  const int64_t total = g * n;
  const int tile = static_cast<int>(n < TILE ? n : TILE);
  const size_t smem = sizeof(uint32_t) * KW * tile;
  const unsigned tiles = static_cast<unsigned>(total / tile);
  tile_sort_kernel<KW><<<tiles, SORT_THREADS, smem, stream>>>(
      in, out, total, n, alt, tile);
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
// of L entries are each ascending becomes one ascending stream, or one per
// segment of seg entries.
// K10 merge_pair: replaces sort.py::merge_pair_streams (:432; first pass
// fused XLA :452-456, the rest _merge_finish_kernel): two ascending
// streams of N entries become one of 2N, stream B's valid gids shifted by
// an offset on the way in (the JAX package's gram.py:704-706 fuses the
// same shift into its first pass).
//
// Both are merge paths.  The primitive (merge_path_tile) writes the
// outputs [d0, d0 + tile) of merge(A, B), tile <= 2,048, from one CTA of
// 256 threads:
//   * CTA split: warps 0 and 1 find where the diagonals d0 and d0 + tile
//     cross the merge path, by a 32-way search in device memory (32 probes
//     a round, a ballot narrows the range 32-fold: 3 rounds for a run of
//     32,768);
//   * loads: the CTA's A and B slices (tile entries in all) go to shared
//     memory plane by plane, coalesced;
//   * thread merge: each thread searches its own diagonal in shared
//     memory, then merges its 8 outputs serially in registers;
//   * store: outputs are staged through shared memory (padded one word in
//     32, so the stride-8 writes hit 32 banks) and stored coalesced.
// Ties go to A everywhere (A[i] <= B[j] takes A[i]); equal entries are
// equal in every plane, so any consistent rule gives the same bytes.
// K10 is one launch over its 2N outputs.  K5 is one launch per merge level
// (pairs of runs never cross a segment), its levels alternating between
// out and a scratch buffer the caller gives, the last writing out; runs
// shorter than the 2,048-entry tile first go through their levels
// together, one launch, in shared memory (each entry's place is its index
// plus its rank in the other run).  Offsets and diagonals are int64 (n
// reaches 2,048 * 32,768 = 67M entries).
//
// What bounds them on an H100: bytes.  A level reads and writes each entry
// once (n * pw * 8 bytes: 67 MB at config 2's n = 128 * 32,768, pw = 2,
// ~20 us at the H100 SXM's published 3.35 TB/s, 700 W), so config 2's 7
// levels need ~0.14 ms, and K10 at
// the blocked schedule's macro-tile (two streams of 2^22, pw 2) one pass
// over 134 MB, ~0.04 ms.  The CTA search adds 3 dependent device reads
// per CTA, which the SM's other CTAs overlap; each pass measures about
// half its byte bound on an H100 80GB HBM3 at 700 W (PERF.md), and
// issuing a thread's 8 loads before its stores did not help there.
// Small calls are launch bound.  A 4-way merge per pass would halve K5's
// levels: later work.
//
// K8 sort_runs: replaces sort.py::sort_runs_128 (:220; kernels
// _multi_run_sort_kernel :189 and, for odd run layouts, _tile_sort :172).
// It is the bitonic network above with every comparator of an odd run (by
// its index within the row) inverted, so odd runs come out descending; the finish
// fallback _finish_runs (ops/sketch.py) sorts G rows of nblocks runs in
// one launch.  K9 sort_truncate: replaces sort.py::sort_truncate_128
// (:249): K4's sort of every 32,768-entry tile (register tiles and one or
// two K5 levels), one pass that keeps each tile's capacity / t smallest
// entries, then K5's merge of those runs inside each row's capacity-entry
// segment.  What bounds both: bytes (each pass reads and writes every
// entry), and at the finish's small shapes launch latency.

constexpr int MERGE_THREADS = 256;
constexpr int MERGE_E = 8;                              // outputs a thread
constexpr int MERGE_TILE = MERGE_THREADS * MERGE_E;     // outputs a CTA
constexpr int MERGE_PLANE = MERGE_TILE + MERGE_TILE / 32;  // padded plane
static_assert(5 * MERGE_PLANE * sizeof(uint32_t) <= 48 * 1024,
              "pw 5 must fit the default 48 KB of dynamic shared memory");

// Shared-memory slot of tile entry e: one pad word after every 32.
__device__ __forceinline__ int spad(int e) { return e + (e >> 5); }

// Entry i of a stacked stream (plane stride `plane`).  A nonzero `off` is
// added to word 0 of a valid entry (top word's sign bit clear): K10's gid
// shift of stream B.  Sentinels stay all-ones.
template <int PW>
__device__ __forceinline__ void load_key(const uint32_t* p, int64_t plane,
                                         int64_t i, uint32_t off,
                                         uint32_t (&k)[PW]) {
#pragma unroll
  for (int q = 0; q < PW; ++q) k[q] = p[q * plane + i];
  if (off != 0 && static_cast<int32_t>(k[PW - 1]) >= 0) k[0] += off;
}

// Entry e of a padded tile in shared memory, plane stride `plane`.
template <int PW>
__device__ __forceinline__ void smem_key(const uint32_t* sm, int plane, int e,
                                         uint32_t (&k)[PW]) {
#pragma unroll
  for (int q = 0; q < PW; ++q) k[q] = sm[q * plane + spad(e)];
}

template <int PW>
__device__ __forceinline__ void smem_store(uint32_t* sm, int plane, int e,
                                           const uint32_t (&k)[PW]) {
#pragma unroll
  for (int q = 0; q < PW; ++q) sm[q * plane + spad(e)] = k[q];
}

// How many of the first d outputs of merge(A, B) come from A (na, nb
// entries; ties to A): the first i with B[d-1-i] < A[i].  One warp, 32
// probes a round; every lane returns the answer.
template <int PW>
__device__ int64_t warp_split(const uint32_t* a, int64_t plane_a, int64_t na,
                              const uint32_t* b, int64_t plane_b, int64_t nb,
                              uint32_t off, int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (hi > lo) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + lane * step;
    bool take_a = false;
    if (i < hi) {
      uint32_t x[PW], y[PW];
      load_key<PW>(a, plane_a, i, 0, x);
      load_key<PW>(b, plane_b, d - 1 - i, off, y);
      take_a = !lex_less<PW>(y, x);
    }
    // take_a holds on a prefix of the lanes: the answer lies after the
    // last lane that holds and at or before the first that does not
    const int c = __popc(__ballot_sync(FULL, take_a));
    const int64_t next_lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    const int64_t next_hi = lo + c * step;
    hi = next_hi < hi ? next_hi : hi;
    lo = next_lo;
  }
  return lo;
}

// The same split inside a tile in shared memory: A at [0, na), B at
// [na, na + nb).
template <int PW>
__device__ int smem_split(const uint32_t* sm, int plane, int na, int nb,
                          int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    uint32_t x[PW], y[PW];
    smem_key<PW>(sm, plane, mid, x);
    smem_key<PW>(sm, plane, na + d - 1 - mid, y);
    if (lex_less<PW>(y, x)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// One thread's outputs [d0, d0 + cnt) (cnt <= E) of merge(A, B) in a
// shared-memory tile (A at [0, na), B at [na, na + nb)), into res.
template <int PW, int E>
__device__ __forceinline__ void merge_thread(const uint32_t* sm, int plane,
                                             int na, int nb, int d0, int cnt,
                                             uint32_t (&res)[E][PW]) {
  int i = smem_split<PW>(sm, plane, na, nb, d0), j = d0 - i;
  uint32_t x[PW] = {}, y[PW] = {};
  if (i < na) smem_key<PW>(sm, plane, i, x);
  if (j < nb) smem_key<PW>(sm, plane, na + j, y);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (k < cnt) {
      const bool take_a = j >= nb || (i < na && !lex_less<PW>(y, x));
#pragma unroll
      for (int q = 0; q < PW; ++q) res[k][q] = take_a ? x[q] : y[q];
      i += take_a;
      j += !take_a;
      // refill the side just taken with one load at a selected address,
      // so the warp does not diverge (an exhausted side is never read)
      uint32_t z[PW];
      smem_key<PW>(sm, plane, take_a ? min(i, na - 1) : na + min(j, nb - 1),
                   z);
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        x[q] = take_a ? z[q] : x[q];
        y[q] = take_a ? y[q] : z[q];
      }
    }
  }
}

// Writes outputs [d0, d0 + tile) of merge(A, B) to out[0, tile) (plane
// stride out_plane); B's valid entries are read with `off` added.
template <int PW>
__device__ void merge_path_tile(uint32_t* sm, const uint32_t* a,
                                int64_t plane_a, int64_t na,
                                const uint32_t* b, int64_t plane_b,
                                int64_t nb, uint32_t off, int64_t d0,
                                int tile, uint32_t* out, int64_t out_plane) {
  __shared__ int64_t split[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t s = warp_split<PW>(a, plane_a, na, b, plane_b, nb, off,
                                     d0 + warp * tile);
    if ((threadIdx.x & 31) == 0) split[warp] = s;
  }
  __syncthreads();
  const int64_t i0 = split[0], j0 = d0 - i0;
  const int ta = static_cast<int>(split[1] - i0), tb = tile - ta;
  for (int e = threadIdx.x; e < tile; e += MERGE_THREADS) {
    uint32_t k[PW];
    if (e < ta) {
      load_key<PW>(a, plane_a, i0 + e, 0, k);
    } else {
      load_key<PW>(b, plane_b, j0 + (e - ta), off, k);
    }
    smem_store<PW>(sm, MERGE_PLANE, e, k);
  }
  __syncthreads();

  const int e0 = threadIdx.x * MERGE_E;
  const int left = tile - e0;
  const int cnt = left < 0 ? 0 : (left < MERGE_E ? left : MERGE_E);
  uint32_t res[MERGE_E][PW];
  if (cnt > 0) {
    merge_thread<PW, MERGE_E>(sm, MERGE_PLANE, ta, tb, e0, cnt, res);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MERGE_E; ++k) {
    if (k < cnt) smem_store<PW>(sm, MERGE_PLANE, e0 + k, res[k]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tile; e += MERGE_THREADS) {
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      out[q * out_plane + e] = sm[q * MERGE_PLANE + spad(e)];
    }
  }
}

// One K5 level: pairs of ascending runs of `run` entries (2 * run a
// multiple of MERGE_TILE), one MERGE_TILE of outputs per CTA.
template <int PW>
__device__ __forceinline__ void merge_level(uint32_t* sm, const uint32_t* in,
                                            uint32_t* out, int64_t total,
                                            int64_t run) {
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * MERGE_TILE;
  const int64_t base = o0 & ~(2 * run - 1);
  merge_path_tile<PW>(sm, in + base, total, run, in + base + run, total, run,
                      0, o0 - base, MERGE_TILE, out + o0, total);
}

template <int PW>
__global__ void __launch_bounds__(MERGE_THREADS) merge_level_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int64_t run) {
  extern __shared__ uint32_t sm[];
  merge_level<PW>(sm, in, out, total, run);
}

// The same level for K4's rows longer than its tile, under its own name so
// that a profile tells K4's time from K5's.
template <int PW>
__global__ void __launch_bounds__(MERGE_THREADS) sort_level_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int64_t run) {
  extern __shared__ uint32_t sm[];
  merge_level<PW>(sm, in, out, total, run);
}

// K10: the merge of a and b (half entries each, b shifted by off), `tile`
// outputs per CTA.
template <int PW>
__global__ void __launch_bounds__(MERGE_THREADS) merge_pair_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    uint32_t* __restrict__ out, int64_t half, uint32_t off, int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * tile;
  merge_path_tile<PW>(sm, a, half, half, b, half, half, off, o0, tile,
                      out + o0, 2 * half);
}

// K5's levels run, 2 * run, ..., tile / 2 on each tile of `tile` (<=
// MERGE_TILE) entries in shared memory.  An entry's place in its pair's
// merge is its index in its run plus the count of the other run's entries
// before it: those below it for an entry of A, those at or below it for
// an entry of B (ties to A).
template <int PW>
__global__ void __launch_bounds__(MERGE_THREADS) merge_runs_smem_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int run, int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int e = threadIdx.x; e < tile; e += MERGE_THREADS) {
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      sm[q * MERGE_PLANE + spad(e)] = in[q * total + base + e];
    }
  }
  __syncthreads();
  for (int len = run; len < tile; len <<= 1) {
    uint32_t key[MERGE_E][PW];
    int dst[MERGE_E];
#pragma unroll
    for (int k = 0; k < MERGE_E; ++k) {
      const int e = threadIdx.x + k * MERGE_THREADS;
      if (e < tile) {
        smem_key<PW>(sm, MERGE_PLANE, e, key[k]);
        const int pair = e & ~(2 * len - 1);
        const bool in_a = e - pair < len;
        const int other = in_a ? pair + len : pair;
        int lo = 0, hi = len;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          uint32_t y[PW];
          smem_key<PW>(sm, MERGE_PLANE, other + mid, y);
          const bool before = in_a ? lex_less<PW>(y, key[k])
                                   : !lex_less<PW>(key[k], y);
          if (before) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        dst[k] = e - (in_a ? 0 : len) + lo;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MERGE_E; ++k) {
      if (threadIdx.x + k * MERGE_THREADS < tile) {
        smem_store<PW>(sm, MERGE_PLANE, dst[k], key[k]);
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < tile; e += MERGE_THREADS) {
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      out[q * total + base + e] = sm[q * MERGE_PLANE + spad(e)];
    }
  }
}

inline unsigned pass_blocks(int64_t pairs) {
  return static_cast<unsigned>((pairs + PASS_THREADS - 1) / PASS_THREADS);
}

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// The launches merge_runs makes: one for the shared-memory levels (when
// run < the tile) and one per level of MERGE_TILE or more.
int merge_passes(int64_t run, int64_t seg, int tile) {
  int passes = run < tile ? 1 : 0;
  for (int64_t len = run < tile ? tile : run; 2 * len <= seg; len <<= 1) {
    ++passes;
  }
  return passes;
}

// Merges the ascending runs of `run` entries inside each segment of seg
// entries (seg divides total).  Reads in once; levels alternate between
// out and scratch (same size as in; unused when there is one pass), the
// last writing out.
template <int PW>
int merge_runs(const uint32_t* in, uint32_t* out, uint32_t* scratch,
               int64_t total, int64_t run, int64_t seg, cudaStream_t stream) {
  const int tile = static_cast<int>(seg < MERGE_TILE ? seg : MERGE_TILE);
  const int passes = merge_passes(run, seg, tile);
  if (passes > 1 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(uint32_t) * PW * MERGE_PLANE;
  const uint32_t* src = in;
  int p = 0, err = 0;
  auto dst_of = [&](int pass) {
    return ((passes - 1 - pass) & 1) ? scratch : out;
  };
  if (run < tile) {
    uint32_t* dst = dst_of(p++);
    merge_runs_smem_kernel<PW><<<static_cast<unsigned>(total / tile),
                                 MERGE_THREADS, smem, stream>>>(
        in, dst, total, static_cast<int>(run), tile);
    err = last_error();
    src = dst;
  }
  for (int64_t len = run < tile ? tile : run; 2 * len <= seg && !err;
       len <<= 1) {
    uint32_t* dst = dst_of(p++);
    merge_level_kernel<PW><<<static_cast<unsigned>(total / MERGE_TILE),
                             MERGE_THREADS, smem, stream>>>(src, dst, total,
                                                           len);
    err = last_error();
    src = dst;
  }
  return err;
}

template <int PW>
int merge_pair(const uint32_t* a, const uint32_t* b, uint32_t* out,
               int64_t half, uint32_t off, cudaStream_t stream) {
  const int64_t total = 2 * half;
  const int tile = static_cast<int>(total < MERGE_TILE ? total : MERGE_TILE);
  merge_pair_kernel<PW><<<static_cast<unsigned>(total / tile), MERGE_THREADS,
                          sizeof(uint32_t) * PW * MERGE_PLANE, stream>>>(
      a, b, out, half, off, tile);
  return last_error();
}

// ---------------------------------------------------------------------------
// K4's register tile sort (the file's header describes the design).

constexpr int TILE_THREADS = 1024;

// Keys a thread sorts in registers (E * KW <= 32 words), and a tile.
template <int KW>
constexpr int TILE_E = KW <= 2 ? 16 : 8;
template <int KW>
constexpr int TILE_KEYS = TILE_THREADS * TILE_E<KW>;

// Orders a and b: a <= b if up, else a >= b.
template <int KW>
__device__ __forceinline__ void compare_swap(uint32_t (&a)[KW],
                                             uint32_t (&b)[KW], bool up) {
  const bool swap = up ? lex_less<KW>(b, a) : lex_less<KW>(a, b);
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    const uint32_t x = a[q];
    a[q] = swap ? b[q] : x;
    b[q] = swap ? x : b[q];
  }
}

// A bitonic network over E (a power of two) keys held in registers; the
// loops unroll fully, so every index is a compile-time constant.
template <int KW, int E>
__device__ __forceinline__ void register_sort(uint32_t (&key)[E][KW]) {
  constexpr int LOG_E = E == 32 ? 5 : (E == 16 ? 4 : 3);
  static_assert(1 << LOG_E == E, "E must be 8, 16 or 32");
#pragma unroll
  for (int s = 1; s <= LOG_E; ++s) {
#pragma unroll
    for (int d = s - 1; d >= 0; --d) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int l = i ^ (1 << d);
        if (l > i) compare_swap<KW>(key[i], key[l], (i & (1 << s)) == 0);
      }
    }
  }
}

// One CTA sorts `tile` consecutive keys of each plane (tile / E threads):
// E keys a thread in registers, then the block's merge-path levels in
// shared memory (padded one word in 32, so a thread's stride-E reads and
// writes hit 32 banks).
template <int KW>
__global__ void __launch_bounds__(TILE_THREADS) reg_tile_sort_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int tile) {
  constexpr int E = TILE_E<KW>;
  extern __shared__ uint32_t sm[];
  const int plane = tile + tile / 32;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  uint32_t key[E][KW];
  // coalesced loads, all in flight at once (tile == E * blockDim.x)
#pragma unroll
  for (int k = 0; k < E; ++k) {
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      key[k][q] = in[q * total + base + threadIdx.x + k * blockDim.x];
    }
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    smem_store<KW>(sm, plane, threadIdx.x + k * blockDim.x, key[k]);
  }
  __syncthreads();
  const int e0 = threadIdx.x * E;
#pragma unroll
  for (int i = 0; i < E; ++i) smem_key<KW>(sm, plane, e0 + i, key[i]);
  register_sort<KW, E>(key);
#pragma unroll
  for (int i = 0; i < E; ++i) smem_store<KW>(sm, plane, e0 + i, key[i]);
  __syncthreads();
  for (int run = E; run < tile; run <<= 1) {
    const int pair = e0 & ~(2 * run - 1);  // a multiple of 32: spad adds
    merge_thread<KW, E>(sm + spad(pair), plane, run, run, e0 - pair, E,
                        key);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < E; ++i) smem_store<KW>(sm, plane, e0 + i, key[i]);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      out[q * total + base + e] = sm[q * plane + spad(e)];
    }
  }
}

// The streaming multiprocessors of the current device.
int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return sms;
}

// K4's tile for g rows of n: min(n, T), or min(n, T / 4) when tiles of T
// would leave more than half the SMs idle.  One CTA sorts a tile, so a few
// rows of T-key tiles keep a few SMs busy for the whole ~60 us of the tile
// sort; quarter tiles spread it over four times the SMs at the price of
// two more K5 levels, which measured faster there and slower on a full
// grid on an H100 (PERF.md, section 6).
template <int KW>
int64_t sort_tile(int64_t g, int64_t n) {
  constexpr int64_t T = TILE_KEYS<KW>;
  static const int sms = device_sms();
  const int64_t tile = n < T ? n : T;
  if (2 * (g * n / tile) >= sms) return tile;
  return n < T / 4 ? n : T / 4;
}

// K4: sorts each of the g rows of n entries (n a power of two >= 1,024):
// tiles of sort_tile entries, then log2(n / tile) K5 levels (as
// sort_level_kernel), which alternate between out and scratch so that the
// last writes out.  scratch (the size of in) may be null when n <= T / 4.
template <int KW>
int sort_rows(const uint32_t* in, uint32_t* out, uint32_t* scratch,
              int64_t g, int64_t n, cudaStream_t stream) {
  constexpr int E = TILE_E<KW>;
  constexpr int T = TILE_KEYS<KW>;
  constexpr size_t max_smem = sizeof(uint32_t) * KW * (T + T / 32);
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      reg_tile_sort_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(max_smem)));
  if (attr != 0) return attr;
  const int tile = static_cast<int>(sort_tile<KW>(g, n));
  int levels = 0;
  for (int64_t r = tile; r < n; r <<= 1) ++levels;
  if (levels > 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = g * n;
  uint32_t* src = (levels & 1) ? scratch : out;
  reg_tile_sort_kernel<KW><<<static_cast<unsigned>(total / tile), tile / E,
                             sizeof(uint32_t) * KW * (tile + tile / 32),
                             stream>>>(in, src, total, tile);
  int err = last_error();
  for (int l = 0; l < levels && err == 0; ++l) {
    uint32_t* dst = ((levels - 1 - l) & 1) ? scratch : out;
    sort_level_kernel<KW><<<static_cast<unsigned>(total / MERGE_TILE),
                            MERGE_THREADS,
                            sizeof(uint32_t) * KW * MERGE_PLANE, stream>>>(
        src, dst, total, static_cast<int64_t>(tile) << l);
    err = last_error();
    src = dst;
  }
  return err;
}

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

// The sorted tiles are dead once cut, so their buffer is the merge's
// scratch (m >= capacity); scratch is K4's.
template <int KW>
int sort_truncate(const uint32_t* in, uint32_t* sorted, uint32_t* scratch,
                  uint32_t* cut_buf, uint32_t* out, int g, int64_t m,
                  int64_t capacity, cudaStream_t stream) {
  const int64_t tiles = g * (m / TRUNC_TILE);
  const int64_t cut = capacity / (m / TRUNC_TILE);
  int err = sort_rows<KW>(in, sorted, scratch, tiles, TRUNC_TILE, stream);
  if (err) return err;
  truncate_kernel<KW><<<pass_blocks(tiles * cut), PASS_THREADS, 0, stream>>>(
      sorted, cut_buf, tiles, TRUNC_TILE, cut);
  err = last_error();
  return err ? err : merge_runs<KW>(cut_buf, out, sorted, g * capacity, cut,
                                    capacity, stream);
}

}  // namespace
}  // namespace sks

// K4: in, out, scratch (kw, g, n) u32, n a power of two >= 1024; none
// may alias another.  scratch may be null when n <= 2,048.
extern "C" int sks_sort_rows(const void* in, void* out, void* scratch,
                             int kw, int g, int64_t n, void* stream) {
  if (g <= 0 || n < 1024 || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto* t = static_cast<uint32_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return sks::sort_rows<1>(i, o, t, g, n, s);
    case 2: return sks::sort_rows<2>(i, o, t, g, n, s);
    case 3: return sks::sort_rows<3>(i, o, t, g, n, s);
    case 4: return sks::sort_rows<4>(i, o, t, g, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5: in, out, scratch (pw, n) u32, the runs of `run` entries ascending;
// each segment of seg entries is merged into one ascending run.  run and
// seg powers of two, 2 * run <= seg, seg divides n.  None of the three may
// alias another; scratch may be null when the merge is one pass (seg <=
// 2,048, or 2 * run == seg).
extern "C" int sks_merge_runs(const void* in, void* out, void* scratch,
                              int pw, int64_t n, int64_t run, int64_t seg,
                              void* stream) {
  if (!sks::pow2(seg) || !sks::pow2(run) || 2 * run > seg || n % seg != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto* t = static_cast<uint32_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return sks::merge_runs<1>(i, o, t, n, run, seg, s);
    case 2: return sks::merge_runs<2>(i, o, t, n, run, seg, s);
    case 3: return sks::merge_runs<3>(i, o, t, n, run, seg, s);
    case 4: return sks::merge_runs<4>(i, o, t, n, run, seg, s);
    case 5: return sks::merge_runs<5>(i, o, t, n, run, seg, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K10: a, b (pw, half) u32 ascending, half a power of two -> out
// (pw, 2 * half) ascending, b read with b_offset (>= 0) added to word 0 of
// every valid entry (word pw-1's top bit clear).  out may not alias a or b.
extern "C" int sks_merge_pair(const void* a, const void* b, void* out, int pw,
                              int64_t half, int b_offset, void* stream) {
  if (!sks::pow2(half) || b_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const auto off = static_cast<uint32_t>(b_offset);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return sks::merge_pair<1>(x, y, o, half, off, s);
    case 2: return sks::merge_pair<2>(x, y, o, half, off, s);
    case 3: return sks::merge_pair<3>(x, y, o, half, off, s);
    case 4: return sks::merge_pair<4>(x, y, o, half, off, s);
    case 5: return sks::merge_pair<5>(x, y, o, half, off, s);
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
    case 1: return sks::bitonic_sort_runs<1>(i, o, runs, run, m / run,
                                                 s);
    case 2: return sks::bitonic_sort_runs<2>(i, o, runs, run, m / run,
                                                 s);
    case 3: return sks::bitonic_sort_runs<3>(i, o, runs, run, m / run,
                                                 s);
    case 4: return sks::bitonic_sort_runs<4>(i, o, runs, run, m / run,
                                                 s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9: in (kw, g, m) u32, m = t * 32768 with t >= 2 a power of two;
// out (kw, g, capacity) u32: per row, the capacity / t smallest entries of
// each 32,768-entry tile, merged ascending (capacity / t a power of two
// >= 128 and <= 32,768).  Scratch: sorted and scratch (kw, g, m), cut (kw,
// g, capacity).
extern "C" int sks_sort_truncate(const void* in, void* sorted, void* scratch,
                                 void* cut, void* out, int kw, int g,
                                 int64_t m, int64_t capacity, void* stream) {
  const int64_t t = m / sks::TRUNC_TILE;
  if (g <= 0 || m % sks::TRUNC_TILE != 0 || t < 2 || !sks::pow2(t) ||
      capacity % t != 0 || capacity / t < 128 || !sks::pow2(capacity / t) ||
      capacity / t > sks::TRUNC_TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* so = static_cast<uint32_t*>(sorted);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* c = static_cast<uint32_t*>(cut);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return sks::sort_truncate<1>(i, so, sc, c, o, g, m, capacity,
                                             s);
    case 2: return sks::sort_truncate<2>(i, so, sc, c, o, g, m, capacity,
                                             s);
    case 3: return sks::sort_truncate<3>(i, so, sc, c, o, g, m, capacity,
                                             s);
    case 4: return sks::sort_truncate<4>(i, so, sc, c, o, g, m, capacity,
                                             s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
