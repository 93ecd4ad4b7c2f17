// K4: batched lexicographic ascending sort of multi-word keys, K8: the
// same sort with alternating run directions (both bitonic networks), K5 /
// K10: merge-path merges of ascending runs, and K9: tile sorts cut to a
// share and merged by K5 (the second half of this file).
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
// It is K4's network with every comparator of an odd run (by its index
// within the row) inverted, so odd runs come out descending; the finish
// fallback _finish_runs (ops/sketch.py) sorts G rows of nblocks runs in
// one launch.  K9 sort_truncate: replaces sort.py::sort_truncate_128
// (:249): K4's sort of every 32,768-entry tile, one pass that keeps each
// tile's capacity / t smallest entries, then K5's merge of those runs
// inside each row's capacity-entry segment.  What bounds both: bytes, as
// for K4 (each pass reads and writes every entry), and at the finish's
// small shapes launch latency.

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

template <int PW>
__device__ __forceinline__ void smem_key(const uint32_t* sm, int e,
                                         uint32_t (&k)[PW]) {
#pragma unroll
  for (int q = 0; q < PW; ++q) k[q] = sm[q * MERGE_PLANE + spad(e)];
}

template <int PW>
__device__ __forceinline__ void smem_store(uint32_t* sm, int e,
                                           const uint32_t (&k)[PW]) {
#pragma unroll
  for (int q = 0; q < PW; ++q) sm[q * MERGE_PLANE + spad(e)] = k[q];
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

// The same split inside the tile in shared memory: A at [0, na), B at
// [na, na + nb).
template <int PW>
__device__ int smem_split(const uint32_t* sm, int na, int nb, int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    uint32_t x[PW], y[PW];
    smem_key<PW>(sm, mid, x);
    smem_key<PW>(sm, na + d - 1 - mid, y);
    if (lex_less<PW>(y, x)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
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
    smem_store<PW>(sm, e, k);
  }
  __syncthreads();

  const int e0 = threadIdx.x * MERGE_E;
  const int left = tile - e0;
  const int cnt = left < 0 ? 0 : (left < MERGE_E ? left : MERGE_E);
  uint32_t res[MERGE_E][PW];
  if (cnt > 0) {
    int i = smem_split<PW>(sm, ta, tb, e0), j = e0 - i;
    uint32_t x[PW] = {}, y[PW] = {};
    if (i < ta) smem_key<PW>(sm, i, x);
    if (j < tb) smem_key<PW>(sm, ta + j, y);
#pragma unroll
    for (int k = 0; k < MERGE_E; ++k) {
      if (k < cnt) {
        const bool take_a = j >= tb || (i < ta && !lex_less<PW>(y, x));
#pragma unroll
        for (int q = 0; q < PW; ++q) res[k][q] = take_a ? x[q] : y[q];
        if (take_a) {
          if (++i < ta) smem_key<PW>(sm, i, x);
        } else {
          if (++j < tb) smem_key<PW>(sm, ta + j, y);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MERGE_E; ++k) {
    if (k < cnt) smem_store<PW>(sm, e0 + k, res[k]);
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
__global__ void __launch_bounds__(MERGE_THREADS) merge_level_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int64_t run) {
  extern __shared__ uint32_t sm[];
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * MERGE_TILE;
  const int64_t base = o0 & ~(2 * run - 1);
  merge_path_tile<PW>(sm, in + base, total, run, in + base + run, total, run,
                      0, o0 - base, MERGE_TILE, out + o0, total);
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
        smem_key<PW>(sm, e, key[k]);
        const int pair = e & ~(2 * len - 1);
        const bool in_a = e - pair < len;
        const int other = in_a ? pair + len : pair;
        int lo = 0, hi = len;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          uint32_t y[PW];
          smem_key<PW>(sm, other + mid, y);
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
        smem_store<PW>(sm, dst[k], key[k]);
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
// scratch (m >= capacity).
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
  return err ? err : merge_runs<KW>(cut_buf, out, sorted, g * capacity, cut,
                                    capacity, stream);
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
// >= 128 and <= 32,768).  Scratch: sorted (kw, g, m), cut (kw, g,
// capacity).
extern "C" int sks_sort_truncate(const void* in, void* sorted, void* cut,
                                 void* out, int kw, int g, int64_t m,
                                 int64_t capacity, void* stream) {
  const int64_t t = m / sks::TRUNC_TILE;
  if (g <= 0 || m % sks::TRUNC_TILE != 0 || t < 2 || !sks::pow2(t) ||
      capacity % t != 0 || capacity / t < 128 || !sks::pow2(capacity / t) ||
      capacity / t > sks::TRUNC_TILE) {
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
