// K4: batched lexicographic ascending sort of multi-word keys, K8: the same
// sort of every run of a row with odd runs stored descending, K9: a sort
// that keeps each 32,768-entry tile's share of a capacity and merges the
// shares, all on one machinery (a register tile sort, then merge-path
// levels); K5 / K10: merge-path merges of ascending runs.
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
//   * a row of N > T then takes K5's merge levels (merge_pairs, launched
//     as sort_level_kernel so that a profile tells K4 from K5), log2(N / T)
//     launches alternating between out and a scratch buffer the caller
//     gives.
// So N = 65,536 at G = 2 (the timed shape, quarter tiles) takes 5
// launches at kw <= 2, and a full grid of rows of N <= T (phase 8(b)'s
// 128 x 16,384) one.
//
// What bounds it on an H100: the work inside one CTA a tile, not bytes.
// A sort of G = 2 rows of 65,536 two-word keys moves 2.1 MB (0.6 us at
// 3.35 TB/s).  The register network compares without barriers and a merge
// level costs one barrier pair for E outputs a thread, but each of the ten
// in-block levels still issues ~35 instructions and ~2 scattered
// shared-memory reads a key (the diagonal search, the serial merge), so
// one 16,384-key tile takes ~60 us in its CTA.  On an H100 80GB HBM3 at
// 700 W: phase 8(b)'s 128 x 16,384 (128 CTAs) 0.066 ms a call on the
// device, ~9 ms over its 119 calls; the timed shape 0.072 ms with 8 tiles
// of 16,384 (8 SMs busy) and 0.044 with 32 quarter tiles and four K5
// levels, which sort_tile therefore picks (PERF.md).
#include "common.cuh"

namespace sks {
namespace {

constexpr int64_t TRUNC_TILE = 32768;    // K9's tile (the JAX TILE_ELEMS)

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
//     32, so the stride-8 writes hit 32 banks) and stored coalesced, in
//     descending addresses when the run they build is stored reversed
//     (K8's last level).
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
// stride out_plane), or with REV to out[0], out[-1], ..., out[1 - tile]:
// a warp's lanes then store consecutive words in descending order, still
// whole lines.  B's valid entries are read with `off` added.
template <int PW, bool REV = false>
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
      out[q * out_plane + (REV ? -e : e)] = sm[q * MERGE_PLANE + spad(e)];
    }
  }
}

// One merge level: pair p of ascending runs of `run` entries (in[2p run,
// (2p + 2) run), plane stride total_in) gives its first outlen outputs
// (outlen <= 2 run, a power of two >= MERGE_TILE) at out[p outlen] (plane
// stride total_out), MERGE_TILE outputs a CTA.  K5's and K4's levels keep
// all 2 run; K9's are cut to its share, since the first outlen outputs of
// a merge only read the first outlen entries of each run.  With REV the
// pairs odd within their row (rows of alt pairs) are stored reversed: K8's
// last level.
template <int PW, bool REV>
__device__ __forceinline__ void merge_pairs(uint32_t* sm, const uint32_t* in,
                                            uint32_t* out, int64_t total_in,
                                            int64_t total_out, int64_t run,
                                            int64_t outlen, int64_t alt) {
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * MERGE_TILE;
  const int64_t obase = o0 & ~(outlen - 1);      // the pair's first output
  const int64_t d0 = o0 - obase;
  // the pair's first input: obase * (2 run / outlen), both powers of two
  const uint32_t* a = in + (obase << (__ffsll(2 * run) - __ffsll(outlen)));
  if constexpr (REV) {
    const auto pair = static_cast<uint32_t>(obase >> (__ffsll(outlen) - 1));
    if ((pair % static_cast<uint32_t>(alt)) & 1) {
      merge_path_tile<PW, true>(sm, a, total_in, run, a + run, total_in, run,
                                0, d0, MERGE_TILE,
                                out + obase + (outlen - 1 - d0), total_out);
      return;
    }
  }
  merge_path_tile<PW>(sm, a, total_in, run, a + run, total_in, run, 0, d0,
                      MERGE_TILE, out + o0, total_out);
}

template <int PW>
__global__ void __launch_bounds__(MERGE_THREADS) merge_level_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int64_t run) {
  extern __shared__ uint32_t sm[];
  merge_pairs<PW, false>(sm, in, out, total, total, run, 2 * run, 0);
}

// The same level for the register tiles' sorts (K4, K8, K9), under its own
// name so that a profile tells them from K5.
template <int PW, bool REV>
__global__ void __launch_bounds__(MERGE_THREADS) sort_level_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total_in, int64_t total_out, int64_t run, int64_t outlen,
    int64_t alt) {
  extern __shared__ uint32_t sm[];
  merge_pairs<PW, REV>(sm, in, out, total_in, total_out, run, outlen, alt);
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
// The register tile sort of K4, K8 and K9 (the file's header describes K4).
//
// K8 sort_runs: replaces sort.py::sort_runs_128 (:220; kernels
// _multi_run_sort_kernel :189 and, for odd run layouts, _tile_sort :172).
// Every run of a row (a power of two of 128 or more entries) is sorted
// ascending on the register tiles, and the last step that writes a run
// writes it reversed when the run is odd by its index within the row:
//   * runs <= 4,096: one launch.  A CTA sorts a tile of 2,048 entries (256
//     threads; 4,096 and 512 threads at runs of 4,096) holding whole runs,
//     its merge levels stopping at the run, and stores odd runs reversed.
//     A last tile past the rows' end is padded with sentinels, which form
//     whole runs of their own and are not stored;
//   * longer runs: 4,096-entry tiles, then K5's levels (sort_level_kernel)
//     up to the run, the last storing odd runs reversed through
//     merge_path_tile's staged write-out.  Runs of 32,768: 4 launches.
// A reversed run still stores coalesced: a warp's lanes write consecutive
// words in descending order.
//
// K9 sort_truncate: replaces sort.py::sort_truncate_128 (:249).  Per row,
// each 32,768-entry tile keeps its cut = capacity / t smallest entries, and
// the t cuts are merged.  It rests on one fact: the first cut outputs of
// merge(A, B) are those of merge(A[:cut], B[:cut]), so no step past the
// cut needs more than cut entries of any run:
//   1. register tiles of 4,096 entries: a tile's valid keys move to its
//      front and only the smallest power of two that holds them is sorted
//      (a tile of sparse candidates takes a few levels), by levels that
//      keep only a pair's first min(cut, 2 len) outputs, packed, once
//      2 len > cut (a thread whose outputs lie past the cut skips the
//      level); each CTA writes its first min(cut, 4,096) entries;
//   2. the 8 pieces of each 32,768-entry tile merged to its first cut
//      entries: K5's levels cut to the share (sort_level_kernel) while a
//      tile's pieces overflow a CTA's shared memory (cut >= 2,048), then
//      cut_merge_kernel, one CTA a tile, every level in shared memory.  The
//      last launch writes the packed (kw, G, capacity) layout;
//   3. each row's t cuts merged: cut_merge_kernel when a row's capacity
//      fits a CTA (<= 8,192), else K5's merge_runs.
// So capacity 2,048 at t = 4 and 8,192 at t = 16 take 3 launches, and
// nothing is sorted that a cut drops: step 1 reads the input once and
// writes an eighth of it at cut 512.
//
// The tiles of K8 and K9 hold 8 keys a thread (K4 holds 16 at kw <= 2), so
// a level's serial merge is 8 steps: 4 or 16 keys a thread, tiles of
// 2,048 for K9, and a warp start (each warp's 256 keys merged by shuffles
// before the block's levels) measured no faster on an H100 (PERF.md,
// section 6; the port's tools/time_run_tiles.py times the variants).
// What bounds both kernels at the finish's shapes: the latency of their
// serial levels, ~1.2 us each in a CTA, and of each launch (their byte
// bounds lie far below one launch's), so the design counts launches and
// levels.

constexpr int TILE_THREADS = 1024;

// Keys a thread sorts in registers (E * KW <= 32 words), and a tile.
template <int KW>
constexpr int TILE_E = KW <= 2 ? 16 : 8;
template <int KW>
constexpr int TILE_KEYS = TILE_THREADS * TILE_E<KW>;

// K8's and K9's keys a thread, their tile, and K8's tile at runs up to
// RUN_TILE_MIN.  A build may set them with -D (build.build's `defines`),
// as tools/time_run_tiles.py does to time variants.
#ifndef SKS_RUN_E
#define SKS_RUN_E 8
#endif
#ifndef SKS_RUN_TILE
#define SKS_RUN_TILE 4096
#endif
#ifndef SKS_RUN_TILE_MIN
#define SKS_RUN_TILE_MIN 2048
#endif
constexpr int RUN_E = SKS_RUN_E;
constexpr int RUN_TILE = SKS_RUN_TILE;
constexpr int RUN_TILE_MIN = SKS_RUN_TILE_MIN;
constexpr int RUN_THREADS = RUN_TILE / RUN_E;
constexpr int CUT_THREADS = 1024;                 // cut_merge_kernel's most
constexpr int CUT_KEYS = CUT_THREADS * MERGE_E;   // and its 8,192 entries

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
  constexpr int LOG_E = E == 32 ? 5 : E == 16 ? 4 : E == 8 ? 3 : 2;
  static_assert(1 << LOG_E == E, "E must be 4, 8, 16 or 32");
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

// The block's merge levels over `pieces` ascending pieces of len entries,
// packed in shared memory (padded one word in 32, so a thread's stride-E
// reads and writes hit 32 banks; plane stride `plane`): each level merges
// pairs of pieces by merge path, E outputs a thread at threadIdx.x * E,
// each thread finding its diagonal and merging its outputs in registers
// between two barriers.  With CUT a pair keeps only its first min(cut,
// 2 len) outputs, stored packed, and a thread whose outputs lie past them
// skips the level.  Ends with one piece; returns its length.
template <int KW, int E, bool CUT>
__device__ __forceinline__ int block_levels(uint32_t* sm, int plane, int len,
                                            int pieces, int cut) {
  const int e0 = threadIdx.x * E;
  uint32_t key[E][KW];
  for (; pieces > 1; pieces >>= 1) {
    int outlen = 2 * len, pair, d0;
    bool active = true;
    if constexpr (CUT) {
      outlen = cut < outlen ? cut : outlen;
      active = e0 < (pieces >> 1) * outlen;
      d0 = e0 & (outlen - 1);
      pair = (e0 - d0) / outlen * 2 * len;
    } else {
      pair = e0 & ~(2 * len - 1);
      d0 = e0 - pair;
    }
    // a pair never crosses a multiple of 32 that it does not start at, so
    // spad of the pair's start plus spad of an index within it is spad of
    // their sum
    if (active) {
      merge_thread<KW, E>(sm + spad(pair), plane, len, len, d0, E, key);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int i = 0; i < E; ++i) smem_store<KW>(sm, plane, e0 + i, key[i]);
    }
    __syncthreads();
    len = outlen;
  }
  return len;
}

// What a register tile stores.
enum class TileOut {
  Sorted,  // K4: the tile ascending, in place
  Runs,    // K8: each run ascending, a row's odd runs reversed (rows of
           // alt runs; alt 0 reverses none); a last partial tile padded
  Cut      // K9: the tile's first min(cut, tile) entries, packed
};

// One CTA sorts `tile` consecutive keys of each plane (tile / E threads):
// E keys a thread in registers, then the block's merge levels in shared
// memory.  run: for Runs the run (levels stop there), for Cut the cut, for
// Sorted the tile.  Cut first moves the tile's valid keys to its front (a
// ballot scan; their order does not matter) and sorts only the smallest
// power of two >= E that holds them: sentinels sort last, so the rest of
// the tile is sentinels in any order, and a tile of the finish's sparse
// candidates takes a few levels where a full one takes log2(tile / E).
template <int KW, int E, int THREADS, TileOut OUT>
__global__ void __launch_bounds__(THREADS) reg_tile_sort_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
    int64_t total, int tile, int run, int64_t alt) {
  extern __shared__ uint32_t sm[];
  const int plane = tile + tile / 32;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  uint32_t key[E][KW];
  // coalesced loads, all in flight at once (tile == E * blockDim.x)
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int64_t i = base + threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      if constexpr (OUT == TileOut::Runs) {
        key[k][q] = i < total ? in[q * total + i] : SENT;
      } else {
        key[k][q] = in[q * total + i];
      }
    }
  }
  int span = tile;                               // the entries to sort
  if constexpr (OUT == TileOut::Cut) {
    __shared__ int wsum[129];
    const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
    unsigned ballot[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      bool valid = false;
#pragma unroll
      for (int q = 0; q < KW; ++q) valid |= key[k][q] != SENT;
      ballot[k] = __ballot_sync(FULL, valid);
      scan_publish(k * warps + (threadIdx.x >> 5), ballot[k], wsum);
    }
    const int valid = scan_groups(E * warps, wsum);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if ((ballot[k] >> lane) & 1) {
        smem_store<KW>(sm, plane,
                       wsum[k * warps + (threadIdx.x >> 5)] +
                           __popc(ballot[k] & ((1u << lane) - 1)),
                       key[k]);
      }
    }
    span = valid <= E ? E : 1 << (32 - __clz(valid - 1));
    for (int e = valid + threadIdx.x; e < span; e += blockDim.x) {
#pragma unroll
      for (int q = 0; q < KW; ++q) sm[q * plane + spad(e)] = SENT;
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      smem_store<KW>(sm, plane, threadIdx.x + k * blockDim.x, key[k]);
    }
  }
  __syncthreads();
  const int e0 = threadIdx.x * E;
  if (OUT != TileOut::Cut || e0 < span) {
#pragma unroll
    for (int i = 0; i < E; ++i) smem_key<KW>(sm, plane, e0 + i, key[i]);
    register_sort<KW, E>(key);
#pragma unroll
    for (int i = 0; i < E; ++i) smem_store<KW>(sm, plane, e0 + i, key[i]);
  }
  __syncthreads();
  const int len = block_levels<KW, E, OUT == TileOut::Cut>(
      sm, plane, E, (OUT == TileOut::Runs ? run : span) / E, run);
  if constexpr (OUT == TileOut::Cut) {
    // the first min(cut, tile) entries: the sorted span, then sentinels
    const int cut = run < tile ? run : tile;
    const int64_t total_out = total / tile * cut;
    for (int e = threadIdx.x; e < cut; e += blockDim.x) {
#pragma unroll
      for (int q = 0; q < KW; ++q) {
        out[q * total_out + blockIdx.x * static_cast<int64_t>(cut) + e] =
            e < len ? sm[q * plane + spad(e)] : SENT;
      }
    }
    return;
  }
  const int lg_run = __ffs(run) - 1;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    int64_t i = base + e;
    if constexpr (OUT == TileOut::Runs) {
      if (i >= total) break;
      if (alt > 0 && (static_cast<uint32_t>(i >> lg_run) %
                      static_cast<uint32_t>(alt)) & 1) {
        i ^= run - 1;                    // the mirror place in its run
      }
    }
#pragma unroll
    for (int q = 0; q < KW; ++q) out[q * total + i] = sm[q * plane + spad(e)];
  }
}

// K9's steps 2 and 3 in one CTA a segment: the segment's `pieces` packed
// ascending pieces of len entries (pieces * len <= CUT_KEYS, MERGE_E a
// thread) to its first min(keep, pieces * len) entries, packed, every
// level in shared memory.
template <int KW>
__global__ void __launch_bounds__(CUT_THREADS) cut_merge_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int len,
    int pieces, int keep) {
  extern __shared__ uint32_t sm[];
  const int span = pieces * len;
  const int plane = span + span / 32;
  const int64_t total_in = static_cast<int64_t>(gridDim.x) * span;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * span;
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      sm[q * plane + spad(e)] = in[q * total_in + base + e];
    }
  }
  __syncthreads();
  len = block_levels<KW, MERGE_E, true>(sm, plane, len, pieces, keep);
  const int64_t total_out = static_cast<int64_t>(gridDim.x) * len;
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      out[q * total_out + blockIdx.x * static_cast<int64_t>(len) + e] =
          sm[q * plane + spad(e)];
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

// One level of the tiles' sorts: pairs of runs of len entries (plane
// stride total_in) to their first outlen (>= MERGE_TILE) outputs each
// (plane stride total_out); with alt > 0 a row's odd pairs (rows of alt
// pairs) stored reversed.
template <int KW>
int sort_level(const uint32_t* in, uint32_t* out, int64_t total_in,
               int64_t total_out, int64_t len, int64_t outlen, int64_t alt,
               cudaStream_t stream) {
  const auto grid = static_cast<unsigned>(total_out / MERGE_TILE);
  const size_t smem = sizeof(uint32_t) * KW * MERGE_PLANE;
  if (alt > 0) {
    sort_level_kernel<KW, true><<<grid, MERGE_THREADS, smem, stream>>>(
        in, out, total_in, total_out, len, outlen, alt);
  } else {
    sort_level_kernel<KW, false><<<grid, MERGE_THREADS, smem, stream>>>(
        in, out, total_in, total_out, len, outlen, 0);
  }
  return last_error();
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
      reg_tile_sort_kernel<KW, E, TILE_THREADS, TileOut::Sorted>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  reg_tile_sort_kernel<KW, E, TILE_THREADS, TileOut::Sorted>
      <<<static_cast<unsigned>(total / tile), tile / E,
         sizeof(uint32_t) * KW * (tile + tile / 32), stream>>>(
          in, src, total, tile, tile, 0);
  int err = last_error();
  for (int l = 0; l < levels && err == 0; ++l) {
    uint32_t* dst = ((levels - 1 - l) & 1) ? scratch : out;
    const int64_t len = static_cast<int64_t>(tile) << l;
    err = sort_level<KW>(src, dst, total, total, len, 2 * len, 0, stream);
    src = dst;
  }
  return err;
}

// K8's and K9's register tiles (RUN_E keys a thread, tile / RUN_E threads)
// over `total` entries.
template <int KW, TileOut OUT>
int run_tiles(const uint32_t* in, uint32_t* out, int64_t total, int tile,
              int run, int64_t alt, cudaStream_t stream) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      reg_tile_sort_kernel<KW, RUN_E, RUN_THREADS, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(uint32_t) * KW * (RUN_TILE + RUN_TILE / 32))));
  if (attr != 0) return attr;
  reg_tile_sort_kernel<KW, RUN_E, RUN_THREADS, OUT>
      <<<static_cast<unsigned>((total + tile - 1) / tile), tile / RUN_E,
         sizeof(uint32_t) * KW * (tile + tile / 32), stream>>>(
          in, out, total, tile, run, alt);
  return last_error();
}

// K8's tile for runs of `run`: 2,048 entries up to runs of 2,048, else
// 4,096 (at 2 runs of 2,048 a row, tiles of 4,096 took 31% longer on an
// H100: the same levels in CTAs of 512 threads, PERF.md).
int64_t runs_tile(int64_t run) {
  return run <= RUN_TILE_MIN ? RUN_TILE_MIN : RUN_TILE;
}

// K8: sorts each of a row's m / run runs (rows of m entries, g * m in
// all), odd runs reversed: the tiles, then log2(run / tile) levels, which
// alternate between out and scratch (g * m entries a plane; null when run
// <= 4,096) so that the last writes out.
template <int KW>
int sort_runs(const uint32_t* in, uint32_t* out, uint32_t* scratch,
              int64_t g, int64_t m, int64_t run, cudaStream_t stream) {
  const int64_t total = g * m, alt = m / run;
  const int64_t tile = runs_tile(run);
  int levels = 0;
  for (int64_t r = tile; r < run; r <<= 1) ++levels;
  if (levels > 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint32_t* src = (levels & 1) ? scratch : out;
  int err = run_tiles<KW, TileOut::Runs>(
      in, src, total, static_cast<int>(tile),
      static_cast<int>(levels ? tile : run), levels ? 0 : alt, stream);
  for (int l = 0; l < levels && err == 0; ++l) {
    uint32_t* dst = ((levels - 1 - l) & 1) ? scratch : out;
    const int64_t len = tile << l;
    err = sort_level<KW>(src, dst, total, total, len, 2 * len,
                         l == levels - 1 ? alt : 0, stream);
    src = dst;
  }
  return err;
}

// The launches of cut_merge below: `levels` cut to keep while a segment's
// pieces overflow CUT_KEYS, then one in shared memory if more than one
// piece is left.
int cut_merge_launches(int64_t pieces, int64_t len, int64_t keep,
                       int* levels) {
  *levels = 0;
  for (; pieces > 1 && pieces * len > CUT_KEYS; pieces >>= 1, ++*levels) {
    len = 2 * len < keep ? 2 * len : keep;
  }
  return *levels + (pieces > 1 ? 1 : 0);
}

// K9's merge of pieces: each of nseg segments holds `pieces` ascending
// pieces of len entries, packed in src, and keeps its first keep entries
// (keep <= pieces * len), packed in dst: levels cut to keep
// (sort_level_kernel), then cut_merge_kernel for the rest.  The last
// launch writes dst, the others tmp and src in turn (tmp the size of src,
// which is overwritten).
template <int KW>
int cut_merge(uint32_t* src, uint32_t* dst, uint32_t* tmp, int64_t nseg,
              int64_t pieces, int64_t len, int64_t keep,
              cudaStream_t stream) {
  int levels;
  const int launches = cut_merge_launches(pieces, len, keep, &levels);
  uint32_t* const spare = src;
  int err = 0;
  for (int l = 0; l < launches && err == 0; ++l) {
    uint32_t* to = l == launches - 1 ? dst : (l & 1) ? spare : tmp;
    if (l < levels) {
      const int64_t outlen = 2 * len < keep ? 2 * len : keep;
      err = sort_level<KW>(src, to, nseg * pieces * len,
                           nseg * (pieces / 2) * outlen, len, outlen, 0,
                           stream);
      pieces /= 2;
      len = outlen;
    } else {
      static const int attr = static_cast<int>(cudaFuncSetAttribute(
          cut_merge_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sizeof(uint32_t) * KW *
                           (CUT_KEYS + CUT_KEYS / 32))));
      if (attr != 0) return attr;
      const int span = static_cast<int>(pieces * len);
      cut_merge_kernel<KW><<<static_cast<unsigned>(nseg), span / MERGE_E,
                             sizeof(uint32_t) * KW * (span + span / 32),
                             stream>>>(src, to, static_cast<int>(len),
                                       static_cast<int>(pieces),
                                       static_cast<int>(keep));
      err = last_error();
    }
    src = to;
  }
  return err;
}

// K9's scratch, u32 words a plane: step 1's pieces (np), the packed cuts
// (g * capacity), and a second np when step 2 takes two launches or more.
int64_t truncate_scratch(int64_t g, int64_t m, int64_t capacity) {
  const int64_t cut = capacity / (m / TRUNC_TILE);
  const int64_t cutc = cut < RUN_TILE ? cut : RUN_TILE;
  const int64_t np = g * m / RUN_TILE * cutc;
  int levels;
  const int steps = cut_merge_launches(TRUNC_TILE / RUN_TILE, cutc, cut,
                                       &levels);
  return np * (steps > 1 ? 2 : 1) + g * capacity;
}

// K9: per row (m = t * 32,768 entries), each tile's cut = capacity / t
// smallest entries, merged into out (g, capacity).  scratch holds
// KW * truncate_scratch(g, m, capacity) words.
template <int KW>
int sort_truncate(const uint32_t* in, uint32_t* scratch, uint32_t* out,
                  int64_t g, int64_t m, int64_t capacity,
                  cudaStream_t stream) {
  const int64_t t = m / TRUNC_TILE, cut = capacity / t;
  const int64_t cutc = cut < RUN_TILE ? cut : RUN_TILE;
  const int64_t np = g * m / RUN_TILE * cutc;
  uint32_t* pieces = scratch;
  uint32_t* cuts = pieces + KW * np;
  uint32_t* tmp = cuts + KW * g * capacity;
  int err = run_tiles<KW, TileOut::Cut>(
      in, pieces, g * m, RUN_TILE, static_cast<int>(cut), 0, stream);
  if (err == 0) {
    err = cut_merge<KW>(pieces, cuts, tmp, g * t, TRUNC_TILE / RUN_TILE,
                        cutc, cut, stream);
  }
  if (err != 0) return err;
  if (capacity <= CUT_KEYS) {
    return cut_merge<KW>(cuts, out, nullptr, g, t, cut, capacity, stream);
  }
  return merge_runs<KW>(cuts, out, pieces, g * capacity, cut, capacity,
                        stream);
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

// K8's scratch in u32 words: kw * g * m when runs are longer than a tile
// (4,096 entries), else 0.
extern "C" int64_t sks_sort_runs_scratch(int kw, int g, int64_t m,
                                         int64_t run) {
  return run > sks::RUN_TILE ? int64_t{kw} * g * m : 0;
}

// K8: in, out (kw, g, m) u32; each row's runs of `run` entries (a power of
// two >= 128 dividing m) sorted independently, run i of the row ascending
// if i is even and descending if odd.  scratch: sks_sort_runs_scratch
// words (null when 0).  None may alias another.
extern "C" int sks_sort_runs(const void* in, void* out, void* scratch,
                             int kw, int g, int64_t m, int64_t run,
                             void* stream) {
  if (g <= 0 || run < 128 || !sks::pow2(run) || m % run != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto* t = static_cast<uint32_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return sks::sort_runs<1>(i, o, t, g, m, run, s);
    case 2: return sks::sort_runs<2>(i, o, t, g, m, run, s);
    case 3: return sks::sort_runs<3>(i, o, t, g, m, run, s);
    case 4: return sks::sort_runs<4>(i, o, t, g, m, run, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9's contract: m = t * 32768 with t >= 2 a power of two, capacity / t a
// power of two in [128, 32768].
static bool truncate_shape(int g, int64_t m, int64_t capacity) {
  const int64_t t = m / sks::TRUNC_TILE;
  return g > 0 && m % sks::TRUNC_TILE == 0 && t >= 2 && sks::pow2(t) &&
         capacity % t == 0 && capacity / t >= 128 &&
         sks::pow2(capacity / t) && capacity / t <= sks::TRUNC_TILE;
}

// K9's scratch in u32 words, -1 for a shape K9 does not take.
extern "C" int64_t sks_sort_truncate_scratch(int kw, int g, int64_t m,
                                             int64_t capacity) {
  if (!truncate_shape(g, m, capacity)) return -1;
  return int64_t{kw} * sks::truncate_scratch(g, m, capacity);
}

// K9: in (kw, g, m) u32 -> out (kw, g, capacity) u32: per row, the
// capacity / t smallest entries of each 32,768-entry tile, merged
// ascending.  scratch: sks_sort_truncate_scratch words.  None may alias
// another.
extern "C" int sks_sort_truncate(const void* in, void* scratch, void* out,
                                 int kw, int g, int64_t m, int64_t capacity,
                                 void* stream) {
  if (!truncate_shape(g, m, capacity)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i = static_cast<const uint32_t*>(in);
  auto* t = static_cast<uint32_t*>(scratch);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return sks::sort_truncate<1>(i, t, o, g, m, capacity, s);
    case 2: return sks::sort_truncate<2>(i, t, o, g, m, capacity, s);
    case 3: return sks::sort_truncate<3>(i, t, o, g, m, capacity, s);
    case 4: return sks::sort_truncate<4>(i, t, o, g, m, capacity, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
