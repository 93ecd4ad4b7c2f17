// K1, K7 and K11: fused spaced-seed extract + boost hash + FracMinHash
// filter, one kernel template with two sources of run ids, two sources of
// seeds and two outputs.
//
// Replaces spaced_kmer_sketching_tpu/ops/pallas/extract.py::_compact_kernel
// (K1: entry extract_compact_windows_prepacked, body _extract_block_packed,
// epilogue _compact_epilogue), ::_compact_raw_kernel (K7: entry
// extract_compact_windows_raw) and ::_kernel (K11: entry
// extract_filter_windows_batched), ported by their contract, not their
// Mosaic schedule: no 16x-repeated window-index planes, no lane/sublane
// rolls, no MXU cumsum.  For genome g and window t:
//   S     = the 128 bits of the 2-bit code stream from code t (code t+j at
//           bits 2j..2j+1), read from raw packed words, 16 codes per u32,
//           LSB first (utils/native.pack2bit);
//   rc    = ~S & mask       (complement code 3-c == ~c, same positions);
//   fwd   = (nucleotide-reverse of S) >> (128 - 2w), & mask;
//   key   = fwd if fwd < rc (strictly, as 128-bit values) else rc;
//   valid = rid(t) == rid(t+w-1) >= 0;
//   keep  = valid and (boost_hash(key) ^ salt) % scale == 0.
// The run ids come from one of two places:
//   K1 (RunPlane):  an int32 plane, rid(t) = rid[g][t] for t < n, else -1;
//   K7 (RunBounds): the genome's sorted run starts bounds[g][0..K), rid0[g]
//                   and vlen[g]: rid(t) = rid0 + #(bounds <= t) for
//                   0 <= t < min(vlen, n), else -1, n = 16 * packed words.
//                   So a window is valid iff t+w-1 < min(vlen, n),
//                   rid0 + #(bounds <= t) >= 0 and no bound lies in
//                   (t, t+w-1].
// K1 and K7 (CompactRows): each 128-window row writes its first k_slots
// kept keys in window order (low `out_words` words only) with all-ones
// fill, plus its TRUE kept count, so a caller detects slot overflow
// exactly.  K11 (EmitAll): every window t < nw writes its four key words,
// computed whether or not the window is valid, and its keep flag.  Window,
// mask, salt, scale and the hash variant are runtime arguments: one build
// serves every (window, k) config of a sweep.  The mask and salt are
// either kernel arguments (OneSeed: grid row y is genome y) or rows of a
// device array (SeedRows, K1's and K7's seed-batch mode: grid row y is
// seed y, and every seed reads the one shared genome, so S seeds cost one
// launch and one read of the genome: the TPU kernel's `shared` DMA).
//
// What bounds it on an H100: instruction throughput, not bytes.  A window
// reads ~4.25 B in K1 (one int32 run id, a sixteenth of four code words;
// K7 reads no run-id plane at all) but a valid one executes ~320
// instructions: two 64-bit bit reversals, ~10 64-bit multiplies of the
// hash and a 64-bit modulo (114 for every window and 203 more for a valid
// one in the compiled code, as chip_smoke.py counts them from the SASS).
// At n = 8.4M windows, 5M of them valid, that is ~36 MB of traffic (about
// 11 us at 3.35 TB/s) against ~2e9 instructions (~60 us at the card's
// limit of 132 SMs x 4 warp instructions a clock).  The design
// therefore keeps everything in registers: one thread per window, the key
// and hash in native 64-bit arithmetic (the TPU kernel emulated 64-bit on
// u32 lane pairs), neighbouring threads read the same packed words
// (broadcast, coalesced), and the row ranking costs four
// __ballot_sync/__popc and one shared-memory exchange per 128 windows.
// K7's run id is an upper-bound binary search of the genome's bounds row
// in global memory, ~log2(K) + 2 loads a thread: the threads of a block
// search neighbouring positions, so they read the same few cache lines
// (L1 hits), and K has no limit (the TPU kernel kept the bounds in SMEM
// and its caller fell back to XLA past g * K = 4096).
#include "common.cuh"

namespace sks {
namespace {

__device__ __forceinline__ uint64_t hash_mix(uint64_t x) {
  const uint64_t m = 0x0E9846AF9B1A615DULL;
  x ^= x >> 32;
  x *= m;
  x ^= x >> 32;
  x *= m;
  x ^= x >> 28;
  return x;
}

// boost >= 1.81 hash_combine
__device__ __forceinline__ uint64_t combine_modern(uint64_t seed, uint64_t v) {
  return hash_mix(seed + 0x9E3779B9ULL + v);
}

// boost < 1.81 hash_combine_impl<64>
__device__ __forceinline__ uint64_t combine_legacy(uint64_t h, uint64_t k) {
  const uint64_t m = 0xC6A4A7935BD1E995ULL;
  k *= m;
  k ^= k >> 47;
  k *= m;
  h ^= k;
  h *= m;
  return h + 0xE6546B64ULL;
}

// boost::hash_value of a 128-bit dynamic_bitset with blocks {lo, hi}
__device__ __forceinline__ uint64_t hash_bitset128(uint64_t lo, uint64_t hi,
                                                   bool legacy) {
  if (legacy) {
    return combine_legacy(128, combine_legacy(combine_legacy(0, lo), hi));
  }
  return combine_modern(128, combine_modern(combine_modern(0, lo), hi));
}

// Reverse the 32 2-bit groups of x, keeping each group's bit order.
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ULL) |
         ((x & 0x5555555555555555ULL) << 1);
}

__device__ __forceinline__ uint32_t key_word(uint64_t lo, uint64_t hi,
                                             int q) {
  const uint64_t w = q < 2 ? lo : hi;
  return static_cast<uint32_t>((q & 1) ? (w >> 32) : w);
}

// K1's run ids: an int32 plane of n positions per genome.
struct RunPlane {
  const int32_t* rid;
  int64_t n;
};

// K7's run ids: k sorted run starts per genome, the id of the run open at
// position 0, the genome's code count, and the packed positions n.
struct RunBounds {
  const int32_t* bounds;
  int k;
  const int32_t* rid0;
  const int32_t* vlen;
  int64_t n;
};

__device__ __forceinline__ bool window_valid(const RunPlane& s, int64_t g,
                                             int64_t t, int64_t last) {
  if (last >= s.n) return false;
  const int32_t* rg = s.rid + g * s.n;
  const int32_t ra = rg[t];
  return ra >= 0 && ra == rg[last];
}

__device__ __forceinline__ bool window_valid(const RunBounds& s, int64_t g,
                                             int64_t t, int64_t last) {
  if (last >= s.n || last >= s.vlen[g]) return false;
  const int32_t* bg = s.bounds + g * s.k;
  int lo = 0, hi = s.k;  // upper bound: lo = #(bounds <= t)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bg[mid] <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return s.rid0[g] + lo >= 0 && (lo == s.k || bg[lo] > last);
}

// One seed for every grid row (grid row y = genome y), or one seed per
// grid row over ONE shared genome (seed-batch mode: grid row y = seed y,
// genome row stride 0; BASELINE config 3's S seeds in one launch).
struct Seed {
  uint64_t mask_lo, mask_hi, salt;
};

struct OneSeed {
  Seed s;
  __device__ __forceinline__ Seed get(int64_t) const { return s; }
  __device__ __forceinline__ int64_t genome(int64_t y) const { return y; }
};

struct SeedRows {
  const uint64_t* rows;  // (S, 3): mask_lo, mask_hi, salt of seed y
  __device__ __forceinline__ Seed get(int64_t y) const {
    return {rows[3 * y], rows[3 * y + 1], rows[3 * y + 2]};
  }
  __device__ __forceinline__ int64_t genome(int64_t) const { return 0; }
};

// The canonical masked key of the window starting at code t, from raw
// packed words (zero past the last word).
__device__ __forceinline__ void canonical_key(const uint32_t* pg,
                                              int64_t packed_words, int64_t t,
                                              int window, const Seed& sd,
                                              uint64_t& key_lo,
                                              uint64_t& key_hi) {
  const int64_t a = t >> 4;
  const int o = 2 * static_cast<int>(t & 15);
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    v[i] = (a + i < packed_words) ? pg[a + i] : 0u;
  }
  const uint64_t w0 = v[0] | (static_cast<uint64_t>(v[1]) << 32);
  const uint64_t w1 = v[2] | (static_cast<uint64_t>(v[3]) << 32);
  const uint64_t w2 = v[4];
  // o == 0 would shift by 64, which C++ leaves undefined
  const uint64_t s_lo = o ? (w0 >> o) | (w1 << (64 - o)) : w0;
  const uint64_t s_hi = o ? (w1 >> o) | (w2 << (64 - o)) : w1;
  const uint64_t rc_lo = ~s_lo & sd.mask_lo;
  const uint64_t rc_hi = ~s_hi & sd.mask_hi;
  uint64_t f_lo = rev2(s_hi);
  uint64_t f_hi = rev2(s_lo);
  const int s = 128 - 2 * window;  // 0 (w = 64) .. 126
  if (s >= 64) {
    f_lo = f_hi >> (s - 64);
    f_hi = 0;
  } else if (s > 0) {
    f_lo = (f_lo >> s) | (f_hi << (64 - s));
    f_hi >>= s;
  }
  f_lo &= sd.mask_lo;
  f_hi &= sd.mask_hi;
  const bool fwd = f_hi < rc_hi || (f_hi == rc_hi && f_lo < rc_lo);
  key_lo = fwd ? f_lo : rc_lo;
  key_hi = fwd ? f_hi : rc_hi;
}

// K1/K7 output: each 128-window row's first k_slots kept keys (low
// out_words words) with all-ones fill, and its true kept count.
struct CompactRows {
  uint32_t* out;
  int32_t* rowcnt;
  int64_t rows;
  int k_slots;
  int out_words;
  static constexpr bool kKeyEverywhere = false;

  __device__ __forceinline__ void store(int64_t y, int64_t row, int64_t,
                                        bool keep, uint64_t key_lo,
                                        uint64_t key_hi) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned ballot = __ballot_sync(FULL, keep);
    __shared__ int wcnt[LANES / 32];
    if (lane == 0) wcnt[warp] = __popc(ballot);
    __syncthreads();
    int base = 0;
#pragma unroll
    for (int i = 0; i < LANES / 32; ++i) base += (i < warp) ? wcnt[i] : 0;
    const int total = wcnt[0] + wcnt[1] + wcnt[2] + wcnt[3];
    const int rank = base + __popc(ballot & ((1u << lane) - 1u));

    const int64_t plane = static_cast<int64_t>(gridDim.y) * rows * k_slots;
    uint32_t* o = out + (y * rows + row) * k_slots;
    if (keep && rank < k_slots) {
      for (int q = 0; q < out_words; ++q) {
        o[q * plane + rank] = key_word(key_lo, key_hi, q);
      }
    }
    const int filled = min(total, k_slots);
    if (static_cast<int>(threadIdx.x) >= filled &&
        static_cast<int>(threadIdx.x) < k_slots) {
      for (int q = 0; q < out_words; ++q) o[q * plane + threadIdx.x] = SENT;
    }
    if (threadIdx.x == 0) rowcnt[y * rows + row] = total;
  }
};

// K11 output: every window's four key words and keep flag, no compaction.
// The key is computed at every window t < nw, valid or not, as the TPU
// kernel does.
struct EmitAll {
  uint32_t* canon;   // (4, G, nw)
  uint8_t* keep;     // (G, nw), 0 or 1
  int64_t nw;
  static constexpr bool kKeyEverywhere = true;

  __device__ __forceinline__ void store(int64_t y, int64_t, int64_t t,
                                        bool kept, uint64_t key_lo,
                                        uint64_t key_hi) const {
    if (t >= nw) return;
    const int64_t plane = static_cast<int64_t>(gridDim.y) * nw;
    const int64_t i = y * nw + t;
#pragma unroll
    for (int q = 0; q < 4; ++q) canon[q * plane + i] = key_word(key_lo, key_hi, q);
    keep[i] = kept;
  }
};

// grid (rows, Y), block 128: one thread per window of one 128-window row
// of grid row y (a genome, or a seed over the shared genome)
template <class Runs, class Seeds, class Out>
__global__ void __launch_bounds__(LANES) extract_kernel(
    const uint32_t* __restrict__ packed, int64_t packed_words, Runs runs,
    int window, Seeds seeds, uint32_t scale, bool legacy, Out out) {
  const int64_t row = blockIdx.x;
  const int64_t y = blockIdx.y;
  const int64_t t = row * LANES + threadIdx.x;
  const int64_t g = seeds.genome(y);
  const Seed sd = seeds.get(y);

  const bool valid = window_valid(runs, g, t, t + window - 1);
  bool keep = false;
  uint64_t key_lo = 0, key_hi = 0;
  if (valid || Out::kKeyEverywhere) {
    canonical_key(packed + g * packed_words, packed_words, t, window, sd,
                  key_lo, key_hi);
    keep = valid &&
           (hash_bitset128(key_lo, key_hi, legacy) ^ sd.salt) % scale == 0;
  }
  out.store(y, row, t, keep, key_lo, key_hi);
}

template <class Runs, class Seeds, class Out>
int launch(const void* packed, int64_t packed_words, Runs runs, int ys,
           int64_t rows, int window, Seeds seeds, int scale, int legacy,
           Out out, void* stream) {
  if (ys <= 0 || ys > 65535 || rows <= 0 || window < 1 || window > 64 ||
      scale < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(ys));
  extract_kernel<Runs, Seeds, Out><<<grid, LANES, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), packed_words, runs, window, seeds,
      static_cast<uint32_t>(scale), legacy != 0, out);
  return last_error();
}

// K1/K7: one seed per genome row, or (seeds non-null) seed-batch mode with
// g seeds over genome row 0.
template <class Runs>
int launch_compact(const void* packed, int64_t packed_words, Runs runs,
                   int g, int64_t rows, int window, uint64_t mask_lo,
                   uint64_t mask_hi, uint64_t salt, const void* seeds,
                   int scale, int legacy, int k_slots, int out_words,
                   void* out, void* rowcnt, void* stream) {
  if (k_slots < 1 || k_slots > LANES || out_words < 1 || out_words > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CompactRows o{static_cast<uint32_t*>(out),
                      static_cast<int32_t*>(rowcnt), rows, k_slots,
                      out_words};
  if (seeds != nullptr) {
    const SeedRows sr{static_cast<const uint64_t*>(seeds)};
    return launch(packed, packed_words, runs, g, rows, window, sr, scale,
                  legacy, o, stream);
  }
  const OneSeed one{{mask_lo, mask_hi, salt}};
  return launch(packed, packed_words, runs, g, rows, window, one, scale,
                legacy, o, stream);
}

}  // namespace
}  // namespace sks

// K1.  packed (G, packed_words) u32; rid (G, n) i32 with
// 16 * packed_words >= n; out (out_words, G, rows * k_slots) u32;
// rowcnt (G, rows) i32.  Seed-batch mode (seeds non-null): seeds (g, 3)
// u64 rows [mask_lo, mask_hi, salt], packed and rid hold ONE genome row
// that every seed reads, out and rowcnt one row per seed; mask_lo,
// mask_hi and salt are then not read.
extern "C" int sks_extract_compact(
    const void* packed, int64_t packed_words, const void* rid, int64_t n,
    int g, int64_t rows, int window, uint64_t mask_lo, uint64_t mask_hi,
    uint64_t salt, const void* seeds, int scale, int legacy, int k_slots,
    int out_words, void* out, void* rowcnt, void* stream) {
  if (16 * packed_words < n) return static_cast<int>(cudaErrorInvalidValue);
  const sks::RunPlane runs{static_cast<const int32_t*>(rid), n};
  return sks::launch_compact(packed, packed_words, runs, g, rows, window,
                             mask_lo, mask_hi, salt, seeds, scale, legacy,
                             k_slots, out_words, out, rowcnt, stream);
}

// K7.  packed (G, packed_words) u32; bounds (G, k_bounds) i32, each row
// ascending; rid0 and vlen (G,) i32; out, rowcnt and seeds as K1's (in
// seed-batch mode bounds, rid0 and vlen hold one genome row).
extern "C" int sks_extract_compact_raw(
    const void* packed, int64_t packed_words, const void* bounds,
    int k_bounds, const void* rid0, const void* vlen, int g, int64_t rows,
    int window, uint64_t mask_lo, uint64_t mask_hi, uint64_t salt,
    const void* seeds, int scale, int legacy, int k_slots, int out_words,
    void* out, void* rowcnt, void* stream) {
  if (k_bounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  const sks::RunBounds runs{static_cast<const int32_t*>(bounds), k_bounds,
                            static_cast<const int32_t*>(rid0),
                            static_cast<const int32_t*>(vlen),
                            16 * packed_words};
  return sks::launch_compact(packed, packed_words, runs, g, rows, window,
                             mask_lo, mask_hi, salt, seeds, scale, legacy,
                             k_slots, out_words, out, rowcnt, stream);
}

// K11.  packed (G, packed_words) u32 and rid (G, n) i32 as K1's; canon
// (4, G, nw) u32 every window's canonical key, keep (G, nw) u8.
extern "C" int sks_extract_filter(
    const void* packed, int64_t packed_words, const void* rid, int64_t n,
    int g, int64_t nw, int window, uint64_t mask_lo, uint64_t mask_hi,
    uint64_t salt, int scale, int legacy, void* canon, void* keep,
    void* stream) {
  if (16 * packed_words < n || nw < 1 || nw > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sks::RunPlane runs{static_cast<const int32_t*>(rid), n};
  const sks::OneSeed one{{mask_lo, mask_hi, salt}};
  const sks::EmitAll out{static_cast<uint32_t*>(canon),
                         static_cast<uint8_t*>(keep), nw};
  const int64_t rows = (nw + sks::LANES - 1) / sks::LANES;
  return sks::launch(packed, packed_words, runs, g, rows, window, one, scale,
                     legacy, out, stream);
}
