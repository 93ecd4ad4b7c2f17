// K1, K7 and K11: fused spaced-seed extract + boost hash + FracMinHash
// filter, one sliding kernel template with two sources of run ids, two
// sources of seeds and two outputs.
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
//   K1, K11 (RunPlane): an int32 plane, rid(t) = rid[g][t] for t < n, else
//                   -1; any plane, not only one of ascending runs;
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
// What bounds it on an H100: instruction issue, not bytes.  A window
// reads ~4.25 B in K1 (one int32 run id, a sixteenth of four code words;
// K7 reads no run-id plane at all) but a valid one needs the boost hash
// (six 64-bit multiplies, shifts and xors), the canonical choice between
// two masked 128-bit strands and the FracMinHash filter.  At n = 8.4M
// windows, 5M of them valid, that is ~36 MB of traffic (about 11 us at
// 3.35 TB/s) against ~0.6e9 instructions that no design can skip (~18 us
// at the card's limit of 132 SMs x 4 warp instructions a clock: 18 a
// window for the slide, 90 a valid one for the select, the hash and the
// filter, as chip_smoke.py counts them from the SASS of probes).  K11
// writes 17 B a window, so bytes bound it (PERF.md).  So every design
// here keeps the key and the hash in registers, in native 64-bit
// arithmetic (the TPU kernel emulated 64-bit on u32 lane pairs), and the
// filter divides by nothing: (h ^ salt) % scale is a multiply-high by a
// reciprocal the wrapper computes once per launch, a shift, a multiply
// and a subtract (fmh_keep: Granlund and Montgomery's round-up method,
// exact for every 64-bit h and every scale in 1..2^31 - 1).
//
// One body serves all three (slide_kernel).  A thread takes C
// consecutive windows (C = 32 in K1 and K7, 8 in K11) from t0 = C x its
// index: it reads the words its windows touch once (at most seven), builds
// both strands at t0 and then, from window t to t + 1, shifts one code
// into each (forward F << 2 | c[t + w]; the complement's source S >> 2 |
// c[t + 64] << 126), so a window costs its slide, the mask, the compare
// and, if valid, the hash and the filter.  Its run source first gives a
// C-bit validity word for the thread's windows:
//   RunBounds: one upper-bound search of the genome's bounds row a thread
//     (not a window), then a walk forward as its windows pass run starts;
//   RunPlane: each warp stages rid[t .. t + 32 C - 1 + 63] of its 32 C
//     windows into a shared-memory slab in coalesced loads, element e at
//     e + e / C, so the 32 lanes' reads of rid[t] and rid[t + w - 1] fall
//     in 32 distinct banks at every step; one __syncwarp, no block
//     barrier.  The plane is read once.
// K1 and K7 skip a thread whose word is 0 (padding, a short genome).
// Four threads of one warp hold a 128-window row: each keeps a 32-bit
// kept mask, a shuffle scan over the four gives each its first slot, and
// each rebuilds (strands_at) and writes only its kept keys (on average 1
// in `scale` windows) below k_slots; no block barrier.  K has no limit
// (the TPU kernel kept the bounds in SMEM and its caller fell back to XLA
// past g * K = 4096).  K11 computes every window's key, hashes and
// filters the valid ones, stages the keys in its warp's shared memory and
// writes them, and the keep bytes, with the warp's lanes on consecutive
// windows (EmitAll).
#include "common.cuh"

namespace sks {
namespace {

constexpr int SLIDE_C = 32;                    // windows a K1/K7 thread
constexpr int EMIT_C = 8;                      // windows a K11 thread
constexpr int ROW_THREADS = LANES / SLIDE_C;   // K1/K7 threads a 128-window row
constexpr int SLIDE_THREADS = 256;             // threads a block
constexpr int SLIDE_WARPS = SLIDE_THREADS / 32;
constexpr int FAR = 1 << 30;                   // "no bound ahead"

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

// The FracMinHash divisor `scale` with its round-up reciprocal (Granlund
// and Montgomery 1994, figure 4.1), which the wrapper computes on the
// host once per launch (ops/cuda/extract.fmh_divisor): l = ceil(log2
// scale), magic = floor(2^64 (2^l - scale) / scale) + 1 < 2^64, sh1 =
// min(l, 1), sh2 = max(l - 1, 0).
struct Filter {
  uint64_t magic;
  uint32_t scale;
  int sh1, sh2;
};

// keep = (hash ^ salt) % scale == 0 with no division: q = floor(h /
// scale) = (t + ((h - t) >> sh1)) >> sh2 with t the high word of magic *
// h, exact for every 64-bit h; the remainder is h - q * scale.
__device__ __forceinline__ bool fmh_keep(uint64_t hash, uint64_t salt,
                                         const Filter& f) {
  const uint64_t h = hash ^ salt;
  const uint64_t t = __umul64hi(f.magic, h);
  const uint64_t q = (t + ((h - t) >> f.sh1)) >> f.sh2;
  return h - q * f.scale == 0;
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

// #(b[i] <= t) over an ascending row of k bounds: an upper-bound search.
__device__ __forceinline__ int bounds_at_or_below(const int32_t* b, int k,
                                                  int64_t t) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// RunPlane's slab for threads of C windows: a warp's 32 C windows and
// the w - 1 <= 63 positions past them, element e at slab_index<C>(e) = e
// + e / C, so that a lane's stride is C + 1 (odd) and the 32 lanes' reads
// of one step fall in 32 distinct banks.
template <int C>
__host__ __device__ constexpr int slab_index(int e) {
  return e + e / C;
}

// K1's and K11's run ids: an int32 plane of n positions per genome.
struct RunPlane {
  const int32_t* rid;
  int64_t n;

  template <int C>
  __host__ __device__ static constexpr int slab_ints() {
    return slab_index<C>(32 * C + 63 - 1) + 1;
  }

  // Bit i: window t0 + i (i < C) is valid, rid(t) == rid(t + w - 1) >= 0
  // with rid(t) = -1 at t >= n (JAX's _extract_block_packed).  Every lane
  // of the warp calls it: the warp stages its positions into `slab` first.
  template <int C>
  __device__ __forceinline__ uint32_t valid_word(int64_t g, int64_t t0,
                                                 int window,
                                                 int32_t* slab) const {
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const int64_t w0 = t0 - lane * C;             // the warp's first window
    const int32_t* rg = rid + g * n;
    const int span = 32 * C + window - 1;
    for (int e = lane; e < span; e += 32) {
      slab[slab_index<C>(e)] = w0 + e < n ? rg[w0 + e] : -1;
    }
    __syncwarp();
    const int a = lane * C;
    uint32_t bits = 0;
#pragma unroll 8
    for (int i = 0; i < C; ++i) {
      const int32_t ra = slab[slab_index<C>(a + i)];
      const int32_t rb = slab[slab_index<C>(a + i + window - 1)];
      bits |= static_cast<uint32_t>(ra >= 0 && ra == rb) << i;
    }
    return bits;
  }
};

// K7's run ids: k sorted run starts per genome, the id of the run open at
// position 0, the genome's code count, and the packed positions n.
struct RunBounds {
  const int32_t* bounds;
  int k;
  const int32_t* rid0;
  const int32_t* vlen;
  int64_t n;

  template <int C>
  __host__ __device__ static constexpr int slab_ints() {
    return 0;
  }

  // Bit i: window t0 + i (i < C) is valid: t + w - 1 <
  // min(vlen, n), rid0 + #(bounds <= t) >= 0 and no bound lies in (t, t +
  // w - 1].  One search of the bounds for t0, then cnt = #(bounds <= t)
  // and rel = (the first bound > t) - t0 kept as the windows pass.
  template <int C>
  __device__ __forceinline__ uint32_t valid_word(int64_t g, int64_t t0,
                                                 int window,
                                                 int32_t*) const {
    const int64_t lim = min(static_cast<int64_t>(vlen[g]), n);
    const int64_t room = lim - (window - 1) - t0;  // windows that end in lim
    if (room <= 0) return 0;
    const int iend = room < C ? static_cast<int>(room) : C;
    const int32_t* bg = bounds + g * k;
    const int64_t r0 = rid0[g];
    int cnt = bounds_at_or_below(bg, k, t0);
    auto next_rel = [&]() -> int {
      return cnt < k ? static_cast<int>(min(bg[cnt] - t0,
                                            static_cast<int64_t>(FAR)))
                     : FAR;
    };
    int rel = next_rel();
    bool ok = r0 + cnt >= 0;
    uint32_t bits = 0;
    for (int i = 0; i < C; ++i) {
      if (rel <= i) {  // a run starts at or before window i: walk past it
        do {
          ++cnt;
          rel = next_rel();
        } while (rel <= i);
        ok = r0 + cnt >= 0;
      }
      if (i < iend && ok && rel >= i + window) bits |= 1u << i;
    }
    return bits;
  }
};

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

// Both strands of the window starting at code t before the seed's mask
// (src/kmer_sliding.cpp:112-186 slides the same two):
//   f: the forward strand, code t + w - 1 at bits 0-1 and code t at bits
//      2w - 2 and 2w - 1; bits at 2w and above hold older codes (or 0),
//      which the mask drops;
//   s: the 64 codes from t, code t + j at bits 2j and 2j + 1; its
//      complement ~s is the reverse-complement strand (complement code
//      3 - c == ~c, at the same position).
struct Strands {
  uint64_t f_lo, f_hi, s_lo, s_hi;
};

// The next window's strands: code cf (t + w) enters f at the bottom, code
// cs (t + 64) enters s at the top.
__device__ __forceinline__ void slide(Strands& st, uint32_t cf, uint32_t cs) {
  st.f_hi = (st.f_hi << 2) | (st.f_lo >> 62);
  st.f_lo = (st.f_lo << 2) | cf;
  st.s_lo = (st.s_lo >> 2) | (st.s_hi << 62);
  st.s_hi = (st.s_hi >> 2) | (static_cast<uint64_t>(cs) << 62);
}

// The canonical masked key: the masked forward strand if it is strictly
// below the masked complement as a 128-bit value, else the complement.
__device__ __forceinline__ void strand_key(const Strands& st, const Seed& sd,
                                           uint64_t& key_lo,
                                           uint64_t& key_hi) {
  const uint64_t f_lo = st.f_lo & sd.mask_lo;
  const uint64_t f_hi = st.f_hi & sd.mask_hi;
  const uint64_t rc_lo = ~st.s_lo & sd.mask_lo;
  const uint64_t rc_hi = ~st.s_hi & sd.mask_hi;
  const bool fwd = f_hi < rc_hi || (f_hi == rc_hi && f_lo < rc_lo);
  key_lo = fwd ? f_lo : rc_lo;
  key_hi = fwd ? f_hi : rc_hi;
}

// Both strands of the window starting at code t, built from raw packed
// words (zero past the last word): s from five words, f its nucleotide
// reverse shifted down to the window's 2w bits.
__device__ __forceinline__ Strands strands_at(const uint32_t* pg,
                                              int64_t packed_words,
                                              int64_t t, int window) {
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
  Strands st;
  st.s_lo = o ? (w0 >> o) | (w1 << (64 - o)) : w0;
  st.s_hi = o ? (w1 >> o) | (w2 << (64 - o)) : w1;
  st.f_lo = rev2(st.s_hi);
  st.f_hi = rev2(st.s_lo);
  const int s = 128 - 2 * window;  // 0 (w = 64) .. 126
  if (s >= 64) {
    st.f_lo = st.f_hi >> (s - 64);
    st.f_hi = 0;
  } else if (s > 0) {
    st.f_lo = (st.f_lo >> s) | (st.f_hi << (64 - s));
    st.f_hi >>= s;
  }
  return st;
}

// The canonical masked key of the window starting at code t.
__device__ __forceinline__ void canonical_key(const uint32_t* pg,
                                              int64_t packed_words, int64_t t,
                                              int window, const Seed& sd,
                                              uint64_t& key_lo,
                                              uint64_t& key_hi) {
  strand_key(strands_at(pg, packed_words, t, window), sd, key_lo, key_hi);
}

// The C windows t0 .. t0 + C - 1 of one genome (C <= 32, t0 a multiple
// of 4): both strands built once at t0 and slid one code a window.
// Window i's key is computed where bit i of `valid` is set, or at every
// window (kKeyEverywhere, K11), and handed to keys.key(i, lo, hi); a
// valid window is hashed and filtered, and bit i of the result says it is
// kept.
template <int C, bool kKeyEverywhere, class Keys>
__device__ __forceinline__ uint32_t slide_windows(
    const uint32_t* pg, int64_t packed_words, int64_t t0, int window,
    const Seed& sd, const Filter& filt, bool legacy, uint32_t valid,
    Keys& keys) {
  // the 32 codes from position u, u's word and the two after it; the
  // funnel shift is guarded at 0, whose 64-bit shift C++ leaves undefined
  auto word = [&](int64_t i) -> uint64_t {
    return i < packed_words ? pg[i] : 0u;
  };
  auto codes_from = [&](int64_t u) -> uint64_t {
    const int64_t b = u >> 4;
    const int o = 2 * static_cast<int>(u & 15);
    const uint64_t x = word(b) | (word(b + 1) << 32);
    return o ? (x >> o) | (word(b + 2) << (64 - o)) : x;
  };
  // the codes that enter s (t0 + 64 ..) and f (t0 + w ..)
  uint64_t next_s = codes_from(t0 + 64);
  uint64_t next_f = codes_from(t0 + window);
  Strands st = strands_at(pg, packed_words, t0, window);

  uint32_t kept = 0;
#pragma unroll 4
  for (int i = 0; i < C; ++i) {
    const bool v = (valid >> i) & 1u;
    if (kKeyEverywhere || v) {
      uint64_t lo, hi;
      strand_key(st, sd, lo, hi);
      if (v && fmh_keep(hash_bitset128(lo, hi, legacy), sd.salt, filt)) {
        kept |= 1u << i;
      }
      keys.key(i, lo, hi);
    }
    slide(st, static_cast<uint32_t>(next_f & 3),
          static_cast<uint32_t>(next_s & 3));
    next_f >>= 2;
    next_s >>= 2;
  }
  return kept;
}

// K1 and K7 keep no key on the way: the kept ones are rebuilt.
struct NoKeys {
  __device__ __forceinline__ void key(int, uint64_t, uint64_t) {}
};

// K1/K7 output: each 128-window row's first k_slots kept keys (low
// out_words words) with all-ones fill, and its true kept count.
struct CompactRows {
  static constexpr int kWindows = SLIDE_C;
  static constexpr int kStageWords = 0;
  uint32_t* out;
  int32_t* rowcnt;
  int64_t rows;
  int k_slots;
  int out_words;

  // Four threads of one warp a row, ranked by a shuffle scan of their
  // kept counts; every lane of the warp calls it.
  __device__ __forceinline__ void run(const uint32_t* pg,
                                      int64_t packed_words, int64_t thread,
                                      int64_t y, int window, const Seed& sd,
                                      const Filter& filt, bool legacy,
                                      uint32_t valid, uint32_t*) const {
    const int64_t row = thread / ROW_THREADS;
    const int part = static_cast<int>(threadIdx.x) & (ROW_THREADS - 1);
    const int64_t t0 = thread * SLIDE_C;
    const bool active = row < rows;
    NoKeys none;
    const uint32_t kept =
        active && valid != 0
            ? slide_windows<SLIDE_C, false>(pg, packed_words, t0, window,
                                            sd, filt, legacy, valid, none)
            : 0u;

    const int cnt = __popc(kept);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < ROW_THREADS; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d, ROW_THREADS);
      if (part >= d) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, ROW_THREADS - 1, ROW_THREADS);
    if (!active) return;

    // the kept keys, rebuilt one at a time, into slots below k_slots
    const int64_t plane = static_cast<int64_t>(gridDim.y) * rows * k_slots;
    uint32_t* o = out + (y * rows + row) * k_slots;
    int slot = incl - cnt;
    for (uint32_t m = kept; m != 0 && slot < k_slots; m &= m - 1, ++slot) {
      uint64_t lo, hi;
      canonical_key(pg, packed_words, t0 + __ffs(m) - 1, window, sd, lo, hi);
      for (int q = 0; q < out_words; ++q) {
        o[q * plane + slot] = key_word(lo, hi, q);
      }
    }
    for (int s = min(total, k_slots) + part; s < k_slots; s += ROW_THREADS) {
      for (int q = 0; q < out_words; ++q) o[q * plane + s] = SENT;
    }
    if (part == 0) rowcnt[y * rows + row] = total;
  }
};

// K11's staging of a warp's 32 EMIT_C keys: word q of the warp's window e
// at stage[q * STAGE_PLANE + slab_index<32>(e)].  At a step of the slide
// the 32 lanes' windows lie EMIT_C apart, at a step of the write-out 1
// apart; both fall in 32 distinct banks.
constexpr int STAGE_PLANE = slab_index<32>(32 * EMIT_C - 1) + 1;

struct StageKeys {
  uint32_t* stage;
  int e0;   // the lane's first window in the warp

  __device__ __forceinline__ void key(int i, uint64_t lo, uint64_t hi) {
    uint32_t* s = stage + slab_index<32>(e0 + i);
    s[0] = static_cast<uint32_t>(lo);
    s[STAGE_PLANE] = static_cast<uint32_t>(lo >> 32);
    s[2 * STAGE_PLANE] = static_cast<uint32_t>(hi);
    s[3 * STAGE_PLANE] = static_cast<uint32_t>(hi >> 32);
  }
};

// K11 output: every window's four key words and keep flag, no compaction.
// The key is computed at every window t < nw, valid or not, as the TPU
// kernel does.  A thread takes EMIT_C consecutive windows and stages their
// keys in its warp's shared memory; then the warp writes its 32 EMIT_C
// windows of each plane, and their keep bytes, with its 32 lanes on
// consecutive windows, so every store instruction covers whole lines.
// (Each of 32 lanes storing its own 32 windows, 16 bytes at a time and
// 128 bytes apart, took 7.2 times as long as the one-thread-a-window
// kernel on an H100, and the cost fell with the lanes' spacing: PERF.md.)
struct EmitAll {
  static constexpr int kWindows = EMIT_C;
  static constexpr int kStageWords = 4 * STAGE_PLANE;
  uint32_t* canon;   // (4, G, nw)
  uint8_t* keep;     // (G, nw), 0 or 1
  int64_t nw;

  // Every lane of the warp calls it.
  __device__ __forceinline__ void run(const uint32_t* pg,
                                      int64_t packed_words, int64_t thread,
                                      int64_t y, int window, const Seed& sd,
                                      const Filter& filt, bool legacy,
                                      uint32_t valid, uint32_t* stage) const {
    constexpr int C = EMIT_C;
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const int64_t t0 = thread * C;
    const int64_t w0 = t0 - lane * C;            // the warp's first window
    StageKeys keys{stage, lane * C};
    const uint32_t kept =
        t0 < nw ? slide_windows<C, true>(pg, packed_words, t0, window, sd,
                                         filt, legacy, valid, keys)
                : 0u;
    __syncwarp();
    const int64_t plane = static_cast<int64_t>(gridDim.y) * nw;
    uint32_t* row = canon + y * nw + w0;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const int e = lane + 32 * r;
      const bool in = w0 + e < nw;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (in) row[q * plane + e] = stage[q * STAGE_PLANE + slab_index<32>(e)];
      }
      const uint32_t bits = __shfl_sync(FULL, kept, e / C);
      if (in) keep[y * nw + w0 + e] = (bits >> (e % C)) & 1u;
    }
  }
};

// K1, K7 and K11.  grid (ceil(threads / 256), Y), block 256: each thread
// takes Out::kWindows consecutive windows of grid row y (a genome, or a
// seed over the shared genome); K1's and K7's four threads of one warp
// hold a 128-window row.  Each warp has its own slab and staging area.
template <class Runs, class Seeds, class Out>
__global__ void __launch_bounds__(SLIDE_THREADS) slide_kernel(
    const uint32_t* __restrict__ packed, int64_t packed_words, Runs runs,
    int window, Seeds seeds, Filter filt, bool legacy, Out out) {
  constexpr int C = Out::kWindows;
  constexpr int kSlab = Runs::template slab_ints<C>();
  __shared__ int32_t slab[SLIDE_WARPS * kSlab + 1];
  __shared__ uint32_t stage[SLIDE_WARPS * Out::kStageWords + 1];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int64_t thread =
      static_cast<int64_t>(blockIdx.x) * SLIDE_THREADS + threadIdx.x;
  const int64_t y = blockIdx.y;
  const int64_t g = seeds.genome(y);
  const Seed sd = seeds.get(y);
  const uint32_t valid = runs.template valid_word<C>(
      g, thread * C, window, slab + warp * kSlab);
  out.run(packed + g * packed_words, packed_words, thread, y, window, sd,
          filt, legacy, valid, stage + warp * Out::kStageWords);
}

bool args_ok(int ys, int64_t threads, int window) {
  return ys > 0 && ys <= 65535 && threads > 0 && window >= 1 && window <= 64;
}

// The filter of the wrapper's (scale, magic, l); its scale is 0 (which
// the launches refuse) unless scale >= 1 and l = ceil(log2 scale).
Filter make_filter(int scale, uint64_t magic, int l) {
  const bool ok = scale >= 1 && l >= 0 && l <= 31 &&
                  (1ll << l) >= scale && (l == 0 || (1ll << (l - 1)) < scale);
  return {magic, ok ? static_cast<uint32_t>(scale) : 0u, l > 0 ? 1 : 0,
          l > 0 ? l - 1 : 0};
}

// Every launch: `threads` threads of each grid row, 256 a block.
template <class Runs, class Seeds, class Out>
int launch_rows(const void* packed, int64_t packed_words, const Runs& runs,
                int ys, int64_t threads, int window, Seeds seeds,
                const Filter& filt, int legacy, Out out, void* stream) {
  const int64_t blocks = (threads + SLIDE_THREADS - 1) / SLIDE_THREADS;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ys));
  slide_kernel<Runs, Seeds, Out><<<grid, SLIDE_THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), packed_words, runs, window, seeds,
      filt, legacy != 0, out);
  return last_error();
}

// K1/K7: one seed per genome row, or (seeds non-null) seed-batch mode with
// g seeds over genome row 0.
template <class Runs>
int launch_compact(const void* packed, int64_t packed_words, Runs runs,
                   int g, int64_t rows, int window, uint64_t mask_lo,
                   uint64_t mask_hi, uint64_t salt, const void* seeds,
                   const Filter& filt, int legacy, int k_slots, int out_words,
                   void* out, void* rowcnt, void* stream) {
  const int64_t threads = rows * ROW_THREADS;
  if (!args_ok(g, threads, window) || filt.scale == 0 || k_slots < 1 ||
      k_slots > LANES || out_words < 1 || out_words > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CompactRows o{static_cast<uint32_t*>(out),
                      static_cast<int32_t*>(rowcnt), rows, k_slots,
                      out_words};
  if (seeds != nullptr) {
    const SeedRows sr{static_cast<const uint64_t*>(seeds)};
    return launch_rows(packed, packed_words, runs, g, threads, window, sr,
                       filt, legacy, o, stream);
  }
  const OneSeed one{{mask_lo, mask_hi, salt}};
  return launch_rows(packed, packed_words, runs, g, threads, window, one,
                     filt, legacy, o, stream);
}

}  // namespace
}  // namespace sks

// The filter arguments of every entry: scale >= 1 with fmh_magic (the
// reciprocal of sks::Filter) and fmh_shift = ceil(log2 scale), both from
// ops/cuda/extract.fmh_divisor(scale).

// K1.  packed (G, packed_words) u32; rid (G, n) i32 with
// 16 * packed_words >= n; out (out_words, G, rows * k_slots) u32;
// rowcnt (G, rows) i32.  Seed-batch mode (seeds non-null): seeds (g, 3)
// u64 rows [mask_lo, mask_hi, salt], packed and rid hold ONE genome row
// that every seed reads, out and rowcnt one row per seed; mask_lo,
// mask_hi and salt are then not read.
extern "C" int sks_extract_compact(
    const void* packed, int64_t packed_words, const void* rid, int64_t n,
    int g, int64_t rows, int window, uint64_t mask_lo, uint64_t mask_hi,
    uint64_t salt, const void* seeds, int scale, uint64_t fmh_magic,
    int fmh_shift, int legacy, int k_slots, int out_words, void* out,
    void* rowcnt, void* stream) {
  if (16 * packed_words < n) return static_cast<int>(cudaErrorInvalidValue);
  const sks::RunPlane runs{static_cast<const int32_t*>(rid), n};
  return sks::launch_compact(packed, packed_words, runs, g, rows, window,
                             mask_lo, mask_hi, salt, seeds,
                             sks::make_filter(scale, fmh_magic, fmh_shift),
                             legacy, k_slots, out_words, out, rowcnt, stream);
}

// K7.  packed (G, packed_words) u32; bounds (G, k_bounds) i32, each row
// ascending; rid0 and vlen (G,) i32; out, rowcnt and seeds as K1's (in
// seed-batch mode bounds, rid0 and vlen hold one genome row).
extern "C" int sks_extract_compact_raw(
    const void* packed, int64_t packed_words, const void* bounds,
    int k_bounds, const void* rid0, const void* vlen, int g, int64_t rows,
    int window, uint64_t mask_lo, uint64_t mask_hi, uint64_t salt,
    const void* seeds, int scale, uint64_t fmh_magic, int fmh_shift,
    int legacy, int k_slots, int out_words, void* out, void* rowcnt,
    void* stream) {
  if (k_bounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  const sks::RunBounds runs{static_cast<const int32_t*>(bounds), k_bounds,
                            static_cast<const int32_t*>(rid0),
                            static_cast<const int32_t*>(vlen),
                            16 * packed_words};
  return sks::launch_compact(packed, packed_words, runs, g, rows, window,
                             mask_lo, mask_hi, salt, seeds,
                             sks::make_filter(scale, fmh_magic, fmh_shift),
                             legacy, k_slots, out_words, out, rowcnt, stream);
}

// K11.  packed (G, packed_words) u32 and rid (G, n) i32 as K1's; canon
// (4, G, nw) u32 every window's canonical key, keep (G, nw) u8.
extern "C" int sks_extract_filter(
    const void* packed, int64_t packed_words, const void* rid, int64_t n,
    int g, int64_t nw, int window, uint64_t mask_lo, uint64_t mask_hi,
    uint64_t salt, int scale, uint64_t fmh_magic, int fmh_shift, int legacy,
    void* canon, void* keep, void* stream) {
  const sks::Filter filt = sks::make_filter(scale, fmh_magic, fmh_shift);
  const int64_t threads = (nw + sks::EMIT_C - 1) / sks::EMIT_C;
  if (16 * packed_words < n || nw < 1 || nw > n || filt.scale == 0 ||
      !sks::args_ok(g, threads, window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sks::RunPlane runs{static_cast<const int32_t*>(rid), n};
  const sks::OneSeed one{{mask_lo, mask_hi, salt}};
  const sks::EmitAll out{static_cast<uint32_t*>(canon),
                         static_cast<uint8_t*>(keep), nw};
  return sks::launch_rows(packed, packed_words, runs, g, threads, window,
                          one, filt, legacy, out, stream);
}
