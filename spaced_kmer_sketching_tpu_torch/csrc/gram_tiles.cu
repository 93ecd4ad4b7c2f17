// K6: exact all-pairs Gram of a sorted packed (key, gid) stream, taken on
// the int8 tensor cores.
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
// Equal keys are contiguous (equality: word 0's low gidbits masked) and
// every run holds each gid at most once, in ascending gid order.  So the
// Gram is the TPU kernel's sum over runs r of h_R(r) h_C(r)^T, h the 0/1
// multi-hot of run r's gids in the row (R) or column (C) range: an int8
// product with int32 sums, exact because every operand is 0 or 1.
//
// The grid is (segment of the stream) x (row tile) x (column tile) of
// 128 x 128 gids.  In full mode only tiles on or above the diagonal run,
// and off-diagonal tiles also add into their mirror.  A block owns the
// runs that START in its segment: it skips the tail of a run that began
// before it and reads past its end to finish its last run, so each run
// counts once per tile.  It walks its segment in back-to-back chunks of
// 4,096 entries, the next chunk streaming into shared memory (16-byte
// cp.async where the stream's alignment allows) while this one is
// processed; each chunk also loads the entry before it and the one after
// it.  Per chunk, a block scan of the run-start flags numbers the runs.  A
// run whose last entry is not the chunk's last, or whose next entry
// starts another run, is complete.  The chunk's last run may go on into
// the next chunk (a run holds up to gp entries, and gp may pass the
// chunk): it stays open, its in-range gids kept as two 128-byte vectors
// and its flags as two bits, and the next chunk numbers it run 0 and adds
// them back.  Past its segment a block
// reads only to finish its open run, at most gp entries a chunk.
//
// A run is kept when it can add to the tile: an entry in the row range and
// one in the column range or, on a diagonal tile, two entries in range
// (the diagonal itself is a per-gid count of in-range entries in shared
// memory, so runs of one entry need no product, and a chunk of such runs
// alone, as unrelated genomes give, stops after the count); runs that
// cannot add are dropped.  Kept runs take the multi-hot columns in stream
// order: an entry scan of their first entries numbers them, and each 32
// entries keep the ballots of their kept entries and kept first entries
// beside the scan's offset, so that an entry's column is read off its
// group (the run carried in, if kept, is column 0).  The kept runs of a
// batch of KB columns thus cover one contiguous range of the chunk's
// entries, from the first entry of the batch's first kept run, which a
// search of the scan finds.  Every in-range entry of a kept run writes
// one byte 1 into A (128 row gids x KB runs) or B (128 column gids x KB
// runs) once: all threads stride over the batch's range, not over all
// their entries.  The
// products are int8 wgmma (SASS IGMMA): two warpgroups of 64 rows, m64n128
// k32, operands K-major in shared memory (8-row x 16-byte core matrices),
// int32 accumulators in registers for the whole segment.  A and B rotate
// over three buffers: a batch's product runs asynchronously while the
// last batch's buffer is cleared (16-byte stores of zeros) and the next
// batch's ones are written into the third, and a chunk's last product
// runs on into the next chunk's scans.  A batch costs one barrier, before
// its product: its ones are written, and the last product is done, so
// that its buffer may be cleared; the batch after next, which writes that
// buffer, comes after the next barrier.  Loads from shared memory come
// first and unconditional where they can, for the latency of one load a
// step rather than one an entry.  At the end the nonzero accumulators are
// atomically added into the int32 output.  Integer adds are order-free,
// so the result is bit-exact.
//
// Segments are whole chunks less SLACK entries each: a block's last chunk
// then reaches SLACK entries a chunk past its segment's end, where its
// last run most often ends, so that no chunk is read only to finish that
// run (a chunk costs its barriers and scans however few its entries).
// About TARGET_BLOCKS blocks run over all tiles: two resident blocks on
// each of the H100's 132 SMs (~107 KB of shared memory at pw 2, <= 128
// registers a thread), one block's work overlapping the other's waits.
// Each block sizes the segments over the valid entries, which it finds
// first (two rounds of 256 probes; the sentinels lie at the back): the
// all-pairs macro-tiles merge blocks padded to their widest sketch, and
// segments cut from the whole stream left a quarter of the blocks on
// sentinels, so that the SMs holding two working blocks set the pace.  A
// block's fixed costs (zeroing its shared memory, the probes, an epilogue
// of up to 16,384 global atomic adds) are why more blocks do not help.
// Each block adds the kept runs it multiplied to a 64-bit counter once,
// when the caller passes one.
//
// What bounds it on an H100: bytes.  A tile reads the stream once, pw
// words an entry; the tensor work is 2 x 128 x 128 ops a kept run.  On a
// macro-tile of two related blocks (the Zipf collection's, ~440 kept runs
// a 4,096-entry chunk) the product took 72% of the kernel when each batch
// of 128 kept runs cost two passes over all 16 of a thread's entries,
// three barriers and a synchronous mma.sync product: hence the single
// write per entry, the vector clears and the asynchronous products.
// Dropping runs that cannot add keeps the tensor work and the
// shared-memory writes to the runs that count: a macro-tile of two blocks
// with no clade in common keeps none.
#include "common.cuh"

namespace sks {
namespace {

constexpr int GT = 128;                  // gids per output tile side
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;                  // stream entries a thread a chunk
constexpr int CHUNK = THREADS * PER;     // 4,096 entries
constexpr int MAX_GP = 1 << 16;          // gids fit ent's 16 bits
constexpr int SLACK = 64;                // entries a segment's chunk less
constexpr int TARGET_BLOCKS = 264;
constexpr int KB = 64;                   // multi-hot columns a batch
constexpr int HOT = GT * KB;             // bytes of one multi-hot operand
constexpr int CORE = 128;                // an 8-row x 16-byte core matrix
constexpr int SBO = KB / 16 * CORE;      // bytes between 8-row groups
constexpr int ACC = 64;                  // accumulators a thread
constexpr int UNROLL = 2;                // entries a thread writes at once
constexpr int RAW = CHUNK + 12;          // words a raw plane (16-byte rows)

// hot[s][0] and hot[s][1]: buffer s's A and B, each 128 gids x KB runs in
// core matrices (hot_at); raw[q][o + e]: word q of the chunk's entry e
// for e in [-1, len], the entries before and after the chunk too, o in
// 4..7 (raw_off) giving the words the 16-byte alignment they have in the
// stream; ent[e]: gid (bits 0-15, 0xFFFF past it), the number
// of run starts in [0, e] of the chunk (bits 16-28), this entry and the
// one before it both in one run and in the row range (bit 29), valid (bit
// 30), run start (bit 31).  Runs are indexed from 0 (the open run carried
// in, if any) to at most CHUNK - 1.
template <int PW>
struct Smem {
  int8_t hot[3][2][HOT];
  uint32_t raw[PW][RAW];
  uint32_t ent[CHUNK];
  alignas(16) uint8_t has[CHUNK][2];     // run r can add (row, column)
  int8_t opens[2][2][GT];                // an open run's row and column
                                         // gids: the run carried in, out
  uint16_t bstart[CHUNK / KB + 2];       // batch b's first entry
  uint4 kgrp[WARPS * PER];               // each 32 entries: the kept ones,
                                         // the kept runs' first entries,
                                         // the first entries before them
  int wsum[WARPS * PER + 1];
  int diag[GT];                          // diagonal tiles: in-range entries
  int carry;                             // the open run's flags: row | col << 1
};

__device__ __forceinline__ uint32_t ent_gid(uint32_t v) { return v & 0xFFFF; }
__device__ __forceinline__ int ent_runs(uint32_t v) {
  return (v >> 16) & 0x1FFF;
}
__device__ __forceinline__ bool ent_pair(uint32_t v) { return v >> 29 & 1; }
__device__ __forceinline__ bool ent_valid(uint32_t v) { return v >> 30 & 1; }
__device__ __forceinline__ bool ent_start(uint32_t v) { return v >> 31; }

// Entries a chunk at p reads: a whole chunk inside the segment; past it
// only the open run is finished, which has fewer than gp entries left.
__device__ __forceinline__ int chunk_len(int64_t n, int64_t p, int64_t s1,
                                         int gp) {
  const int64_t cap = p < s1 ? CHUNK : (gp < CHUNK ? gp : CHUNK);
  return static_cast<int>(n - p < cap ? n - p : cap);
}

// Where plane q of the chunk at p lies in raw: entry e at raw[q][o + e].
__device__ __forceinline__ int raw_off(const uint32_t* sw, int64_t n,
                                       int64_t p, int q) {
  return 4 + static_cast<int>(
                 reinterpret_cast<uintptr_t>(sw + q * n + p) >> 2 & 3);
}

// Copy the chunk of `len` entries at p, the entry before it and the one
// after it into raw: 16-byte cp.async for the aligned words (chunk starts
// need not be aligned, so raw_off keeps the stream's alignment), 4-byte
// ones for the at most 3 + 3 words at the ends; one commit group.
template <int PW>
__device__ __forceinline__ void load_chunk(Smem<PW>& sm,
                                           const uint32_t* sw, int64_t n,
                                           int64_t p, int len) {
  const int lo = p == 0 ? 0 : -1;      // the words to copy: [lo, hi)
  const int hi = static_cast<int>(n - p < len + 1 ? n - p : len + 1);
#pragma unroll
  for (int q = 0; q < PW; ++q) {
    const uint32_t* src = sw + q * n + p;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        &sm.raw[q][raw_off(sw, n, p, q)]));
    const int a0 = lo + static_cast<int>(
                            (4 - (reinterpret_cast<uintptr_t>(src + lo) >> 2
                                  & 3)) & 3);
    const int a1 = a0 < hi ? a0 + ((hi - a0) & ~3) : a0;
    for (int i = a0 + 4 * static_cast<int>(threadIdx.x); i < a1;
         i += 4 * THREADS) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(dst + 4 * i), "l"(src + i));
    }
    if (threadIdx.x < 8) {
      const int i = threadIdx.x < 4 ? lo + static_cast<int>(threadIdx.x)
                                    : a1 + static_cast<int>(threadIdx.x) - 4;
      if (threadIdx.x < 4 ? i < a0 && i < hi : i < hi) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(dst + 4 * i), "l"(src + i));
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Byte (row, k) of a multi-hot operand: K-major core matrices of 8 rows x
// 16 bytes, the KB / 16 of an 8-row group side by side.
__device__ __forceinline__ int hot_at(uint32_t row, unsigned k) {
  return static_cast<int>(((row >> 3) * (KB / 16) + (k >> 4)) * CORE +
                          (row & 7) * 16 + (k & 15));
}

// wgmma shared-memory descriptor of a K-major operand at p without
// swizzling: core matrices CORE bytes apart along K, SBO along the rows.
__device__ __forceinline__ uint64_t hot_desc(const int8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(CORE >> 4) << 16 |
         static_cast<uint64_t>(SBO >> 4) << 32;
}

// d += A (64 x 32, K-major) * B (128 x 32, K-major)^T: s8 in, s32 sums,
// issued for the warpgroup and run asynchronously until a wait.
__device__ __forceinline__ void wgmma_s8(int (&d)[ACC], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Keep the compiler from moving the accumulators while a product is in
// flight: every register is read and written here.
__device__ __forceinline__ void pin(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int PW>
__global__ void __launch_bounds__(THREADS, 2) gram_mma_kernel(
    const uint32_t* __restrict__ sw, int64_t n, int gidbits, int c0,
    int ncols, int64_t seg, int sym, int32_t* __restrict__ out,
    unsigned long long* __restrict__ kept_total) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<PW>& sm = *reinterpret_cast<Smem<PW>*>(smem_raw);
  const int tr = blockIdx.y;
  const int tc = blockIdx.z;
  if (sym && tr > tc) return;
  const bool diag = sym && tr == tc;
  const int gp = c0 + ncols;
  const uint32_t r0 = tr * GT;                // first row gid
  const uint32_t cg0 = c0 + tc * GT;          // first column gid
  const uint32_t gmask = (1u << gidbits) - 1u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = threadIdx.x >> 7;            // warpgroup: rows 64 wg + ...
  const unsigned below = (1u << lane) - 1u;

  for (int e = threadIdx.x; e < CHUNK / 2; e += THREADS) {
    reinterpret_cast<uint32_t*>(sm.has)[e] = 0;
  }
  for (int e = threadIdx.x; e < 6 * HOT / 16; e += THREADS) {
    reinterpret_cast<int4*>(sm.hot)[e] = make_int4(0, 0, 0, 0);
  }
  if (threadIdx.x < GT) {
    reinterpret_cast<uint32_t*>(sm.opens)[threadIdx.x] = 0;
    sm.diag[threadIdx.x] = 0;
  }
  int acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  unsigned long long kept_sum = 0;            // kept runs multiplied
  int hb = 0;                              // the buffer of the next batch
  __syncthreads();

  if (seg == 0) {
    // the kernel's own sizing: whole chunks less SLACK, over the valid
    // entries, found by two rounds of a probe a thread (the sentinels lie
    // at the back): the first sentinel is in [lo, hi], hi - lo < n / 2^16
    int64_t lo = 0, hi = n;
    for (int round = 0; round < 2 && lo < hi; ++round) {
      const int64_t step = (hi - lo + THREADS - 1) / THREADS;
      const int64_t i = lo + threadIdx.x * step;
      const int k = __syncthreads_count(i < hi &&
                                        !(sw[(PW - 1) * n + i] >> 31));
      hi = k ? (lo + k * step < hi ? lo + k * step : hi) : lo;
      lo = k ? lo + (k - 1) * step + 1 : lo;
    }
    const int64_t step = (CHUNK - SLACK) * static_cast<int64_t>(gridDim.x);
    seg = (hi > 0 ? (hi + step - 1) / step : 1) * (CHUNK - SLACK);
  }
  int64_t p = static_cast<int64_t>(blockIdx.x) * seg;
  const int64_t s1 = p + seg < n ? p + seg : n;
  bool more = p < s1 && !(sw[(PW - 1) * n + p] >> 31);
  int len = chunk_len(n, p, s1, gp);
  int nopen = 0;     // 1: the chunk's first entries continue an open run
  int ib = 0;        // the opens[] buffer of the run carried in
  if (more) load_chunk<PW>(sm, sw, n, p, len);
  while (more) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // 1. gid, validity and run-start flag of every entry of the chunk
    int off[PW];
#pragma unroll
    for (int q = 0; q < PW; ++q) off[q] = raw_off(sw, n, p, q);
    uint32_t info[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      // (loads first and unconditional, past len too: what is read there
      // is masked)
      const int e = j * THREADS + threadIdx.x;
      uint32_t k[PW], w[PW];
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        k[q] = sm.raw[q][off[q] + e];
        w[q] = sm.raw[q][off[q] + e - 1];       // the entry before
      }
      const uint32_t g = k[0] & gmask;
      const uint32_t pg = w[0] & gmask;
      uint32_t diff = (k[0] ^ w[0]) & ~gmask;
#pragma unroll
      for (int q = 1; q < PW; ++q) diff |= k[q] ^ w[q];
      const bool start = p + e == 0 || diff != 0;
      const bool pair = !start && g - r0 < GT && pg - r0 < GT;
      const uint32_t v =
          e < len ? (g < 0xFFFFu ? g : 0xFFFFu) |
                        static_cast<uint32_t>(pair) << 29 |
                        static_cast<uint32_t>(!(k[PW - 1] >> 31)) << 30 |
                        static_cast<uint32_t>(start) << 31
                  : 0u;
      info[j] = v;
      scan_publish(j * WARPS + warp, __ballot_sync(FULL, ent_start(v)),
                   sm.wsum);
    }
    // does the entry after the chunk continue the chunk's last run?
    const int64_t next = p + len;
    bool next_valid = false, cont = false;
    if (next < n) {
      next_valid = !(sm.raw[PW - 1][off[PW - 1] + len] >> 31);
      cont = next_valid;
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        const uint32_t d =
            sm.raw[q][off[q] + len] ^ sm.raw[q][off[q] + len - 1];
        cont &= (q == 0 ? d & ~gmask : d) == 0;
      }
    }
    // (every value that steers the products is broadcast from lane 0, so
    // that the compiler sees it warp-uniform and keeps them asynchronous)
    next_valid = __shfl_sync(FULL, next_valid, 0);
    cont = __shfl_sync(FULL, cont, 0);

    // 2. number the runs (run starts in [0, e], plus the run carried in)
    scan_groups(WARPS * PER, sm.wsum);
    bool paired = false;              // an owned run holds two entries
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = j * THREADS + threadIdx.x;
      const unsigned bal = __ballot_sync(FULL, ent_start(info[j]));
      const int runs = sm.wsum[j * WARPS + warp] + __popc(bal & below) +
                       ent_start(info[j]);
      info[j] |= static_cast<uint32_t>(runs) << 16;
      sm.ent[e] = info[j];
      paired |= ent_valid(info[j]) && !ent_start(info[j]) &&
                runs + nopen > 0;
    }
    paired = __shfl_sync(FULL, __syncthreads_or(paired), 0);
    // the block owns the runs that start before its segment's end; an
    // owned last run that goes on is carried into the next chunk, which
    // loads while this one is processed.  (Every value that steers the
    // products is broadcast from lane 0, so that the compiler sees it
    // warp-uniform and keeps them asynchronous.)
    const int last =
        ent_runs(__shfl_sync(FULL, sm.ent[len - 1], 0)) - 1 + nopen;
    const int64_t lim64 = s1 - p < len ? s1 - p : len;
    const int lim = lim64 > 0 ? static_cast<int>(lim64) : 0;
    const int own = nopen + (lim > 0 ? ent_runs(__shfl_sync(
                                           FULL, sm.ent[lim - 1], 0))
                                     : 0);
    const bool carry = cont && last >= 0 && last < own;
    const int ob = carry && nopen && last == 0 ? ib : ib ^ 1;
    const int done = carry ? last : own;        // owned runs complete here
    more = next_valid && (carry || next < s1);
    const int next_len = chunk_len(n, next, s1, gp);
    if (more) load_chunk<PW>(sm, sw, n, next, next_len);

    // 3. the entries of owned runs, and which runs can add to the tile.  A
    //    run of one entry adds to the diagonal count only, so a chunk whose
    //    owned runs all hold one entry (and none is carried) stops here.
    const bool pairs = paired || carry;
    if (!pairs && !diag) {
      p = next;
      len = next_len;
      continue;
    }
    if (nopen && threadIdx.x == 0) {            // the flags carried in
      if (sm.carry & 1) sm.has[0][0] = 1;
      if (sm.carry & 2) sm.has[0][1] = 1;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = j * THREADS + threadIdx.x;
      const uint32_t v = sm.ent[e];
      const int r = ent_runs(v) - 1 + nopen;
      if (e >= len || r < 0 || r >= own || !ent_valid(v)) continue;
      const uint32_t g = ent_gid(v);
      const bool in_r = g - r0 < GT;
      const bool in_c = !diag && g - cg0 < GT;
      if (diag) {
        if (in_r) atomicAdd(&sm.diag[g - r0], 1);
        if (ent_pair(v)) sm.has[r][0] = 1;    // two entries in range
      } else {
        if (in_r) sm.has[r][0] = 1;
        if (in_c) sm.has[r][1] = 1;
      }
      if (carry && r == last) {
        if (in_r) sm.opens[ob][0][g - r0] = 1;
        if (in_c) sm.opens[ob][1][g - cg0] = 1;
      }
    }
    if (!pairs) {
      p = next;
      len = next_len;
      continue;
    }
    __syncthreads();

    // 4. which runs are kept: owned, complete, with both flags (on a
    //    diagonal tile, the first).  Their columns follow the stream: an
    //    entry scan of the kept runs' first entries numbers them, each 32
    //    entries keeping the ballots of their kept entries and first
    //    entries (the run carried in, if kept, is column 0).  The first
    //    entry of each batch of KB columns is found by a search of the
    //    scan; the flags are cleared for the next chunk (the open run's go
    //    to sm.carry).
    const uint16_t* has = reinterpret_cast<const uint16_t*>(sm.has);
    const int kept0 = nopen && 0 < done && (has[0] & 0xFF) &&
                      (diag || has[0] >> 8);
    if (carry && threadIdx.x == 0) {
      sm.carry = (has[last] & 0xFF ? 1 : 0) | (has[last] >> 8 ? 2 : 0);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const uint32_t v = sm.ent[j * THREADS + threadIdx.x];
      const int r = ent_runs(v) - 1 + nopen;
      const uint16_t h = has[r > 0 ? r : 0];
      const bool k = ent_valid(v) && r >= 0 && r < done && (h & 0xFF) &&
                     (diag || h >> 8);
      const unsigned km = __ballot_sync(FULL, k);
      const unsigned kf = __ballot_sync(FULL, k && ent_start(v));
      if (lane == 0) sm.kgrp[j * WARPS + warp] = make_uint4(km, kf, 0, 0);
      scan_publish(j * WARPS + warp, kf, sm.wsum);
    }
    const int kept =
        __shfl_sync(FULL, scan_groups(WARPS * PER, sm.wsum), 0) + kept0;
    const int batches = (kept + KB - 1) / KB;
    if (threadIdx.x < WARPS * PER) {
      sm.kgrp[threadIdx.x].z = sm.wsum[threadIdx.x];
    }
    for (int i = threadIdx.x; i < (own + 7) / 8; i += THREADS) {
      reinterpret_cast<int4*>(sm.has)[i] = make_int4(0, 0, 0, 0);
    }
    if (threadIdx.x < batches) {      // batch b starts at column b KB
      const int t = threadIdx.x * KB - kept0;
      int e = 0;
      if (t >= 0) {                   // the group of the t-th first entry
        int lo = 0, hi = WARPS * PER;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (sm.wsum[mid] <= t) lo = mid; else hi = mid;
        }
        unsigned f = sm.kgrp[lo].y;
        for (int i = sm.wsum[lo]; i < t; ++i) f &= f - 1;
        e = lo * 32 + __ffs(f) - 1;
      }
      sm.bstart[threadIdx.x] = static_cast<uint16_t>(e);
    }
    if (threadIdx.x == 0) sm.bstart[batches] = static_cast<uint16_t>(len);
    kept_sum += kept;
    __syncthreads();

    // 5. the products, KB kept runs at a time: each entry of the batch's
    //    range writes its one once (the run carried in also from its
    //    opens[] vectors) into buffer hb; the last product is waited for
    //    before the barrier; this one is issued, and the last buffer
    //    cleared while it runs
    for (int b = 0; b < batches; ++b) {
      int8_t* ha = sm.hot[hb][0];
      int8_t* hc = sm.hot[hb][1];
      const int c0b = b * KB - kept0 + 1;   // a column is a count less this
      const int hi = sm.bstart[b + 1];
      for (int e0 = sm.bstart[b] + threadIdx.x; e0 < hi;
           e0 += UNROLL * THREADS) {
        uint32_t v[UNROLL];
        uint4 m[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {   // loads first, unconditional
          const int e = min(e0 + u * THREADS, CHUNK - 1);
          v[u] = sm.ent[e];
          m[u] = sm.kgrp[e >> 5];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int e = e0 + u * THREADS;
          const unsigned bit = 1u << (e & 31);
          if (e >= hi || !(m[u].x & bit)) continue;   // dropped
          const uint32_t g = ent_gid(v[u]);
          const unsigned c = m[u].z - c0b + __popc(m[u].y & (bit | (bit - 1)));
          if (g - r0 < GT) ha[hot_at(g - r0, c)] = 1;
          if (!diag && g - cg0 < GT) hc[hot_at(g - cg0, c)] = 1;
        }
      }
      if (kept0 && b == 0) {
        const int t = threadIdx.x & (GT - 1);
        if (threadIdx.x < GT) {
          if (sm.opens[ib][0][t]) ha[hot_at(t, 0)] = 1;
        } else if (!diag && sm.opens[ib][1][t]) {
          hc[hot_at(t, 0)] = 1;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(acc);
      __syncthreads();
      const int8_t* ta = ha + wg * (64 / 8) * SBO;
      const int8_t* tb = diag ? ha : hc;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      pin(acc);
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks) {
        wgmma_s8(acc, hot_desc(ta + ks * 2 * CORE),
                 hot_desc(tb + ks * 2 * CORE));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the last batch's buffer: its product is done (waited for before
      // the barrier), and the batch after next writes it
      int4* z = reinterpret_cast<int4*>(sm.hot[hb ? hb - 1 : 2]);
      for (int i = threadIdx.x; i < 2 * HOT / 16; i += THREADS) {
        z[i] = make_int4(0, 0, 0, 0);
      }
      hb = hb < 2 ? hb + 1 : 0;
    }
    // the run carried in is complete unless it is still the open one:
    // clear its vectors (read above, written again at the earliest after
    // the next chunk's first barrier)
    if (nopen && ob != ib) {
      reinterpret_cast<int8_t*>(sm.opens[ib])[threadIdx.x] = 0;
    }
    nopen = carry;
    ib = ob;
    p = next;
    len = next_len;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin(acc);
  __syncthreads();                             // the diagonal counts
  if (kept_total != nullptr && kept_sum && threadIdx.x == 0) {
    atomicAdd(kept_total, kept_sum);
  }

  // 6. the nonzero sums into the output (and the mirror off the diagonal):
  //    accumulator i of a thread is row 64 wg + 16 (warp % 4) + lane / 4
  //    (+ 8 for bit 1 of i), column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int rw = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cl = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int row = rw + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + cl + (i & 1);
    const int v = diag && row == col ? sm.diag[row] : acc[i];
    if (v == 0) continue;
    const int64_t a = r0 + row;
    const int64_t b = cg0 + col;
    atomicAdd(out + a * ncols + (b - c0), v);
    if (sym && !diag) atomicAdd(out + b * ncols + a, v);
  }
}

// Full mode (split == 0): (gp / 128)^2 tiles, those below the diagonal
// return at once; split mode: rows < split, columns >= split.  seg == 0
// runs about TARGET_BLOCKS blocks over all tiles, each sizing its segment
// from the valid entries.
template <int PW>
int gram_tiles(const uint32_t* sw, int64_t n, int gidbits, int gp, int split,
               int64_t seg, int32_t* out, unsigned long long* kept,
               cudaStream_t stream) {
  const int sym = split == 0;
  const int row_tiles = (sym ? gp : split) / GT;
  const int col_tiles = (gp - split) / GT;
  int64_t blocks;
  if (seg == 0) {
    const int tiles = sym ? row_tiles * (row_tiles + 1) / 2
                          : row_tiles * col_tiles;
    blocks = (TARGET_BLOCKS + tiles - 1) / tiles;
  } else {
    blocks = (n + seg - 1) / seg;
  }
  auto kern = gram_mma_kernel<PW>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<PW>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(blocks), row_tiles, col_tiles);
  kern<<<grid, THREADS, sizeof(Smem<PW>), stream>>>(
      sw, n, gidbits, split, gp - split, seg, sym, out, kept);
  return last_error();
}

}  // namespace
}  // namespace sks

// sw (pw, n) u32 sorted packed stream; out int32, zeroed by the caller:
// (gp, gp) when split == 0, else (split, gp - split).  gp and split are
// multiples of 128, gp <= 65,536; every gid is < gp; seg entries per
// block, or 0 for the kernel's own sizing.  kept, when not null, is an
// int64 to which the kept runs multiplied (summed over the tiles) are
// added.
extern "C" int sks_gram_tiles(const void* sw, int pw, int64_t n, int gidbits,
                              int gp, int split, int64_t seg, void* out,
                              void* kept, void* stream) {
  if (n <= 0 || seg < 0 || gidbits < 1 || gidbits > 31 || gp <= 0 ||
      gp % sks::GT != 0 || gp > sks::MAX_GP || split < 0 || split >= gp ||
      split % sks::GT != 0 || (n + seg - 1) / (seg ? seg : 1) > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* w = static_cast<const uint32_t*>(sw);
  auto* o = static_cast<int32_t*>(out);
  auto* k = static_cast<unsigned long long*>(kept);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return sks::gram_tiles<1>(w, n, gidbits, gp, split, seg, o, k, s);
    case 2: return sks::gram_tiles<2>(w, n, gidbits, gp, split, seg, o, k, s);
    case 3: return sks::gram_tiles<3>(w, n, gidbits, gp, split, seg, o, k, s);
    case 4: return sks::gram_tiles<4>(w, n, gidbits, gp, split, seg, o, k, s);
    case 5: return sks::gram_tiles<5>(w, n, gidbits, gp, split, seg, o, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
