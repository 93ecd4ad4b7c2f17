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
// 4,096 entries, the next chunk streaming into shared memory (4-byte
// cp.async) while this one is processed; each chunk also loads the entry
// before it and the one after it.  Per chunk, a block scan of the
// run-start flags numbers the runs.  A run whose last entry is not the
// chunk's last, or whose next entry starts another run, is complete.  The
// chunk's last run may go on into the next chunk (a run holds up to gp
// entries, and gp may pass the chunk): it stays open, its in-range gids
// kept as two 128-byte vectors and its flags as two bits, and the next
// chunk numbers it run 0 and adds them back.  Past its segment a block
// reads only to finish its open run, at most gp entries a chunk.
//
// A run is kept when it can add to the tile: an entry in the row range and
// one in the column range or, on a diagonal tile, two entries in range
// (the diagonal itself is a per-gid count of in-range entries in shared
// memory, so runs of one entry need no product, and a chunk of such runs
// alone, as unrelated genomes give, stops after the count).  A second scan
// gives each kept run a column of the multi-hots; runs that cannot add are
// dropped.  Every in-range entry of a kept run writes one byte 1 into A
// (128 row gids x 128 runs) or B (128 column gids x 128 runs), K-major
// with runs contiguous; eight warps take A B^T with mma.sync m16n8k32 s8
// (SASS IMMA) into int32 register accumulators that live for the whole
// segment (each warp a 32 x 64 quarter-strip); the bytes written are
// cleared again after the product.  At the end the nonzero accumulators
// are atomically added into the int32 output.  Integer adds are
// order-free, so the result is bit-exact.
//
// Segments are whole chunks less SLACK entries each: a block's last chunk
// then reaches SLACK entries a chunk past its segment's end, where its
// last run most often ends, so that no chunk is read only to finish that
// run (a chunk costs its barriers and scans however few its entries).
// They are sized so that about TARGET_BLOCKS blocks run over all tiles:
// two resident blocks on each of the H100's 132 SMs (~104 KB of shared
// memory at pw 2, <= 128 registers a thread), one block's work
// overlapping the other's waits.  A block's fixed costs (zeroing its
// shared memory, an epilogue of up to 16,384 global atomic adds) are why
// more blocks do not help.
//
// What bounds it on an H100: bytes.  A tile reads the stream once, pw
// words an entry; the tensor work is 2 x 128 x 128 ops a kept run, ~20% of
// the byte time at config 2's shape.  Dropping runs that cannot add keeps
// the tensor work and the shared-memory writes to the runs that count: a
// macro-tile of two blocks with no clade in common keeps none.  As built
// it runs at 6-30x that bound, held by the latency of each chunk's steps
// (nine block barriers, two scans, 16 entries a thread in turn) with two
// blocks an SM; fewer barriers a chunk are the next step.
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
constexpr int KB = 128;                  // multi-hot columns a product
constexpr int LD = KB + 16;              // bytes a multi-hot row: the
                                         // fragment loads hit 32 banks
constexpr uint16_t DROPPED = 0xFFFF;

// raw[q][1 + e]: word q of the chunk's entry e, raw[q][0] that of the
// entry before the chunk, raw[q][1 + len] that of the entry after it;
// ent[e]: gid (bits 0-15, 0xFFFF past it), the number of run starts in
// [0, e] of the chunk (bits 16-28), this entry and the one before it both
// in one run and in the row range (bit 29), valid (bit 30), run start
// (bit 31).  Runs are indexed from 0 (the open run carried in, if any) to
// at most CHUNK - 1.
template <int PW>
struct Smem {
  uint32_t raw[PW][CHUNK + 2];
  uint32_t ent[CHUNK];
  uint16_t kcol[CHUNK];                  // multi-hot column of run r
  uint8_t has_r[CHUNK];                  // run r can add (row side)
  uint8_t has_c[CHUNK];                  // run r can add (column side)
  int8_t a[GT * LD];                     // row multi-hot
  int8_t b[GT * LD];                     // column multi-hot
  int8_t opens[2][2][GT];                // an open run's row and column
                                         // gids: the run carried in, out
  int wsum[WARPS * PER + 1];
  int diag[GT];                          // diagonal tiles: in-range entries
  int carry;                             // the open run's has_r | has_c << 1
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

// Copy the chunk of `len` entries at p, the entry before it and the one
// after it into raw with 4-byte cp.async (chunk starts are not aligned);
// one commit group.
template <int PW>
__device__ __forceinline__ void load_chunk(Smem<PW>& sm,
                                           const uint32_t* sw, int64_t n,
                                           int64_t p, int len) {
#pragma unroll
  for (int q = 0; q < PW; ++q) {
    const uint32_t* src = sw + q * n + p;
    for (int e = static_cast<int>(threadIdx.x) - 1; e <= len;
         e += THREADS) {
      if (e < 0 && p == 0) continue;
      if (p + e >= n) break;
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(&sm.raw[q][1 + e]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(dst), "l"(src + e));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int PW>
__global__ void __launch_bounds__(THREADS, 2) gram_mma_kernel(
    const uint32_t* __restrict__ sw, int64_t n, int gidbits, int c0,
    int ncols, int64_t seg, int sym, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
  const unsigned below = (1u << lane) - 1u;
  const int wm = warp & 3, wn = warp >> 2;    // this warp's output strip
  const int g8 = lane >> 2, t4 = lane & 3;    // mma fragment coordinates
  const int8_t* bm = diag ? sm.a : sm.b;      // diagonal tiles: A A^T

  for (int e = threadIdx.x; e < CHUNK / 4; e += THREADS) {
    reinterpret_cast<uint32_t*>(sm.has_r)[e] = 0;
    reinterpret_cast<uint32_t*>(sm.has_c)[e] = 0;
  }
  for (int e = threadIdx.x; e < GT * LD / 4; e += THREADS) {
    reinterpret_cast<uint32_t*>(sm.a)[e] = 0;
    reinterpret_cast<uint32_t*>(sm.b)[e] = 0;
  }
  if (threadIdx.x < GT) {
    reinterpret_cast<uint32_t*>(sm.opens)[threadIdx.x] = 0;
    sm.diag[threadIdx.x] = 0;
  }
  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  __syncthreads();

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
    uint32_t info[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = j * THREADS + threadIdx.x;
      uint32_t v = 0;
      if (e < len) {
        uint32_t k[PW];
#pragma unroll
        for (int q = 0; q < PW; ++q) k[q] = sm.raw[q][1 + e];
        const uint32_t g = k[0] & gmask;
        k[0] &= ~gmask;
        bool start = p + e == 0;
        uint32_t pg = 0;                        // gid of the entry before
        if (!start) {
#pragma unroll
          for (int q = 0; q < PW; ++q) {
            uint32_t w = sm.raw[q][e];
            if (q == 0) {
              pg = w & gmask;
              w &= ~gmask;
            }
            start |= w != k[q];
          }
        }
        const bool pair = !start && g - r0 < GT && pg - r0 < GT;
        v = (g < 0xFFFFu ? g : 0xFFFFu) | static_cast<uint32_t>(pair) << 29 |
            static_cast<uint32_t>(!(k[PW - 1] >> 31)) << 30 |
            static_cast<uint32_t>(start) << 31;
      }
      info[j] = v;
      scan_publish(j * WARPS + warp, __ballot_sync(FULL, ent_start(v)),
                   sm.wsum);
    }
    // does the entry after the chunk continue the chunk's last run?
    const int64_t next = p + len;
    bool next_valid = false, cont = false;
    if (next < n) {
      next_valid = !(sm.raw[PW - 1][1 + len] >> 31);
      cont = next_valid;
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        const uint32_t d = sm.raw[q][1 + len] ^ sm.raw[q][len];
        cont &= (q == 0 ? d & ~gmask : d) == 0;
      }
    }

    // 2. number the runs (run starts in [0, e], plus the run carried in)
    scan_groups(WARPS * PER, sm.wsum);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const unsigned bal = __ballot_sync(FULL, ent_start(info[j]));
      const int runs = sm.wsum[j * WARPS + warp] + __popc(bal & below) +
                       ent_start(info[j]);
      info[j] |= static_cast<uint32_t>(runs) << 16;
      sm.ent[j * THREADS + threadIdx.x] = info[j];
    }
    __syncthreads();
    // the block owns the runs that start before its segment's end; an
    // owned last run that goes on is carried into the next chunk, which
    // loads while this one is processed
    const int last = ent_runs(sm.ent[len - 1]) - 1 + nopen;
    const int64_t lim64 = s1 - p < len ? s1 - p : len;
    const int lim = lim64 > 0 ? static_cast<int>(lim64) : 0;
    const int own = nopen + (lim > 0 ? ent_runs(sm.ent[lim - 1]) : 0);
    const bool carry = cont && last >= 0 && last < own;
    const int ob = carry && nopen && last == 0 ? ib : ib ^ 1;
    const int done = carry ? last : own;        // owned runs complete here
    more = next_valid && (carry || next < s1);
    const int next_len = chunk_len(n, next, s1, gp);
    if (more) load_chunk<PW>(sm, sw, n, next, next_len);

    // 3. the entries of owned runs, and which runs can add to the tile.  A
    //    run of one entry adds to the diagonal count only, so a chunk whose
    //    owned runs all hold one entry (and none is carried) stops here.
    bool paired = false;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = j * THREADS + threadIdx.x;
      const uint32_t v = sm.ent[e];
      const int r = ent_runs(v) - 1 + nopen;
      paired |= e < len && r >= 0 && r < own && ent_valid(v) &&
                !ent_start(v);
    }
    const bool pairs = __syncthreads_or(paired || carry);
    if (!pairs && !diag) {
      p = next;
      len = next_len;
      continue;
    }
    if (nopen && threadIdx.x == 0) {            // the flags carried in
      if (sm.carry & 1) sm.has_r[0] = 1;
      if (sm.carry & 2) sm.has_c[0] = 1;
    }
    unsigned use = 0;                 // bit j: entry j is in an owned run
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = j * THREADS + threadIdx.x;
      const uint32_t v = sm.ent[e];
      const int r = ent_runs(v) - 1 + nopen;
      if (e >= len || r < 0 || r >= own || !ent_valid(v)) continue;
      use |= 1u << j;
      const uint32_t g = ent_gid(v);
      const bool in_r = g - r0 < GT;
      const bool in_c = !diag && g - cg0 < GT;
      if (diag) {
        if (in_r) atomicAdd(&sm.diag[g - r0], 1);
        if (ent_pair(v)) sm.has_r[r] = 1;     // two entries in range
      } else {
        if (in_r) sm.has_r[r] = 1;
        if (in_c) sm.has_c[r] = 1;
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

    // 4. a multi-hot column for every kept run (the flags are cleared for
    //    the next chunk as they are read; the open run's go to sm.carry)
    const int rgroups = (own + THREADS - 1) / THREADS;
    unsigned keep = 0;                // bit j: run j * THREADS + tid kept
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (j >= rgroups) break;
      const int r = j * THREADS + threadIdx.x;
      if (r < own) {
        if (r < done && sm.has_r[r] && (diag || sm.has_c[r])) keep |= 1u << j;
        if (carry && r == last) sm.carry = sm.has_r[r] | sm.has_c[r] << 1;
        sm.has_r[r] = 0;
        sm.has_c[r] = 0;
      }
      scan_publish(j * WARPS + warp, __ballot_sync(FULL, keep >> j & 1),
                   sm.wsum);
    }
    const int kept = scan_groups(rgroups * WARPS, sm.wsum);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (j >= rgroups) break;
      const int r = j * THREADS + threadIdx.x;
      const unsigned bal = __ballot_sync(FULL, keep >> j & 1);
      if (r < own) {
        sm.kcol[r] = keep >> j & 1 ? static_cast<uint16_t>(
            sm.wsum[j * WARPS + warp] + __popc(bal & below)) : DROPPED;
      }
    }
    __syncthreads();
    const unsigned kc0 = nopen ? sm.kcol[0] : DROPPED;  // run carried in

    // 5. the products, KB kept runs at a time: write the multi-hots' ones
    //    (the run carried in also from its opens[] vectors), A B^T on the
    //    tensor cores, clear the ones again
    for (int kb = 0; kb < kept; kb += KB) {
      for (int pass = 0; pass < 2; ++pass) {
        const int8_t one = pass == 0 ? 1 : 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (!(use >> j & 1)) continue;
          const uint32_t v = sm.ent[j * THREADS + threadIdx.x];
          const unsigned c = static_cast<unsigned>(
              sm.kcol[ent_runs(v) - 1 + nopen]) - kb;
          if (c >= KB) continue;             // dropped, or another batch
          const uint32_t g = ent_gid(v);
          if (g - r0 < GT) sm.a[(g - r0) * LD + c] = one;
          if (!diag && g - cg0 < GT) sm.b[(g - cg0) * LD + c] = one;
        }
        if (kc0 - kb < KB) {
          const unsigned c = kc0 - kb;
          const int t = threadIdx.x & (GT - 1);
          if (threadIdx.x < GT) {
            if (sm.opens[ib][0][t]) sm.a[t * LD + c] = one;
          } else if (!diag && sm.opens[ib][1][t]) {
            sm.b[t * LD + c] = one;
          }
        }
        __syncthreads();
        if (pass == 1) break;
        const int ksteps = (min(KB, kept - kb) + 31) >> 5;
        for (int ks = 0; ks < ksteps; ++ks) {
          const int k0 = ks * 32 + t4 * 4;
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int8_t* ar = sm.a + (wm * 32 + mt * 16 + g8) * LD + k0;
            af[mt][0] = lds32(ar);
            af[mt][1] = lds32(ar + 8 * LD);
            af[mt][2] = lds32(ar + 16);
            af[mt][3] = lds32(ar + 8 * LD + 16);
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int8_t* br = bm + (wn * 64 + nt * 8 + g8) * LD + k0;
            const uint32_t b0 = lds32(br), b1 = lds32(br + 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
          }
        }
        __syncthreads();
      }
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
  __syncthreads();                             // the diagonal counts

  // 6. the nonzero sums into the output (and the mirror off the diagonal)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 32 + mt * 16 + g8 + (i >> 1) * 8;
        const int col = wn * 64 + nt * 8 + t4 * 2 + (i & 1);
        const int v = diag && row == col ? sm.diag[row] : acc[mt][nt][i];
        if (v == 0) continue;
        const int64_t a = r0 + row;
        const int64_t b = cg0 + col;
        atomicAdd(out + a * ncols + (b - c0), v);
        if (sym && !diag) atomicAdd(out + b * ncols + a, v);
      }
    }
  }
}

// Full mode (split == 0): (gp / 128)^2 tiles, those below the diagonal
// return at once; split mode: rows < split, columns >= split.  seg == 0
// sizes segments as whole chunks less SLACK each, for about TARGET_BLOCKS
// blocks.
template <int PW>
int gram_tiles(const uint32_t* sw, int64_t n, int gidbits, int gp, int split,
               int64_t seg, int32_t* out, cudaStream_t stream) {
  const int sym = split == 0;
  const int row_tiles = (sym ? gp : split) / GT;
  const int col_tiles = (gp - split) / GT;
  if (seg == 0) {
    const int tiles = sym ? row_tiles * (row_tiles + 1) / 2
                          : row_tiles * col_tiles;
    const int64_t blocks = (TARGET_BLOCKS + tiles - 1) / tiles;
    const int64_t step = CHUNK - SLACK;
    seg = (n + blocks * step - 1) / (blocks * step) * step;
  }
  auto kern = gram_mma_kernel<PW>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<PW>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((n + seg - 1) / seg), row_tiles,
                  col_tiles);
  kern<<<grid, THREADS, sizeof(Smem<PW>), stream>>>(
      sw, n, gidbits, split, gp - split, seg, sym, out);
  return last_error();
}

}  // namespace
}  // namespace sks

// sw (pw, n) u32 sorted packed stream; out int32, zeroed by the caller:
// (gp, gp) when split == 0, else (split, gp - split).  gp and split are
// multiples of 128, gp <= 65,536; every gid is < gp; seg entries per
// block, or 0 for the kernel's own sizing.
extern "C" int sks_gram_tiles(const void* sw, int pw, int64_t n, int gidbits,
                              int gp, int split, int64_t seg, void* out,
                              void* stream) {
  if (n <= 0 || seg < 0 || gidbits < 1 || gidbits > 31 || gp <= 0 ||
      gp % sks::GT != 0 || gp > sks::MAX_GP || split < 0 || split >= gp ||
      split % sks::GT != 0 || (n + seg - 1) / (seg ? seg : 1) > 0x7FFFFFFF) {
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
