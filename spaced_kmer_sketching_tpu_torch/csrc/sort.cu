// K4: batched lexicographic ascending sort of multi-word keys.
//
// Replaces spaced_kmer_sketching_tpu/ops/pallas/sort.py::bitonic_sort_128
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

// Bitonic passes at distances j0, j0/2, ..., 1 of stage `k` on the tile
// in shared memory; local0 is the tile's first row-local index.
template <int KW>
__device__ void tile_passes(uint32_t* sm, int tile, int64_t local0,
                            int64_t k, int j0) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int i = 2 * p - (p & (j - 1));
      const bool asc = ((local0 + i) & k) == 0;
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
    int64_t total, int64_t n, int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile<KW>(sm, in + base, total, tile);
  const int64_t local0 = base & (n - 1);
  for (int k = 2; k <= tile; k <<= 1) tile_passes<KW>(sm, tile, local0, k, k >> 1);
  store_tile<KW>(sm, out + base, total, tile);
}

template <int KW>
__global__ void __launch_bounds__(SORT_THREADS) tile_merge_kernel(
    uint32_t* __restrict__ data, int64_t total, int64_t n, int64_t k,
    int tile) {
  extern __shared__ uint32_t sm[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  load_tile<KW>(sm, data + base, total, tile);
  tile_passes<KW>(sm, tile, base & (n - 1), k, tile >> 1);
  store_tile<KW>(sm, data + base, total, tile);
}

template <int KW>
__global__ void global_pass_kernel(uint32_t* __restrict__ data, int64_t total,
                                   int64_t n, int64_t k, int64_t j) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total / 2) return;
  const int64_t i = 2 * p - (p & (j - 1));
  const int64_t partner = i + j;
  const bool asc = ((i & (n - 1)) & k) == 0;
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

template <int KW>
int sort_rows(const uint32_t* in, uint32_t* out, int g, int64_t n,
              cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(g) * n;
  const int tile = static_cast<int>(n < TILE ? n : TILE);
  const size_t smem = sizeof(uint32_t) * KW * tile;
  const unsigned tiles = static_cast<unsigned>(total / tile);
  tile_sort_kernel<KW><<<tiles, SORT_THREADS, smem, stream>>>(in, out, total,
                                                             n, tile);
  int err = last_error();
  const unsigned pass_blocks =
      static_cast<unsigned>((total / 2 + PASS_THREADS - 1) / PASS_THREADS);
  for (int64_t k = 2 * static_cast<int64_t>(tile); k <= n && !err; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile && !err; j >>= 1) {
      global_pass_kernel<KW><<<pass_blocks, PASS_THREADS, 0, stream>>>(
          out, total, n, k, j);
      err = last_error();
    }
    if (!err) {
      tile_merge_kernel<KW><<<tiles, SORT_THREADS, smem, stream>>>(
          out, total, n, k, tile);
      err = last_error();
    }
  }
  return err;
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
    case 1: return sks::sort_rows<1>(i, o, g, n, s);
    case 2: return sks::sort_rows<2>(i, o, g, n, s);
    case 3: return sks::sort_rows<3>(i, o, g, n, s);
    case 4: return sks::sort_rows<4>(i, o, g, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
