// K12: a bit-tight block of sketches unpacked straight into the packed
// (key, gid) planes that K5 merges.
//
// Replaces the XLA glue of the JAX package's blocked presort over a tight
// slab (spaced_kmer_sketching_tpu/ops/gram.py::presort_blocks_tight :647):
// unpack_keys_tight (:570), whose 4-key groups of tight_words4(key_bits)
// words hold each key's key_bits low bits back to back, and
// _pack_gid_planes (:210), which packs (key << gidbits) | gid over pw u32
// planes, word pw-1 most significant.  XLA fuses the two into one pass; so
// does this kernel.  It is not a port of a Pallas kernel.
//
// Input: tight (rows, cap4, w4) u32, counts (rows,) i32, key_bits <= 64,
// 0 < gidbits < 32, pw = ceil((key_bits + gidbits + 1) / 32) <= 3.  Output:
// pw planes of rows * cap4 * 4 u32 each; entry e = row * cap + slot is
// (key << gidbits) | row, or all-ones in every plane when slot >= the row's
// count (the sentinel rows the host packer left as zeros).
//
// Bound: bytes.  Every tight word is read once and every packed word
// written once (phase 6's block: 20.97 MB in, 33.55 MB out, 16.3 us at
// 3.35 TB/s); the arithmetic is a few shifts an entry.  So the design only
// keeps both streams coalesced: a CTA stages its 256 groups' words in
// shared memory with consecutive threads on consecutive words, then each
// thread unpacks one group (4 keys, each from at most three words at a
// shift known only at run time, hence the staging: registers cannot be
// indexed) and writes its 4 entries of each plane as one 16-byte store,
// consecutive threads on consecutive 16 bytes.
#include "common.cuh"

namespace sks {
namespace {

constexpr int TIGHT_GROUPS = 256;    // 4-key groups a CTA, one a thread
constexpr int TIGHT_MAX_W4 = 8;      // tight_words4(64)

template <int PW>
__global__ void __launch_bounds__(TIGHT_GROUPS) tight_gid_planes_kernel(
    const uint32_t* __restrict__ tight, const int32_t* __restrict__ counts,
    int64_t groups, int cap4, int w4, int key_bits, int gidbits,
    uint32_t* __restrict__ out) {
  // two spare words: a key's third word may lie past the last group
  __shared__ uint32_t words[TIGHT_GROUPS * TIGHT_MAX_W4 + 2];
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * TIGHT_GROUPS;
  const int n = static_cast<int>(
      groups - g0 < TIGHT_GROUPS ? groups - g0 : TIGHT_GROUPS);
  const uint32_t* src = tight + g0 * w4;
  for (int i = threadIdx.x; i < n * w4; i += TIGHT_GROUPS) words[i] = src[i];
  if (threadIdx.x < 2) words[n * w4 + threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x >= n) return;

  const int64_t t = g0 + threadIdx.x;
  const int64_t row = t / cap4;
  const int slot = static_cast<int>(t - row * cap4) * 4;
  const int count = counts[row];
  const uint32_t* grp = words + threadIdx.x * w4;
  const uint64_t kmask =
      key_bits >= 64 ? ~uint64_t{0} : (uint64_t{1} << key_bits) - 1;
  const uint32_t gid = static_cast<uint32_t>(row);
  uint32_t p[PW][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = j * key_bits, w = o >> 5, sh = o & 31;
    uint64_t v = ((uint64_t{grp[w + 1]} << 32) | grp[w]) >> sh;
    if (sh) v |= uint64_t{grp[w + 2]} << (64 - sh);
    v &= kmask;
    const bool valid = slot + j < count;
    // (v << gidbits) | gid as pw words; 1 <= gidbits <= 31
    const uint32_t word[3] = {
        static_cast<uint32_t>(v << gidbits) | gid,
        static_cast<uint32_t>(v >> (32 - gidbits)),
        static_cast<uint32_t>(v >> (64 - gidbits))};
#pragma unroll
    for (int q = 0; q < PW; ++q) p[q][j] = valid ? word[q] : SENT;
  }
  const int64_t plane = groups * 4;
#pragma unroll
  for (int q = 0; q < PW; ++q) {
    *reinterpret_cast<uint4*>(out + q * plane + 4 * t) =
        make_uint4(p[q][0], p[q][1], p[q][2], p[q][3]);
  }
}

template <int PW>
int tight_gid_planes(const uint32_t* tight, const int32_t* counts,
                     int64_t rows, int cap4, int w4, int key_bits,
                     int gidbits, uint32_t* out, cudaStream_t s) {
  const int64_t groups = rows * cap4;
  const int64_t ctas = (groups + TIGHT_GROUPS - 1) / TIGHT_GROUPS;
  tight_gid_planes_kernel<PW><<<static_cast<unsigned>(ctas), TIGHT_GROUPS, 0,
                                s>>>(tight, counts, groups, cap4, w4,
                                     key_bits, gidbits, out);
  return last_error();
}

}  // namespace
}  // namespace sks

// K12: tight (rows, cap4, w4) u32, counts (rows,) i32 -> out (pw, rows *
// cap4 * 4) u32 packed planes with gid = row.  rows <= 2^gidbits, w4 =
// ceil(4 * key_bits / 32), pw the pack plan of key_bits + gidbits + 1
// bits.  out may not alias the inputs.
extern "C" int sks_tight_gid_planes(const void* tight, const void* counts,
                                    int64_t rows, int cap4, int w4,
                                    int key_bits, int gidbits, int pw,
                                    void* out, void* stream) {
  if (rows <= 0 || cap4 <= 0 || key_bits < 1 || key_bits > 64 ||
      w4 != (4 * key_bits + 31) / 32 || gidbits < 1 || gidbits > 31 ||
      rows > (int64_t{1} << gidbits) ||
      pw != (key_bits + gidbits + 1 + 31) / 32 ||
      (rows * cap4 + sks::TIGHT_GROUPS - 1) / sks::TIGHT_GROUPS >
          0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const uint32_t*>(tight);
  const auto* c = static_cast<const int32_t*>(counts);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pw) {
    case 1: return sks::tight_gid_planes<1>(t, c, rows, cap4, w4, key_bits,
                                            gidbits, o, s);
    case 2: return sks::tight_gid_planes<2>(t, c, rows, cap4, w4, key_bits,
                                            gidbits, o, s);
    case 3: return sks::tight_gid_planes<3>(t, c, rows, cap4, w4, key_bits,
                                            gidbits, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
