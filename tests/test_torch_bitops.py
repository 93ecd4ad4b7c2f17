"""The port's ops/bitops.py against the JAX package's and the naive
per-nucleotide cases of tests/test_bitops.py (src/kmer_bitset.cpp:65-119,
src/kmers.cpp:16-35).  Values are integers: every comparison is exact."""
import numpy as np
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops import bitops as jbitops

from spaced_kmer_sketching_tpu_torch.ops import bitops

from test_bitops import naive_reverse


def to_lanes(vs):
    """128-bit ints -> 4 int64 tensors of u32 words (ops/u64ops layout)."""
    return [torch.tensor([(v >> (32 * i)) & 0xFFFFFFFF for v in vs],
                         dtype=torch.int64) for i in range(4)]


def from_lanes(ws):
    return [sum(int(w[k]) << (32 * i) for i, w in enumerate(ws))
            for k in range(ws[0].numel())]


def jax_lanes(vs):
    return [jnp.asarray(np.array([(v >> (32 * i)) & 0xFFFFFFFF for v in vs],
                                 np.uint32)) for i in range(4)]


def jax_from_lanes(ws):
    ws = [np.asarray(w).astype(np.uint64) for w in ws]
    return [sum(int(w[k]) << (32 * i) for i, w in enumerate(ws))
            for k in range(ws[0].size)]


def values(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") for _ in range(n)] + [
        0, (1 << 128) - 1]


def test_host_versions_match_naive_and_jax():
    for v in values(0, 50):
        assert bitops.reverse_kmer_bitset(v) == naive_reverse(v) == \
            jbitops.reverse_kmer_bitset(v)
        for w in (1, 5, 20, 31, 64):
            small = v & ((1 << (2 * w)) - 1)
            assert bitops.reverse_complement(small, w) == \
                jbitops.reverse_complement(small, w)
    assert bitops.canonical_kmer(5, 9) == bitops.canonical_kmer(9, 5) == 5
    assert bitops.canonical_kmer(7, 7) == 7


def test_lane_reverse_matches_host_and_jax():
    vs = values(1, 20)
    got = from_lanes(bitops.reverse_kmer_lanes(to_lanes(vs)))
    assert got == [bitops.reverse_kmer_bitset(v) for v in vs]
    assert got == jax_from_lanes(jbitops.reverse_kmer_lanes(jax_lanes(vs)))


def test_lane_reverse_complement_semantics():
    """A window-w k-mer in the low 2w bits: its reverse complement is the
    complemented codes in reverse order (test_bitops.py's naive case)."""
    rng = np.random.default_rng(2)
    for w in (5, 20, 31, 64):
        codes = rng.integers(0, 4, w)
        v = 0
        for c in codes:                        # codes[0] oldest at top
            v = (v << 2) | int(c)
        want = 0
        for c in reversed(codes):
            want = (want << 2) | (3 - int(c))
        assert bitops.reverse_complement(v, w) == want
        got = from_lanes(bitops.reverse_complement_lanes(to_lanes([v]), w))
        assert got == [want] == jax_from_lanes(
            jbitops.reverse_complement_lanes(jax_lanes([v]), w))


def test_shift_right_lanes_matches_jax():
    vs = values(3, 8)
    for r in (0, 1, 31, 32, 33, 64, 95, 127):
        got = from_lanes(bitops.shift_right_lanes(to_lanes(vs), r))
        assert got == [v >> r for v in vs]
        assert got == jax_from_lanes(jbitops.shift_right_lanes(jax_lanes(vs),
                                                               r))
