"""Bit-exact std::mt19937 + libstdc++ std::shuffle replica (pure Python),
frozen for the benchmark's reference.

The reference generates spaced-seed masks with
``std::shuffle(v.begin(), v.end(), std::mt19937(seed))``
(src/kmer_bitset.cpp:139-141).  Every downstream number (which k-mers survive
FracMinHash, hence every ANI value) depends on reproducing that permutation
exactly, so this module replicates:

  * std::mt19937 (the C++11-standardised Mersenne Twister), and
  * libstdc++'s std::shuffle algorithm, which for small ranges uses
    __gen_two_uniform_ints (one uniform draw yields two swap indices) and
    libstdc++'s uniform_int_distribution (rejection + downscaling).

The benchmark's tests hold the masks it gives to the program's.
"""
from __future__ import annotations

from typing import List

_U32 = 0xFFFFFFFF


class MT19937:
    """C++11 std::mt19937 (32-bit Mersenne Twister, n=624)."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 0):
        self.mt: List[int] = [0] * self.N
        self.mt[0] = seed & _U32
        for i in range(1, self.N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & _U32
        self.idx = self.N

    def _generate(self):
        mt = self.mt
        for i in range(self.N):
            y = (mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER)
            mt[i] = mt[(i + self.M) % self.N] ^ (y >> 1)
            if y & 1:
                mt[i] ^= self.MATRIX_A
        self.idx = 0

    def __call__(self) -> int:
        if self.idx >= self.N:
            self._generate()
        y = self.mt[self.idx]
        self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _U32

    min_ = 0
    max_ = _U32


def _uniform_int(gen: MT19937, a: int, b: int) -> int:
    """libstdc++ uniform_int_distribution<unsigned long>{a, b}(gen).

    Only the downscaling branch is needed (generator range 2^32-1 always
    exceeds our tiny swap ranges); replicated from bits/uniform_int_dist.h.
    """
    urange = b - a
    urngrange = gen.max_ - gen.min_
    assert urngrange > urange, "only the downscaling branch is implemented"
    uerange = urange + 1
    scaling = urngrange // uerange
    past = uerange * scaling
    while True:
        ret = gen() - gen.min_
        if ret < past:
            break
    return a + ret // scaling


def _gen_two_uniform_ints(b0: int, b1: int, gen: MT19937):
    """libstdc++ __gen_two_uniform_ints: one draw in [0, b0*b1) -> (x/b1, x%b1)."""
    x = _uniform_int(gen, 0, b0 * b1 - 1)
    return x // b1, x % b1


def libstdcxx_shuffle(seq: list, seed: int) -> list:
    """std::shuffle(seq, std::mt19937(seed)) exactly as libstdc++ implements it.

    Valid for len(seq) small enough that urngrange/urange >= urange
    (true for anything <= 65535, far above the 64-nt max window).
    """
    v = list(seq)
    n = len(v)
    if n <= 1:
        return v
    g = MT19937(seed)
    i = 1  # index of the next element to place
    if n % 2 == 0:
        j = _uniform_int(g, 0, 1)
        v[i], v[j] = v[j], v[i]
        i += 1
    while i < n:
        swap_range = i + 1
        p0, p1 = _gen_two_uniform_ints(swap_range, swap_range + 1, g)
        v[i], v[p0] = v[p0], v[i]
        i += 1
        v[i], v[p1] = v[p1], v[i]
        i += 1
    return v
