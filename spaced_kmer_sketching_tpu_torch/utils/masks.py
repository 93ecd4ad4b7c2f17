"""Spaced-seed mask generation and 128-bit mask utilities.

Reproduces the reference's mask semantics (src/kmer_bitset.cpp:132-152):
shuffle [0, window) with std::mt19937(seed) (libstdc++ std::shuffle), take the
first k positions, and set BOTH bits of each chosen nucleotide position.
Bit 2*p is nucleotide p's low bit, where p=0 is the LAST (most recent)
nucleotide of the window — consistent with the sliding-window layout.

Also provides contiguous masks (2k low bits set, src/kmer_bitset.cpp:21-56).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import KMER_BITSET_SIZE, MAX_KMER_LENGTH
from . import native
from .mt19937 import libstdcxx_shuffle


@dataclasses.dataclass(frozen=True)
class SpacedSeedMask:
    """A 128-bit spaced-seed mask."""
    window: int
    k: int
    lo: int   # bits 0..63
    hi: int   # bits 64..127

    @property
    def value(self) -> int:
        return (self.hi << 64) | self.lo

    @property
    def words_u32(self) -> np.ndarray:
        """Little-endian 4 x uint32 lanes (word i = bits 32i .. 32i+31)."""
        v = self.value
        return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(4)],
                        dtype=np.uint32)

    @property
    def count(self) -> int:
        """Number of set bits (2 * number of care positions)."""
        return bin(self.value).count("1")

    @property
    def care_positions(self) -> int:
        return self.count // 2

    def bitstring(self) -> str:
        """128-char binary string, MSB first — boost's operator<< format,
        used verbatim in the reference CSV (src/kmer-sketching.cpp:76)."""
        return format(self.value, f"0{KMER_BITSET_SIZE}b")


def _mask_from_positions(window: int, k: int, positions) -> SpacedSeedMask:
    v = 0
    for p in positions:
        v |= 0b11 << (2 * int(p))
    return SpacedSeedMask(window=window, k=k,
                          lo=v & 0xFFFFFFFFFFFFFFFF, hi=v >> 64)


def spaced_seed_mask(window: int, k: int, seed: int = 0,
                     use_native: bool = True) -> SpacedSeedMask:
    """Random spaced-seed mask, bit-exact with the reference's generator."""
    if window > MAX_KMER_LENGTH:
        raise ValueError(
            f"window {window} exceeds maximum k-mer length {MAX_KMER_LENGTH}")
    if not (0 < k <= window):
        raise ValueError(f"need 0 < k <= window, got k={k} window={window}")
    positions = None
    if use_native:
        positions = native.mask_indices(window, k, seed)
    if positions is None:
        positions = libstdcxx_shuffle(list(range(window)), seed)[:k]
    return _mask_from_positions(window, k, positions)


def contiguous_mask(k: int) -> SpacedSeedMask:
    """Mask with the 2k low bits set (contiguous k-mer, src/kmer_bitset.cpp:21-56)."""
    if k > MAX_KMER_LENGTH:
        raise ValueError(
            f"Given k-mer length exceeds maximum k-mer length ({MAX_KMER_LENGTH})")
    return _mask_from_positions(k, k, range(k))
