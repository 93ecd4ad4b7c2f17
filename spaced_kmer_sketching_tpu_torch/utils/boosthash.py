"""Boost-compatible hashing of 128-bit k-mer keys (host / numpy side).

The reference filters k-mers with ``frac_min_hash`` (src/kmer.hpp:135-149):

    fmh(kmer) = boost_hash(masked_bits) ^ boost_hash(mask)
                ^ boost_hash<int>(window_length) ^ boost_hash<int>(nonce)

where ``masked_bits``/``mask`` are ``boost::dynamic_bitset<>`` of 128 bits
(two 64-bit blocks) and a k-mer is kept iff ``fmh % 200 == 0``
(src/kmer-sketching.cpp:29-34).

``boost::hash_value(dynamic_bitset)`` is::

    res = hash_value(m_num_bits)        # = 128 (identity for integrals)
    hash_combine(res, m_bits)           # m_bits = vector<uint64>{lo, hi}
    return res

with ``hash<vector>`` = ``hash_range`` = fold of ``hash_combine`` over the
blocks from seed 0.  ``hash_combine`` changed in boost 1.81:

  modern (>= 1.81):  seed = hash_mix(seed + 0x9e3779b9 + hash_value(v))
  legacy (<  1.81):  murmur-style fn(seed, hash_value(v))  [hash_combine_impl<64>]

Both variants are implemented here bit-exactly as vectorized numpy over
uint64, so the host oracle, the C++ extension, and the on-chip uint32-lane
implementation (ops/u64ops.py) can be cross-checked key-by-key.
"""
from __future__ import annotations

import numpy as np

U64 = np.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)

GOLDEN32 = np.uint64(0x9E3779B9)          # boost hash_combine additive constant
MIX_M = np.uint64(0x0E9846AF9B1A615D)     # boost >=1.81 hash_mix multiplier
LEGACY_M = np.uint64(0xC6A4A7935BD1E995)  # boost <1.81 hash_combine_impl<64> (murmur)
LEGACY_ADD = np.uint64(0xE6546B64)


def _u64(x) -> np.ndarray:
    return np.asarray(x, dtype=U64)


def hash_mix(x: np.ndarray) -> np.ndarray:
    """boost::hash_detail::hash_mix for 64-bit size_t (boost >= 1.81)."""
    x = _u64(x).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(32)
        x *= MIX_M
        x ^= x >> np.uint64(32)
        x *= MIX_M
        x ^= x >> np.uint64(28)
    return x


def hash_combine_modern(seed: np.ndarray, value: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return hash_mix(_u64(seed) + GOLDEN32 + _u64(value))


def hash_combine_legacy(seed: np.ndarray, value: np.ndarray) -> np.ndarray:
    """boost::hash_detail::hash_combine_impl<64>::fn (boost < 1.81)."""
    h = _u64(seed).copy()
    k = _u64(value).copy()
    with np.errstate(over="ignore"):
        k *= LEGACY_M
        k ^= k >> np.uint64(47)
        k *= LEGACY_M
        h = (h ^ k) * LEGACY_M
        h += LEGACY_ADD
    return h


def _combiner(variant: str):
    if variant == "modern":
        return hash_combine_modern
    if variant == "legacy":
        return hash_combine_legacy
    raise ValueError(f"unknown hash variant {variant!r}")


def hash_bitset128(lo: np.ndarray, hi: np.ndarray, variant: str = "modern") -> np.ndarray:
    """boost::hash_value of a 128-bit dynamic_bitset with blocks [lo, hi].

    Vectorized: lo/hi may be arrays of uint64.
    """
    comb = _combiner(variant)
    lo = _u64(lo)
    hi = _u64(hi)
    inner = comb(comb(np.zeros_like(lo), lo), hi)      # hash_range over blocks
    return comb(np.full_like(lo, 128), inner)          # res = hash(128); combine(res, blocks)


def frac_min_hash(masked_lo, masked_hi, mask_lo: int, mask_hi: int,
                  window: int, nonce: int = 1, variant: str = "modern") -> np.ndarray:
    """The reference's frac_min_hash over masked 128-bit keys (vectorized).

    boost::hash<int> of small non-negative ints is the identity in both
    variants, so window/nonce enter as raw values (src/kmer.hpp:141,146-147).
    """
    salt = fmh_salt(mask_lo, mask_hi, window, nonce, variant)
    return hash_bitset128(masked_lo, masked_hi, variant) ^ np.uint64(salt)


def fmh_salt(mask_lo: int, mask_hi: int, window: int, nonce: int = 1,
             variant: str = "modern") -> int:
    """Per-experiment constant: H(mask) ^ window ^ nonce (a single uint64)."""
    h_mask = hash_bitset128(np.uint64(mask_lo), np.uint64(mask_hi), variant)
    return int(h_mask ^ np.uint64(window) ^ np.uint64(nonce))


def sketch_keep(masked_lo, masked_hi, salt: int, scale: int = 200,
                variant: str = "modern") -> np.ndarray:
    """keep iff (H(masked) ^ salt) % scale == 0 (src/kmer-sketching.cpp:31-33)."""
    h = hash_bitset128(masked_lo, masked_hi, variant) ^ np.uint64(salt)
    return (h % np.uint64(scale)) == 0
