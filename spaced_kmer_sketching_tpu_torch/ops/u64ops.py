"""64-bit integer arithmetic as pairs of u32 words held in int64 tensors.

The plain PyTorch counterpart of the JAX package's ops/u64ops.py and the
128-bit word helpers of ops/bitops.py.  PyTorch on the CPU has no shift,
add or compare for uint32/uint64, and `>>` on int64 is arithmetic, so every
u32 word here is an int64 tensor holding a value in [0, 2**32), and every
result is masked back into that range.  Products are formed on 16-bit
halves so that no intermediate leaves the non-negative int64 range.  A u64
is a tuple (hi, lo) of such words.  Works on any device: the extract
kernel's plain version (ops/cuda/extract.py) runs these on the card too.

The boost hash (utils/boosthash.py documents the algorithms) is bit-exact
with the host numpy version and with native/sketchlib.cpp, for both the
'modern' (boost >= 1.81) and 'legacy' (boost < 1.81) variants.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF

# boost constants (see utils/boosthash.py)
GOLDEN32 = 0x9E3779B9
MIX_M = (0x0E9846AF, 0x9B1A615D)      # boost>=1.81 hash_mix multiplier (hi, lo)
LEGACY_M = (0xC6A4A793, 0x5BD1E995)   # boost<1.81 murmur multiplier
LEGACY_ADD = 0xE6546B64


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit containers (or any integer tensor) -> int64 u32 values."""
    return x.to(torch.int64) & M32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 bit containers (the same 32 bits)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def add64(a, b):
    ah, al = a
    bh, bl = b
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def mul32_full(a, b):
    """Full 64-bit product of two u32 words -> (hi, lo)."""
    p0 = (a & M16) * b                 # < 2**48
    p1 = (a >> 16) * b                 # < 2**48
    t = p0 + ((p1 & M16) << 16)        # < 2**49
    return ((t >> 32) + (p1 >> 16)) & M32, t & M32


def mul32_lo(a, b):
    """Low 32 bits of the product of two u32 words."""
    return ((a & M16) * b + ((((a >> 16) * b) & M16) << 16)) & M32


def mul64(a, b):
    """Low 64 bits of a 64x64 product."""
    ah, al = a
    bh, bl = b
    hi, lo = mul32_full(al, bl)
    hi = (hi + mul32_lo(al, bh) + mul32_lo(ah, bl)) & M32
    return hi, lo


def _const(value: int, like: torch.Tensor):
    return torch.full_like(like, value)


def hash_mix64(x):
    """boost>=1.81 hash_detail::hash_mix over (hi, lo) u32 pairs."""
    h, l = x
    m = (_const(MIX_M[0], h), _const(MIX_M[1], h))
    l = l ^ h                      # x ^= x >> 32
    h, l = mul64((h, l), m)
    l = l ^ h                      # x ^= x >> 32
    h, l = mul64((h, l), m)
    # x ^= x >> 28
    h2 = h >> 28
    l2 = ((l >> 28) | (h << 4)) & M32
    return h ^ h2, l ^ l2


def combine_modern(seed, value):
    c = (torch.zeros_like(seed[0]), _const(GOLDEN32, seed[0]))
    return hash_mix64(add64(add64(seed, c), value))


def combine_legacy(h, k):
    m = (_const(LEGACY_M[0], k[0]), _const(LEGACY_M[1], k[0]))
    k = mul64(k, m)
    k = xor64(k, (torch.zeros_like(k[0]), k[0] >> 15))  # k ^= k >> 47
    k = mul64(k, m)
    h = xor64(h, k)
    h = mul64(h, m)
    return add64(h, (torch.zeros_like(h[0]), _const(LEGACY_ADD, h[0])))


def hash_bitset128(w0, w1, w2, w3, variant: str = "modern"):
    """boost::hash_value of a 128-bit dynamic_bitset given 4 u32 words
    (little-endian: w0 = bits 0..31).  Returns a (hi, lo) u64 pair."""
    lo64 = (w1, w0)
    hi64 = (w3, w2)
    zero = (torch.zeros_like(w0), torch.zeros_like(w0))
    size = (torch.zeros_like(w0), _const(128, w0))
    if variant == "modern":
        inner = combine_modern(combine_modern(zero, lo64), hi64)
        return combine_modern(size, inner)
    if variant != "legacy":
        raise ValueError(f"unknown hash variant {variant!r}")
    inner = combine_legacy(combine_legacy(zero, lo64), hi64)
    return combine_legacy(size, inner)


def mod_small(x, m: int):
    """(hi, lo) u64 mod a small modulus m (< 2**16)."""
    h, l = x
    pow32 = (1 << 32) % m
    return ((h % m) * pow32 + (l % m)) % m


def fmh_keep(w0, w1, w2, w3, salt: int, scale: int,
             variant: str = "modern") -> torch.Tensor:
    """FracMinHash keep decision per key: (H(key) ^ salt) % scale == 0.
    salt = H(mask) ^ window ^ nonce, a host int (utils/boosthash.fmh_salt)."""
    h = hash_bitset128(w0, w1, w2, w3, variant)
    h = xor64(h, (_const((salt >> 32) & M32, w0), _const(salt & M32, w0)))
    return mod_small(h, scale) == 0


def salt_pair(salt: int) -> np.ndarray:
    """Split a host-computed 64-bit salt into a (2,) uint32 [hi, lo] array."""
    return np.array([(salt >> 32) & M32, salt & M32], dtype=np.uint32)


def salt_from_pair(pair) -> int:
    """A (2,) [hi, lo] u32 salt pair (salt_pair's output) -> the 64-bit
    host int the port's kernels take."""
    return (int(pair[0]) & M32) << 32 | (int(pair[1]) & M32)
