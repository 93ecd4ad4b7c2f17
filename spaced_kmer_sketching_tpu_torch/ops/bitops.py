"""128-bit k-mer bit utilities: nucleotide-granular reversal, complement,
canonicalization — host (python int) and lane (4 u32 words) versions.

The port of the JAX package's ops/bitops.py.  The host versions are its
copies; the lane versions take torch tensors, each u32 word an int64
tensor holding a value in [0, 2**32) and masked back into that range after
every shift or complement (ops/u64ops.py's convention: PyTorch on the CPU
has no shifts for uint32).

Parity targets:
  * reverse_kmer_bitset — butterfly reversal at 2-bit (nucleotide)
    granularity over the 128-bit window (src/kmer_bitset.cpp:65-119; the
    reference precomputes 6 alternating-block masks and swaps blocks of
    2,4,...,64 bits).
  * reverse_complement — reverse, flip all bits, shift right by
    (MAX_KMER_LENGTH - window) * 2 to re-align (src/kmers.cpp:16-28).
  * canonical_kmer — min of (kmer, revcomp) by masked value
    (src/kmers.cpp:31-35).  The live pipeline canonicalizes in the extract
    kernels; these helpers replicate the reference's standalone utility
    path (src/kmer_sliding.cpp:61-98) for capability parity.
"""
from __future__ import annotations

import torch

from ..config import KMER_BITSET_SIZE, MAX_KMER_LENGTH
from .u64ops import M32

_MASK128 = (1 << KMER_BITSET_SIZE) - 1

# butterfly passes at growing block sizes, starting at nucleotide (2-bit)
# granularity: swap adjacent blocks of 2, 4, 8, 16, 32, 64 bits.
_PASSES = [2, 4, 8, 16, 32, 64]


def _alternating_mask(block: int) -> int:
    """128-bit mask with alternating `block`-bit groups set (low group set)."""
    m = 0
    for start in range(0, KMER_BITSET_SIZE, 2 * block):
        m |= ((1 << block) - 1) << start
    return m


_HOST_MASKS = {b: _alternating_mask(b) for b in _PASSES}


def reverse_kmer_bitset(value: int) -> int:
    """Reverse the order of the 64 nucleotide (2-bit) codes in a 128-bit
    value (src/kmer_bitset.cpp:105-119)."""
    v = value & _MASK128
    for b in _PASSES:
        m = _HOST_MASKS[b]
        v = ((v & m) << b) | ((v >> b) & m)
    return v


def reverse_complement(kmer_bits: int, window: int) -> int:
    """Reverse complement of a window-length k-mer held in the low bits
    (src/kmers.cpp:16-28)."""
    rev = reverse_kmer_bitset(kmer_bits)
    flipped = (~rev) & _MASK128
    return flipped >> ((MAX_KMER_LENGTH - window) * 2)


def canonical_kmer(masked_a: int, masked_b: int) -> int:
    """Numeric min — the reference's canonical pick (src/kmers.cpp:31-35)."""
    return masked_a if masked_a < masked_b else masked_b


# ---- lane versions over 4 little-endian u32 words (int64 tensors) -----------

def _rev32_2bit(w: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit groups within each u32 word."""
    for m, s in ((0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8)):
        w = ((w & m) << s) | ((w >> s) & m)
    return ((w << 16) | (w >> 16)) & M32


def reverse_kmer_lanes(words):
    """Lane reversal: [w0, w1, w2, w3] -> nucleotide-reversed words."""
    return [_rev32_2bit(words[3]), _rev32_2bit(words[2]),
            _rev32_2bit(words[1]), _rev32_2bit(words[0])]


def reverse_complement_lanes(words, window: int):
    """Lane reverse complement with the reference's re-alignment shift."""
    rev = [~w & M32 for w in reverse_kmer_lanes(words)]
    return shift_right_lanes(rev, (MAX_KMER_LENGTH - window) * 2)


def shift_right_lanes(words, r: int):
    """Logical right shift of a 128-bit 4-word value by static r bits."""
    q, s = divmod(r, 32)
    out = []
    for i in range(4):
        lo = words[i + q] if i + q < 4 else torch.zeros_like(words[0])
        if s == 0:
            out.append(lo)
            continue
        hi = words[i + q + 1] if i + q + 1 < 4 else torch.zeros_like(words[0])
        out.append((lo >> s) | ((hi << (32 - s)) & M32))
    return out
