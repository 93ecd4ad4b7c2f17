"""Windowed spaced-seed k-mer extraction — the plain PyTorch version.

The counterpart of the JAX package's ops/extract.py, and the arithmetic
that the extract kernel (csrc/extract.cu) computes per window.  It restates
the reference's per-nucleotide sliding loop (src/kmer_sliding.cpp:112-186)
as data-parallel window construction:
  * forward window F(i)  = sum_j codes[i + w-1-j] << 2j      (newest at bits 0-1)
  * revcomp window R(i)  = sum_j (3 - codes[i + j]) << 2j    (newest at top)
  * both strands masked with the SAME un-reversed mask
    (src/kmer_sliding.cpp:159-160 — deliberate; do not "fix")
  * canonical = forward iff masked_fwd < masked_rc numerically, else revcomp
    (strictly-less picks forward; src/kmer_sliding.cpp:164-175)
  * a window is valid iff its first and last positions share a non-negative
    run id, so windows never span a non-ACGT split or the padding tail.

Keys are 128-bit values as 4 u32 words, little-endian, each held in an int64
tensor (see ops/u64ops.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

KEY_WORDS = 4


def extract_windows(codes: torch.Tensor, run_id: torch.Tensor, window: int,
                    mask_words: Sequence[int]) -> Tuple[tuple, torch.Tensor]:
    """Canonical masked keys for every window start position.

    codes (..., n) int64 values 0..3; run_id (..., n) integer, -1 on padding;
    mask_words: 4 host ints (the mask's u32 words).  Returns
    ((w0, w1, w2, w3) each (..., n - window + 1) int64 u32 words,
    valid (..., n - window + 1) bool)."""
    n = codes.shape[-1]
    nw = n - window + 1
    fw = [torch.zeros(codes.shape[:-1] + (nw,), dtype=torch.int64,
                      device=codes.device) for _ in range(KEY_WORDS)]
    rw = [torch.zeros_like(fw[0]) for _ in range(KEY_WORDS)]
    for j in range(window):
        q, r = divmod(2 * j, 32)
        fw[q] |= codes[..., window - 1 - j:window - 1 - j + nw] << r
        rw[q] |= (3 - codes[..., j:j + nw]) << r

    mf = [fw[q] & int(mask_words[q]) for q in range(KEY_WORDS)]
    mr = [rw[q] & int(mask_words[q]) for q in range(KEY_WORDS)]
    fwd_lt = lex_lt_128(mf, mr)
    canon = tuple(torch.where(fwd_lt, mf[q], mr[q]) for q in range(KEY_WORDS))

    rid_a = run_id[..., :nw]
    rid_b = run_id[..., window - 1:window - 1 + nw]
    valid = (rid_a == rid_b) & (rid_a >= 0)
    return canon, valid


def lex_lt_128(a, b) -> torch.Tensor:
    """a < b as 128-bit integers, given 4-word little-endian lists."""
    lt = a[0] < b[0]
    for q in range(1, KEY_WORDS):
        lt = (a[q] < b[q]) | ((a[q] == b[q]) & lt)
    return lt
