"""Batched sketch-set intersection counts by binary-search probe.

The torch counterpart of the JAX package's ops/intersect.py (XLA glue
there, torch code here; no kernel).  The reference probes a hash map per
element of the smaller set (src/kmer_set.cpp:23-41).  Sketches are SORTED
unique (cap, 4) key arrays (cap a power of two, all-ones padded past the
count), so |A ∩ B| is a branchless lower bound: every row of A probes B
with log2(cap) gather + compare steps over the key words, then an equality
test at the found position.

Key words travel as int32 tensors holding u32 bits (ops/u64ops.py), so the
128-bit order must compare them as unsigned: flipping bit 31 of every word
maps the u32 order onto the int32 order (and keeps equality).  Rows past
`count` are all-ones sentinels, which sort last; the guards `pos <
count_b` and `idx < count_a` also tell a REAL all-ones key (possible when
the mask covers the full window) from padding.  Tensors stay on their
device; the probe is the cross-check engine beside the Gram
(ops/gram.py) and the pairs path of `FracMinHashSketcher.intersections`.
"""
from __future__ import annotations

import torch

_SIGN = -2 ** 31          # bit 31 of an int32 word


def _lex_lt(a, b) -> torch.Tensor:
    """a < b as 128-bit integers over little-endian word lists whose
    words compare as the int32 order of the flipped u32 words."""
    lt = a[0] < b[0]
    for q in range(1, len(a)):
        lt = (a[q] < b[q]) | ((a[q] == b[q]) & lt)
    return lt


def _intersect(keys_a, count_a, keys_b, count_b) -> torch.Tensor:
    """|A ∩ B| over broadcast batches: keys_a (..., cap, W) and keys_b
    (..., cap, W) int32 (u32 bits), sorted unique, all-ones padded; counts
    broadcast to the batch shape -> int32 (batch...)."""
    cap = keys_a.shape[-2]
    if cap & (cap - 1):
        raise ValueError(f"sketch capacity must be a power of two, got {cap}")
    batch = torch.broadcast_shapes(keys_a.shape[:-2], keys_b.shape[:-2])
    shape = batch + (cap,)
    a = [(keys_a[..., q] ^ _SIGN).expand(shape)
         for q in range(keys_a.shape[-1])]
    bt = [(keys_b[..., q] ^ _SIGN).expand(shape)
          for q in range(keys_b.shape[-1])]
    dev = keys_a.device

    # pos = #elements of B < a, per A row
    pos = torch.zeros(shape, dtype=torch.int64, device=dev)
    step = cap >> 1
    while step:
        cand = pos + step
        probe = [torch.gather(w, -1, cand - 1) for w in bt]
        pos = torch.where(_lex_lt(probe, a), cand, pos)
        step >>= 1

    at = pos.clamp(max=cap - 1)
    eq = torch.ones(shape, dtype=torch.bool, device=dev)
    for w, aq in zip(bt, a):
        eq &= torch.gather(w, -1, at) == aq
    idx = torch.arange(cap, device=dev)
    found = (eq & (pos < count_b.to(dev)[..., None])
             & (idx < count_a.to(dev)[..., None]))
    return found.sum(-1).to(torch.int32)


def pair_intersection_batch(keys_a, counts_a, keys_b, counts_b
                            ) -> torch.Tensor:
    """|A_i ∩ B_i| for a batch of pairs: keys (B, cap, W), counts (B,) ->
    (B,) int32."""
    return _intersect(keys_a, counts_a, keys_b, counts_b)


def intersection_tile(keys_rows, count_rows, keys_cols, count_cols
                      ) -> torch.Tensor:
    """All intersections of an (R-genome x C-genome) tile -> (R, C) int32:
    keys_rows (R, cap, W), keys_cols (C, cap, W), counts (R,) and (C,)."""
    return _intersect(keys_rows[:, None], count_rows[:, None],
                      keys_cols[None], count_cols[None])


def all_pairs_matrix(keys, counts, *, row_tile: int = 8) -> torch.Tensor:
    """Full (G, G) int32 intersection matrix, `row_tile` rows a step: each
    binary-search step materialises (row_tile, G, cap) word planes (at cap
    8192, G 128, row_tile 8 some hundreds of MB).  G must divide by
    row_tile."""
    g = keys.shape[0]
    if g % row_tile:
        raise ValueError(f"G = {g} must divide by row_tile = {row_tile}")
    out = torch.empty((g, g), dtype=torch.int32, device=keys.device)
    for r0 in range(0, g, row_tile):
        r1 = r0 + row_tile
        out[r0:r1] = intersection_tile(keys[r0:r1], counts[r0:r1], keys,
                                       counts)
    return out
