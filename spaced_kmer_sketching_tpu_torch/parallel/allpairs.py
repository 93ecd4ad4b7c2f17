"""Blocked all-pairs intersections on one GPU: the block-cache schedule.

The port of the single-device gram route of the JAX package's
parallel/allpairs.py (blocked_all_pairs :57 -> _gram_blocked_cached :209
-> pair_tile_sweep :282), which its sketcher takes above 2048 genomes.
The (G, G) matrix is computed in (block x block) macro-tiles: every
block's packed (key, gid) stream is merged ONCE into a device-resident
cache (K5), then each upper-triangle macro-tile is a pair merge of two
cached streams (K10) and the rect block of their Gram (K6); intersections
are symmetric, so each tile also fills its mirror.  The reference's
ordered all-pairs incl. self, src/generators.hpp:45-58.

Both merges are merge-path kernels (csrc/sort.cu): a block's presort is
log2(BLOCK) = 7 passes over its stream, a macro-tile's pair merge one
pass over the two streams with the column block's gid shift folded into
its loads, so each costs the bytes it moves.

Not ported yet (ROADMAP.md): the bit-tight slab transport, the int16 tile
download, multi-device round-robin and the store-backed out-of-core
per-tile schedule.  The probe engine is ops/intersect.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.gram import (_guard_words, gram_pair_tiles, pack_plan,
                        presort_blocks_packed)

# Device bytes the slab and the presorted cache may take together; the
# JAX package's default for the same check (SKS_BLOCKED_CACHE_BUDGET).
CACHE_BUDGET_BYTES = 8 << 30
BLOCK = 128          # genomes per block: the JAX sketcher's choice


def blocked_all_pairs(keys: torch.Tensor, *, key_bits: int) -> np.ndarray:
    """(G, G) int32 intersections of keys (G, cap, W) int32 device
    sketches (sorted unique, all-ones padded; cap a power of two >= 128;
    key_bits low key bits live) by the block-cache schedule with blocks of
    BLOCK genomes.  Collections whose slab and cache exceed
    CACHE_BUDGET_BYTES raise NotImplementedError: they need the
    store-backed out-of-core schedule, not ported yet."""
    g, cap, w = keys.shape
    nb = max(1, -(-g // BLOCK))
    gidbits = (2 * BLOCK - 1).bit_length()
    kw = min(w, _guard_words(key_bits))
    pw = pack_plan(key_bits, gidbits)
    need = nb * BLOCK * cap * (kw + pw) * 4
    if need > CACHE_BUDGET_BYTES:
        raise NotImplementedError(
            f"{g} sketches of capacity {cap} need {need} bytes of slab and "
            f"presorted cache, over the {CACHE_BUDGET_BYTES}-byte budget: "
            "that needs the store-backed out-of-core per-tile schedule, "
            "which the PyTorch port does not have yet (ROADMAP.md)")
    return _gram_blocked_cached(keys[:, :, :kw], key_bits, gidbits, pw)


def _gram_blocked_cached(keys: torch.Tensor, key_bits: int, gidbits: int,
                         pw: int) -> np.ndarray:
    """Presort every block once into the cache, then sweep the tiles.  A
    ragged tail block is filled with all-sentinel sketches."""
    g = keys.shape[0]
    slab = keys
    if g % BLOCK:
        pad = torch.full((BLOCK - g % BLOCK,) + tuple(keys.shape[1:]), -1,
                         dtype=keys.dtype, device=keys.device)
        slab = torch.cat([keys, pad])
    cache = presort_blocks_packed(slab.contiguous(), block=BLOCK,
                                  key_bits=key_bits, gidbits=gidbits, pw=pw)
    return pair_tile_sweep(cache, g, gidbits=gidbits)


def pair_tile_sweep(cache: torch.Tensor, g: int, *, gidbits: int
                    ) -> np.ndarray:
    """Upper-triangle macro-tile sweep over the presorted cache
    (nb, pw, rows, 128): every tile (gram_pair_tiles) is written with its
    mirror into a device matrix that is downloaded once at the end (the
    JAX sweep batches tiles per dispatch and downloads each batch)."""
    nb = cache.shape[0]
    full = torch.empty((nb * BLOCK, nb * BLOCK), dtype=torch.int32,
                       device=cache.device)
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    tiles = gram_pair_tiles(cache, [i for i, _ in pairs],
                            [j for _, j in pairs], block=BLOCK,
                            gidbits=gidbits)
    for t, (bi, bj) in zip(tiles, pairs):
        rows = slice(bi * BLOCK, (bi + 1) * BLOCK)
        cols = slice(bj * BLOCK, (bj + 1) * BLOCK)
        full[rows, cols] = t
        if bj != bi:
            full[cols, rows] = t.T
    return full[:g, :g].cpu().numpy()
