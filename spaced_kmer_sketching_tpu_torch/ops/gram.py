"""All-pairs sketch intersections on the device: the packed (key, gid) Gram.

The port of the device engine of the JAX package's ops/gram.py.  The G
sorted sketches are packed with their genome id riding in the low bits of
the key words, merged into one ascending stream (K5), and the Gram
matrix -- entry (a, b) = keys shared by genomes a and b, the diagonal the
sketch sizes -- is read off the stream (K6).  The blocked schedules'
programs presort a genome block (K5) and compute a macro-tile from two
presorted blocks (K10 then K6 in split mode).

Both merges are merge paths (csrc/sort.cu): K5 makes one pass over the
stream per merge level, log2(G) of them, and K10 one pass a macro-tile,
reading the column block's stream where it lies and shifting its gids on
the way in.  Each pass reads and writes every packed entry once, so the
merges are bound by bytes (pw * 8 bytes an entry and level).

Packed layout (as in the JAX package): packed = (key << gidbits) | gid
over pw = ceil((key_bits + gidbits + 1) / 32) u32 words, word pw-1 most
significant.  The +1 is a guard bit: every valid packed value has bit 31
of word pw-1 clear, while sentinel rows are all-ones in every word, so
validity is a sign test on the int32 container.  Key equality is packed
equality with word 0's low gidbits masked; the gid is word 0's low bits.

Keys travel as int32 tensors holding u32 bits (ops/u64ops.py); shifts are
taken on int64 copies, where `>>` of a value in [0, 2^32) is logical.  The
host rank-layout engine (build_rank_layout, gram_all_pairs), the bit-tight
slab transport and gram_rect_ondevice are not ported (ROADMAP.md).
"""
from __future__ import annotations

import torch

from . import u64ops
from .cuda.gram_tiles import gram_tile_scan
from .cuda.sort import merge_pair_streams, merge_sorted_runs

LANES = 128


def pack_plan(key_bits: int, gidbits: int) -> int:
    """Packed word count pw for key_bits-bit keys + gidbits-bit gids."""
    return (key_bits + gidbits + 1 + 31) // 32


def _guard_words(key_bits: int) -> int:
    """Input key words needed for unambiguous sentinel detection: the
    kw_in packed words, plus the guard word above them when key_bits is an
    exact word multiple (a valid key could then be all-ones in every
    packed word; its guard word is all-zero, the sentinel's all-ones).
    Capped at 4, the full key layout."""
    kw_in = (key_bits + 31) // 32
    return min(4, kw_in + (1 if key_bits % 32 == 0 else 0))


def key_words_for_window(window: int) -> int:
    """uint32 key words that can be nonzero for masked canonical keys of
    `window` nucleotides, plus the sentinel guard word (capped at 4)."""
    return min(4, 2 * window // 32 + 1)


def _pack_gid_planes(keys: torch.Tensor, gid: torch.Tensor, key_bits: int,
                     gidbits: int, pw: int) -> torch.Tensor:
    """keys (..., cap, >= kw_in) int32 little-endian key words (sorted
    unique per sketch, all-ones sentinel padding), gid (..., cap) integer
    -> (pw, ..., cap) int32 planes of (key << gidbits) | gid, sentinels
    all-ones in every word.  Sentinel detection reads EVERY provided key
    word (pass _guard_words(key_bits) of them)."""
    kw_in = (key_bits + 31) // 32
    s = gidbits
    if not 0 < s < 32 or keys.shape[-1] < kw_in:
        raise ValueError(f"need 0 < gidbits < 32 and >= {kw_in} key words, "
                         f"got gidbits={gidbits}, {keys.shape[-1]} words")
    sent = (keys == -1).all(-1)
    k = [u64ops.as_u32(keys[..., q]) for q in range(kw_in)]
    zero = torch.zeros(sent.shape, dtype=torch.int64, device=keys.device)
    planes = []
    for q in range(pw):
        hi = (k[q] << s) & u64ops.M32 if q < kw_in else zero
        if 0 < q <= kw_in:
            lo = k[q - 1] >> (32 - s)
        else:
            lo = gid.to(torch.int64) if q == 0 else zero
        planes.append(torch.where(sent, -1, u64ops.as_i32(hi | lo)))
    return torch.stack(planes)


def _sort_packed(planes: torch.Tensor, run_rows: int) -> torch.Tensor:
    """Merge packed planes (pw, R, 128) whose run_rows-row runs are each
    ascending (K5)."""
    return merge_sorted_runs(planes, run_rows)


def _check_cap(cap: int) -> None:
    if cap < LANES or cap & (cap - 1):
        raise ValueError(f"sketch capacity must be a power of two >= 128, "
                         f"got {cap}")


def gram_all_pairs_ondevice(keys: torch.Tensor, *, key_bits: int
                            ) -> torch.Tensor:
    """Exact (G, G) int32 all-pairs intersection matrix on keys' device:
    keys (G, cap, W) int32 sketches (sorted unique, all-ones padded; cap a
    power of two >= 128; W >= the key words read).  key_bits: how many
    low key bits can be nonzero (2 * window for spaced-seed keys).  The
    JAX function also takes the counts; the padding already marks the end
    of each sketch.

    G is padded to a power of two g2 with all-sentinel pseudo-sketches (K5
    merges a power-of-two count of runs), the gid field is sized from g2,
    and the Gram is taken at gp = ceil128(G)."""
    g, cap, w = keys.shape
    if key_bits > 32 * w:
        raise ValueError(f"{key_bits} key bits need more than {w} words")
    _check_cap(cap)
    gp = max(LANES, -(-g // LANES) * LANES)
    g2 = 1 << max(0, (g - 1).bit_length())
    if g2 != g:
        pad = torch.full((g2 - g, cap, w), -1, dtype=keys.dtype,
                         device=keys.device)
        keys = torch.cat([keys, pad])
    gidbits = max(1, (g2 - 1).bit_length())
    pw = pack_plan(key_bits, gidbits)
    gid = torch.arange(g2, dtype=torch.int32,
                       device=keys.device)[:, None].expand(g2, cap)
    kw_use = min(w, _guard_words(key_bits))
    planes = _pack_gid_planes(keys[:, :, :kw_use], gid, key_bits, gidbits, pw)
    merged = _sort_packed(planes.reshape(pw, g2 * cap // LANES, LANES),
                          cap // LANES)
    return gram_tile_scan(merged, gidbits, gp)[:g, :g]


# --- block-cache programs for the blocked all-pairs schedule ---------------


def presort_block_packed(keys: torch.Tensor, *, key_bits: int, gidbits: int,
                         pw: int) -> torch.Tensor:
    """keys (blk, cap, >= kw_in) int32 sorted-unique sketches (sentinel
    padded; blk a power of two) -> (pw, blk*cap/128, 128) sorted packed
    planes with LOCAL gids [0, blk)."""
    blk, cap = keys.shape[:2]
    if blk & (blk - 1):
        raise ValueError(f"block must be a power of two, got {blk}")
    _check_cap(cap)
    gid = torch.arange(blk, dtype=torch.int32,
                       device=keys.device)[:, None].expand(blk, cap)
    kw_use = min(keys.shape[2], _guard_words(key_bits))
    planes = _pack_gid_planes(keys[:, :, :kw_use], gid, key_bits, gidbits, pw)
    return _sort_packed(planes.reshape(pw, blk * cap // LANES, LANES),
                        cap // LANES)


def presort_blocks_packed(slab: torch.Tensor, *, block: int, key_bits: int,
                          gidbits: int, pw: int) -> torch.Tensor:
    """Presort EVERY block of a (nb*block, cap, kw) slab -> the
    (nb, pw, block*cap/128, 128) cache."""
    g, cap, _ = slab.shape
    if g % block:
        raise ValueError(f"{g} genomes are not whole blocks of {block}")
    nb = g // block
    cache = torch.empty((nb, pw, block * cap // LANES, LANES),
                        dtype=torch.int32, device=slab.device)
    for b in range(nb):
        cache[b] = presort_block_packed(slab[b * block:(b + 1) * block],
                                        key_bits=key_bits, gidbits=gidbits,
                                        pw=pw)
    return cache


def gram_pair_tile(row: torch.Tensor, col: torch.Tensor, *, block: int,
                   gidbits: int) -> torch.Tensor:
    """One macro-tile: the (block, block) int32 intersections of the
    genomes of presorted block `row` (pw, rows, 128) with those of block
    `col` (the same tensor for a diagonal tile).  The two streams are
    merged (K10) with col's valid gids offset by +block inside the packed
    gid field as K10 reads them (no carry: local gids are < block <=
    2^(gidbits-1)), and the rect block of the Gram is read at split =
    block (K6)."""
    if block % LANES or (1 << gidbits) < 2 * block:
        raise ValueError(f"block {block} must be a multiple of 128 with "
                         f"2^gidbits >= 2 * block (gidbits {gidbits})")
    merged = merge_pair_streams(row, col, b_gid_offset=block)
    return gram_tile_scan(merged, gidbits, 2 * block, split=block)
