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
host rank-layout engine (build_rank_layout, gram_all_pairs) and
gram_rect_ondevice are not ported (ROADMAP.md).

The bit-tight slab transport (the JAX module's :509-672) carries host
sketches to the blocked schedule with only their key_bits live bits: 4
keys a group in tight_words4(key_bits) words, packed on the host
(pack_keys_tight_np) and unpacked on the device, where sentinel rows are
rebuilt from the counts.  presort_block_tight goes from a tight block
straight to K5's packed planes in one kernel (K12, ops/cuda/tight.py);
unpack_keys_tight is the plain unpack.  Keys of up to 64 bits only.
"""
from __future__ import annotations

import torch

from . import u64ops
from .cuda.gram_tiles import gram_tile_scan
from .cuda.sort import merge_pair_streams, merge_sorted_runs
from .cuda.tight import tight_gid_planes

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


# --- the bit-tight slab transport --------------------------------------------


def tight_words4(key_bits: int) -> int:
    """Words per 4-key group of bit-tight packed keys."""
    return (4 * key_bits + 31) // 32


def pack_keys_tight_np(keys, counts, key_bits: int, use_native: bool = True,
                       out=None):
    """Host side: keys (G, n, >= 1) uint32 sorted-unique sketches (anything
    at or past counts[g] ignored) -> (G, cap/4, tight_words4(key_bits))
    uint32, cap = n unless `out` (zeroed) gives it; key_bits <= 64.
    Through the native packer when it is available, else numpy (the JAX
    module's formulation).  A caller packs one sketch into a row of its
    slab with keys = its own (1, count, W) keys and out = the row."""
    import numpy as np

    from ..utils import native as _native
    keys = np.asarray(keys)
    g, n = keys.shape[:2]
    cap = n if out is None else 4 * out.shape[1]
    if cap % 4 or not 0 < key_bits <= 64:
        raise ValueError(f"tight packing needs cap % 4 == 0 and key_bits "
                         f"<= 64, got cap {cap}, key_bits {key_bits}")
    if use_native and _native.available():
        return _native.pack_keys_tight(keys, counts, key_bits, out=out)
    kb, w4 = key_bits, tight_words4(key_bits)
    if n != cap:
        pad = np.zeros((g, cap, keys.shape[2]), np.uint32)
        pad[:, :min(n, cap)] = keys[:, :cap]
        keys = pad
    lo = keys[:, :, 0].astype(np.uint64)
    hi = (keys[:, :, 1].astype(np.uint64) if keys.shape[2] > 1
          else np.zeros_like(lo))
    v = lo | (hi << np.uint64(32))
    if kb < 64:
        v &= (np.uint64(1) << np.uint64(kb)) - np.uint64(1)
    idx = np.arange(cap, dtype=np.int64)[None, :]
    v = np.where(idx < np.asarray(counts).astype(np.int64)[:, None], v, 0)
    v = v.reshape(g, cap // 4, 4)
    res = np.zeros((g, cap // 4, w4), np.uint32)
    m32 = np.uint64(0xFFFFFFFF)
    for j in range(4):
        w, s = divmod(j * kb, 32)
        res[:, :, w] |= ((v[:, :, j] << np.uint64(s)) & m32).astype(np.uint32)
        rem = kb - (32 - s)          # bits spilling past word w
        if rem > 0:
            res[:, :, w + 1] |= ((v[:, :, j] >> np.uint64(32 - s))
                                 & m32).astype(np.uint32)
        if rem > 32:
            res[:, :, w + 2] |= (v[:, :, j] >> np.uint64(64 - s)) \
                .astype(np.uint32)
    if out is None:
        return res
    out[...] = res
    return out


def unpack_keys_tight(tight: torch.Tensor, counts: torch.Tensor,
                      key_bits: int, kw_out: int) -> torch.Tensor:
    """Plain inverse of pack_keys_tight_np on any device: tight (G, cap/4,
    w4) int32 holding u32 bits, counts (G,) -> (G, cap, kw_out) int32 key
    words with all-ones sentinel rows at or past counts (the sketches'
    padded layout)."""
    g, cap4, w4 = tight.shape
    kb = key_bits
    t = [u64ops.as_u32(tight[:, :, w]) for w in range(w4)]
    zero = torch.zeros((g, cap4), dtype=torch.int64, device=tight.device)
    slots = []
    for j in range(4):
        words = []
        for q in range(kw_out):
            if 32 * q >= kb:                 # word past the key's live bits
                words.append(zero)
                continue
            w, s = divmod(j * kb + 32 * q, 32)
            val = t[w] >> s if w < w4 else zero
            if s and w + 1 < w4:
                val = val | ((t[w + 1] << (32 - s)) & u64ops.M32)
            live = kb - 32 * q           # live bits in this output word
            if live < 32:
                val = val & ((1 << live) - 1)
            words.append(val)
        slots.append(torch.stack(words, dim=-1))        # (G, cap4, kw_out)
    keys = u64ops.as_i32(torch.stack(slots, dim=2).reshape(g, 4 * cap4,
                                                           kw_out))
    idx = torch.arange(4 * cap4, device=tight.device)
    sent = idx[None, :] >= counts.to(tight.device)[:, None]
    return torch.where(sent[:, :, None], -1, keys)


def presort_block_tight(tight: torch.Tensor, counts: torch.Tensor, *,
                        key_bits: int, gidbits: int, pw: int
                        ) -> torch.Tensor:
    """presort_block_packed of a bit-tight block: tight (blk, cap/4,
    tight_words4(key_bits)) int32 + counts (blk,) int32 -> (pw,
    blk*cap/128, 128) sorted packed planes with LOCAL gids [0, blk).  K12
    unpacks the block straight into the packed planes (the full-width keys
    never exist), K5 merges them."""
    blk, cap4 = tight.shape[:2]
    if blk & (blk - 1):
        raise ValueError(f"block must be a power of two, got {blk}")
    _check_cap(4 * cap4)
    planes = tight_gid_planes(tight, counts, key_bits=key_bits,
                              gidbits=gidbits, pw=pw)
    return _sort_packed(planes, 4 * cap4 // LANES)


def presort_blocks_tight(tight: torch.Tensor, counts: torch.Tensor, *,
                         block: int, key_bits: int, gidbits: int, pw: int
                         ) -> torch.Tensor:
    """presort_blocks_packed fed by a bit-tight slab (nb*block, cap/4,
    tight_words4(key_bits)) + counts (nb*block,): the same (nb, pw,
    block*cap/128, 128) cache as presort_blocks_packed gives on the
    unpacked slab, built block by block."""
    g, cap4, _ = tight.shape
    if g % block:
        raise ValueError(f"{g} genomes are not whole blocks of {block}")
    nb = g // block
    cache = torch.empty((nb, pw, block * cap4 * 4 // LANES, LANES),
                        dtype=torch.int32, device=tight.device)
    for b in range(nb):
        rows = slice(b * block, (b + 1) * block)
        cache[b] = presort_block_tight(tight[rows], counts[rows],
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
