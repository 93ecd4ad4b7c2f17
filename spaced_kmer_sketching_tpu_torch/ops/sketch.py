"""FracMinHash sketch construction: extract -> filter -> compact -> sort ->
unique, on the device.

The counterpart of the JAX package's ops/sketch.py: the shared
dynamic-window step `sketch_batch_packed_dyn`, the static-window steps
`sketch_batch_packed` (with seed-batch mode: S spaced seeds over one genome
in one launch, BASELINE config 3), `sketch_batch` and
`sketch_from_codes_multiseed`, the compact-upload step
`sketch_batch_compact` (streaming segments, the device pipeline and
multi-seed sketching), the single-genome step `sketch_core` /
`sketch_from_codes`, the finishes behind them, and `merge_sketches` (the
streaming accumulator).  A sketch is a SORTED UNIQUE array of 128-bit keys
(4 u32 words) padded to a static capacity with all-ones rows, plus a count
and the pre-dedup kept count `raw_kept` (capacity overflow => raw_kept >
capacity, and the caller retries).

Keys travel as stacked planes (kw, G, m) of int32 holding the u32 bits; kw
= finish_words(window) low words carry every valid key.  The kernels
K1, K7 and K11 (ops/cuda/extract.py), K2/K3 (ops/cuda/compact.py) and K4,
K5, K8, K9 (ops/cuda/sort.py) do the work; the glue here keeps the JAX
planner's shapes (n, nw, k_slots, the compaction chain, the finish route,
sort_m, capacity), so every intermediate compares with the JAX reference
and raw_kept matches.  The step off the TPU that JAX takes for
`sketch_batch` and `sketch_from_codes_multiseed` (a vmap of sketch_core)
gives the same keys and counts but another raw_kept on overflow; the port
takes the TPU path.  The JAX `SKS_COMPACT_EXPAND=xla` branch of
`sketch_batch_compact` is not ported: K7 takes every bounds width.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from . import u64ops
from .cuda.compact import compact_global, compact_rows
from .cuda.extract import (BLOCK, extract_compact, extract_compact_raw,
                           extract_filter, pack_codes, packed_body)
from .cuda.sort import (TILE, merge_row_runs, sort_rows, sort_runs,
                        sort_truncate)

SENTINEL = -1                 # all-ones u32 in an int32 container
KEY_WORDS = 4
LANES = 128
BLOCK_ROWS = BLOCK // LANES   # 128-window rows per JAX extract block


class SketchBatch(NamedTuple):
    """keys (G, cap, 4) int32 (u32 bits) sorted ascending with all-ones
    padding; count (G,) int32 unique keys; raw_kept (G,) int32 pre-dedup
    kept windows (for capacity-overflow detection)."""
    keys: torch.Tensor
    count: torch.Tensor
    raw_kept: torch.Tensor


def finish_words(window: int) -> int:
    """Key words that can be nonzero for valid canonical keys: spaced-seed
    masks set bits only below 2*window (utils/masks.py), so words at and
    above ceil(2*window/32) are zero for every valid key."""
    return max(1, (2 * window + 31) // 32)


def _expand_keys(planes: torch.Tensor) -> torch.Tensor:
    """(kw, G, cap) carried planes -> (G, cap, 4) keys: valid rows get zero
    high words, sentinel rows all-ones."""
    kw = planes.shape[0]
    if kw < KEY_WORDS:
        sent = (planes == SENTINEL).all(0)
        hi = torch.where(sent, SENTINEL, 0).to(torch.int32)
        planes = torch.cat([planes, hi.expand(KEY_WORDS - kw, *hi.shape)])
    return planes.permute(1, 2, 0).contiguous()


def _poisson_tail_log10(lam: float, k: int) -> float:
    """log10 P(Poisson(lam) > k), Chernoff-ish upper bound."""
    if lam <= 0:
        return -300.0
    if k <= lam:
        return 0.0
    k1 = k + 1
    return (-lam + k1 * (1 + math.log(lam / k1))) / math.log(10)


def slots_for_scale(scale: int) -> int:
    """Per-row (128-window) candidate slots: the smallest power of two whose
    per-row overflow probability is below ~1e-7 (overflow costs only a
    capacity retry, never correctness)."""
    lam = 128.0 / scale
    k = 4
    while k < 128 and _poisson_tail_log10(lam, k) > -6:
        k *= 2
    return k


def _k_slots_for(nw: int, scale: int, capacity: int) -> int:
    """k_slots also grows with capacity so the overflow->retry loop
    terminates even on adversarial inputs (at 128 no row can overflow)."""
    rows = max(1, (nw + 127) // 128)
    grow = 1 << max(0, (4 * capacity // rows - 1).bit_length())
    return min(128, max(slots_for_scale(scale), grow))


def _tree_chain(m: int, windows_per_slot: float, scale: int, capacity: int,
                batch: int):
    """Plan the compaction chain: [(rows, k_out), ...] shrinking an m-slot
    candidate array until it fits `capacity`; None when no useful chain
    exists (the sort-everything finish then runs)."""
    stages = []
    wps = windows_per_slot
    expect = max(1, int(m * wps / scale))
    auto = 1 << max(8, math.ceil(math.log2(expect * 2 + 256)))
    headroom = max(1, capacity // auto)
    while m > capacity and m % LANES == 0:
        rows = m // LANES
        lam = LANES * wps / scale
        k_out = 8
        while k_out < LANES and (
                _poisson_tail_log10(lam, k_out) + math.log10(rows * batch + 1)
                > -9):
            k_out *= 2
        k_out = min(LANES, k_out * headroom)
        if k_out >= LANES:
            break
        stages.append((rows, k_out))
        m = rows * k_out
        wps = LANES * wps / k_out
    return stages if m <= 4 * capacity else None


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pad_to(planes: torch.Tensor, n: int) -> torch.Tensor:
    m = planes.shape[2]
    if m >= n:
        return planes[:, :, :n].contiguous()
    fill = torch.full(planes.shape[:2] + (n - m,), SENTINEL,
                      dtype=planes.dtype, device=planes.device)
    return torch.cat([planes, fill], dim=2)


def sketch_batch_packed_dyn(packed: torch.Tensor, run_id: torch.Tensor,
                            mask_words: Sequence[int], salt: int,
                            window: int, *, n: int, kw: int, scale: int,
                            variant: str, capacity: int) -> SketchBatch:
    """The shared dynamic-window sketch step: packed (G, n/16) int32 2-bit
    code words and run_id (G, n) int32 -> SketchBatch.  Window, mask and
    salt are runtime values; `kw` (the bucket's key words) and `n` fix the
    planner's shapes exactly as the JAX step does: the kernel covers the
    bucket's window-count upper bound nw_prog, and windows past a run's end
    fall out of the run-id compare."""
    w_min = 16 * (kw - 1) + 1         # smallest window with finish_words=kw
    nw_prog = n - w_min + 1
    k_slots = _k_slots_for(nw_prog, scale, capacity)
    planes, rowcnt = extract_compact(
        packed, run_id, mask_words, salt, window=window, nw=nw_prog,
        scale=scale, variant=variant, k_slots=k_slots, out_words=kw)
    return _finish_dispatch(planes, rowcnt, nw_prog, k_slots, capacity,
                            scale)


def sketch_batch_packed(packed: torch.Tensor, run_id: torch.Tensor,
                        mask_words, salt, *, window: int, scale: int,
                        variant: str, capacity: int) -> SketchBatch:
    """The static-window sketch step (the JAX sketch_batch_packed): packed
    (G, P) int32 2-bit code words, run_id (G, n) int32 -> SketchBatch of G
    genomes, nw = n - window + 1.  With (S, 4) mask_words and S salts, and
    G = 1, it is seed-batch mode (the JAX `batch=S`): S seeds over the one
    genome in ONE K1 launch, and a SketchBatch with a leading S axis."""
    nw = run_id.shape[1] - window + 1
    k_slots = _k_slots_for(nw, scale, capacity)
    planes, rowcnt = extract_compact(
        packed, run_id, mask_words, salt, window=window, nw=nw, scale=scale,
        variant=variant, k_slots=k_slots, out_words=finish_words(window))
    return _finish_dispatch(planes, rowcnt, nw, k_slots, capacity, scale)


def sketch_batch(codes: torch.Tensor, run_id: torch.Tensor,
                 mask_words: Sequence[int], *, window: int, salt: int,
                 scale: int, variant: str, capacity: int) -> SketchBatch:
    """codes (G, n) integer 0..3, run_id (G, n) int32 -> SketchBatch with a
    leading G axis: the codes packed on the device, then
    sketch_batch_packed (the JAX TPU path, `_sketch_batch_pallas`)."""
    return sketch_batch_packed(pack_codes(codes), run_id, mask_words, salt,
                               window=window, scale=scale, variant=variant,
                               capacity=capacity)


def sketch_from_codes_multiseed(codes: torch.Tensor, run_id: torch.Tensor,
                                masks_words, salt_pairs, *, window: int,
                                scale: int, variant: str,
                                capacity: int) -> SketchBatch:
    """Fused multi-seed sketching (BASELINE config 3): codes (n,) integer
    0..3 and run_id (n,) int32 of ONE genome, masks_words (S, 4) u32 and
    salt_pairs (S, 2) u32 [hi, lo] rows (the JAX arguments) -> SketchBatch
    with a leading S axis.  The genome is packed once on the device and
    all S seeds run in one K1 launch (seed-batch mode)."""
    salts = [u64ops.salt_from_pair(p) for p in salt_pairs]
    return sketch_batch_packed(pack_codes(codes[None]), run_id[None],
                               masks_words, salts, window=window, scale=scale,
                               variant=variant, capacity=capacity)


def sketch_batch_compact(packed: torch.Tensor, bounds: torch.Tensor,
                         rid0: torch.Tensor, vlen: torch.Tensor,
                         mask_words, salt, *, n: int, window: int,
                         scale: int, variant: str,
                         capacity: int) -> SketchBatch:
    """The sketch step from compact uploads (the JAX sketch_batch_compact):
    packed (G, packed_body(n)/16) int32 raw 2-bit words, bounds (G, K)
    int32 sorted interior run starts padded with the body length, rid0
    (G,) int32 the id of the run open at position 0, vlen (G,) int32 the
    real code count.  The window is static here as in JAX: the kernel
    covers nw = n - window + 1 windows, which fixes k_slots, the output
    rows and so raw_kept.  (S, 4) mask_words and S salts over G = 1 run
    K7's seed-batch mode, as sketch_batch_packed does K1's."""
    if 16 * packed.shape[1] != packed_body(n):
        raise ValueError(f"packed has {packed.shape[1]} words, expected "
                         f"packed_body({n}) / 16 = {packed_body(n) // 16}")
    nw = n - window + 1
    k_slots = _k_slots_for(nw, scale, capacity)
    planes, rowcnt = extract_compact_raw(
        packed, bounds, rid0, vlen, mask_words, salt, window=window, nw=nw,
        scale=scale, variant=variant, k_slots=k_slots,
        out_words=finish_words(window))
    return _finish_dispatch(planes, rowcnt, nw, k_slots, capacity, scale)


def finish_route(m: int, nw: int, k_slots: int, capacity: int, scale: int,
                 g: int) -> str:
    """Which finish the JAX `_finish_dispatch` takes for G candidate rows
    of m slots from an nw-window extract: 'tree' (a compaction chain,
    K2/K3/K4), 'runs' (`_finish_runs`: K8 per-block sort, truncate to the
    block's capacity share, K5 merge), 'tiled' (`_finish_candidates` with
    K9) or 'sort' (`_finish_candidates` sorting everything, K4)."""
    if (capacity >= 1024 and m % LANES == 0
            and _tree_chain(m, 128.0 / k_slots, scale, capacity, g)
            is not None):
        return "tree"
    nblocks = (nw + BLOCK - 1) // BLOCK
    npb = _next_pow2(nblocks)                   # runs padded to pow2
    run_elems = BLOCK_ROWS * k_slots            # candidates per block
    out_elems = capacity // npb
    if (nblocks >= 2 and 128 <= out_elems <= run_elems
            and capacity % npb == 0 and out_elems % 128 == 0):
        return "runs"
    t = _next_pow2(max(1, m // TILE))
    if t >= 2 and capacity // t >= 128 and capacity <= t * TILE:
        return "tiled"
    return "sort"


def _finish_dispatch(planes, rowcnt, nw: int, k_slots: int, capacity: int,
                     scale: int) -> SketchBatch:
    _, g, m = planes.shape
    route = finish_route(m, nw, k_slots, capacity, scale, g)
    if route == "tree":
        return _finish_tree(planes, rowcnt, k_slots, capacity, scale)
    if route == "runs":
        return _finish_runs(planes, rowcnt, k_slots, capacity)
    return _finish_candidates(planes, rowcnt, k_slots, capacity,
                              tiled=route == "tiled")


def _finish_tree(planes, rowcnt, k_slots: int, capacity: int,
                 scale: int) -> SketchBatch:
    """Tree-compaction finish (JAX `_finish_tree`): fold the sentinel-sparse
    candidates into 128-slot rows and compact each row (K2) stage by stage,
    close the holes (K3), sort a front window sized to the expected count
    (K4), then adjacent-unique and a last K3.  A dropped key is detected
    exactly by valid-count conservation and reported through raw_kept."""
    kw, g, m = planes.shape
    stages = _tree_chain(m, 128.0 / k_slots, scale, capacity, g)
    rc_last = None
    for si, (srows, k_out) in enumerate(stages):
        last = si == len(stages) - 1
        planes, counts = compact_rows(planes.reshape(kw, g, srows, LANES),
                                      k_out, with_counts=last)
        planes = planes.reshape(kw, g, srows * k_out)
        if last:
            rc_last = counts
    mf = planes.shape[2]
    if rc_last is not None:
        kept_after = rc_last.sum(1)
    else:
        kept_after = (planes != SENTINEL).any(0).sum(1)

    mp = _next_pow2(max(mf, capacity))          # sort size (pow2)
    planes = _pad_to(planes, mp)
    expect2 = max(1, int(m * (128.0 / k_slots) / scale))
    want = expect2 + 6 * int(math.sqrt(expect2)) + 256
    sort_m = min(1 << max(10, (want - 1).bit_length()), mp)
    if sort_m < mp:
        planes = compact_global(planes)[:, :, :sort_m].contiguous()
    buf = _pad_to(sort_rows(planes), capacity)

    rcl = rowcnt.clamp(max=k_slots)
    valid_total = rcl.sum(1)
    overflow = ((rowcnt > k_slots).any(1) | (kept_after != valid_total)
                | (kept_after > sort_m))
    return _unique(buf, valid_total, rowcnt.sum(1), overflow, capacity)


def _finish_runs(planes, rowcnt, k_slots: int, capacity: int
                 ) -> SketchBatch:
    """Finish for per-block candidate runs (JAX `_finish_runs`): sort each
    block's candidates (K8, odd blocks descending), keep each block's
    capacity share (the head of an ascending run, the tail of a descending
    one, read back ascending), pad to a power-of-two run count and merge
    each genome's runs (K5), then adjacent-unique and K3.  A block holding
    more valid keys than its share is an overflow, reported through
    raw_kept."""
    kw, g, m = planes.shape
    run_elems = BLOCK_ROWS * k_slots
    nblocks = m // run_elems
    out_elems = capacity // _next_pow2(nblocks)
    runs = sort_runs(planes, run_elems).reshape(kw, g, nblocks, run_elems)
    odd = (torch.arange(nblocks, device=planes.device) % 2 == 1)[:, None]
    trunc = torch.where(odd, runs[..., run_elems - out_elems:].flip(-1),
                        runs[..., :out_elems])
    buf = merge_row_runs(
        _pad_to(trunc.reshape(kw, g, nblocks * out_elems), capacity),
        out_elems)

    rcl = rowcnt.clamp(max=k_slots)
    nb = rowcnt.shape[1] // BLOCK_ROWS
    block_valid = rcl[:, :nb * BLOCK_ROWS].reshape(g, nb, BLOCK_ROWS).sum(-1)
    overflow = ((rowcnt > k_slots).any(1)
                | (block_valid > out_elems).any(1))
    return _unique(buf, rcl.sum(1), rowcnt.sum(1), overflow, capacity)


def _finish_candidates(planes, rowcnt, k_slots: int, capacity: int, *,
                       tiled: bool) -> SketchBatch:
    """Finish by sorting the candidates (JAX `_finish_candidates`).  Tiled
    (the candidates padded to t >= 2 tiles of 32,768): each tile keeps its
    capacity / t smallest entries (K9), and a tile holding more valid keys
    than that share is an overflow.  Otherwise sort everything (K4, padded
    to a power of two of at least 1024) and cut or pad to capacity.  Then
    adjacent-unique and K3."""
    kw, g, m = planes.shape
    rcl = rowcnt.clamp(max=k_slots)
    overflow = (rowcnt > k_slots).any(1)
    if tiled:
        t = _next_pow2(max(1, m // TILE))
        rows_per_tile = TILE // k_slots
        rcl_p = torch.zeros((g, t * rows_per_tile), dtype=rcl.dtype,
                            device=rcl.device)
        rcl_p[:, :rcl.shape[1]] = rcl
        tile_valid = rcl_p.reshape(g, t, rows_per_tile).sum(-1)
        overflow = overflow | (tile_valid > capacity // t).any(1)
        buf = sort_truncate(_pad_to(planes, t * TILE), capacity)
    else:
        buf = _pad_to(sort_rows(_pad_to(planes, _next_pow2(max(m, 1024)))),
                      capacity)
    return _unique(buf, rcl.sum(1), rowcnt.sum(1), overflow, capacity)


def _unique(buf, valid_total, total, overflow, capacity: int) -> SketchBatch:
    """Adjacent-unique over sorted (kw, G, capacity) planes, then close the
    duplicate holes (K3, order-preserving: the survivors stay sorted)."""
    raw_kept = torch.where(overflow, total.clamp(min=capacity + 1), total)
    idx = torch.arange(capacity, device=buf.device)
    neq_prev = torch.ones(buf.shape[1:], dtype=torch.bool, device=buf.device)
    neq_prev[:, 1:] = (buf[:, :, 1:] != buf[:, :, :-1]).any(0)
    uniq = (idx < valid_total.clamp(max=capacity)[:, None]) & neq_prev
    count = uniq.sum(1).to(torch.int32)
    bufm = torch.where(uniq, buf, SENTINEL)
    keys = _expand_keys(compact_global(bufm))
    return SketchBatch(keys=keys, count=count,
                       raw_kept=raw_kept.to(torch.int32))


def merge_sketches(keys: torch.Tensor, counts: torch.Tensor, capacity: int,
                   kw: int = KEY_WORDS) -> SketchBatch:
    """Merge S sorted-unique sketches into one (the JAX merge_sketches):
    keys (S, cap, 4) int32 (u32 bits), counts (S,) int32 -> a SketchBatch
    of ONE sketch, keys (capacity, 4), count and raw_kept (the summed
    counts) as 0-d tensors.  Only the kw low key words are carried (pass
    finish_words(window) for spaced-seed keys, whose higher words are
    zero): sort the S*cap rows (K4, padded with sentinels to a power of two
    of at least 1024), cut or pad to capacity, adjacent-unique, close the
    holes (K3)."""
    s, cap = keys.shape[:2]
    valid = (torch.arange(cap, device=keys.device)[None, :]
             < counts[:, None]).reshape(1, s * cap)
    planes = keys[..., :kw].reshape(1, s * cap, kw).permute(2, 0, 1)
    planes = torch.where(valid, planes, SENTINEL)
    total = counts.sum().reshape(1).to(torch.int32)
    buf = _pad_to(sort_rows(_pad_to(planes, _next_pow2(max(s * cap, 1024)))),
                  capacity)
    overflow = torch.zeros(1, dtype=torch.bool, device=keys.device)
    out = _unique(buf, total, total, overflow, capacity)
    return SketchBatch(keys=out.keys[0], count=out.count[0],
                       raw_kept=out.raw_kept[0])


def sketch_core(codes: torch.Tensor, run_id: torch.Tensor,
                mask_words: Sequence[int], *, window: int, salt: int,
                scale: int, variant: str, capacity: int) -> SketchBatch:
    """The single-genome sketch step (the JAX sketch_core with a static
    salt): codes (n,) integer 0..3 and run_id (n,) int32 -> SketchBatch of
    ONE sketch, keys (capacity, 4), count and raw_kept 0-d.  Every window's
    key and keep flag (K11), then _finish_sketch."""
    canon, keep = extract_filter(codes[None], run_id[None], mask_words, salt,
                                 window=window, scale=scale, variant=variant)
    return _finish_sketch(canon[:, 0], keep[0], capacity)


# the JAX package's name for its jitted single-genome step
sketch_from_codes = sketch_core


def _finish_sketch(canon, keep, capacity: int) -> SketchBatch:
    """canon (4, nw) int32, keep (nw,) bool -> SketchBatch: the kept
    windows compacted chunk by chunk into the capacity buffer, sorted (K4),
    adjacent-unique and K3 (the JAX `_finish_sketch`)."""
    src, slot_valid, raw_kept = _compact_chunked(keep, capacity)
    words = torch.where(slot_valid, canon[:, src], SENTINEL)[:, None]
    buf = _pad_to(sort_rows(_pad_to(words, _next_pow2(max(capacity, 1024)))),
                  capacity)
    no = torch.zeros(1, dtype=torch.bool, device=keep.device)
    out = _unique(buf, raw_kept[None], raw_kept[None], no, capacity)
    return SketchBatch(keys=out.keys[0], count=out.count[0],
                       raw_kept=out.raw_kept[0])


_CHUNK_WINDOWS = 32768


def _compact_chunked(keep: torch.Tensor, capacity: int):
    """Indices of kept windows, compacted chunk-locally (the JAX
    `_compact_chunked`): the window axis splits into a power of two of
    chunks, and each chunk's first capacity / chunks kept positions are
    taken by a top-k.  Returns (src (capacity,) indices into keep,
    slot_valid (capacity,) bool, raw_kept int32 0-d), raw_kept > capacity
    when the whole genome or one chunk overflows."""
    nw = keep.shape[0]
    dev = keep.device
    ch = max(1, min(nw // _CHUNK_WINDOWS,
                    capacity // 256 if capacity >= 256 else 1))
    ch = 1 << (ch.bit_length() - 1)
    k = capacity // ch
    csz = (nw + ch - 1) // ch
    grid = torch.zeros(ch * csz, dtype=torch.bool, device=dev)
    grid[:nw] = keep
    grid = grid.reshape(ch, csz)
    none = 0x7FFFFFFF
    rank = torch.where(grid, torch.arange(csz, device=dev), none)
    kk = min(k, csz)
    # ties fall only among unkept positions, which become sentinels
    neg, idx = torch.topk(-rank, kk, dim=1, sorted=True)
    src = (idx + torch.arange(ch, device=dev)[:, None] * csz).reshape(-1)
    slot_valid = (neg != -none).reshape(-1)
    if ch * kk < capacity:
        fill = capacity - ch * kk
        src = torch.cat([src, src.new_zeros(fill)])
        slot_valid = torch.cat([slot_valid, slot_valid.new_zeros(fill)])
    counts = grid.sum(1)
    total = counts.sum()
    raw_kept = torch.where((counts > kk).any(), total.clamp(min=capacity + 1),
                           total)
    return src.clamp(max=nw - 1), slot_valid, raw_kept.to(torch.int32)
