"""FracMinHash sketch construction: extract -> filter -> compact -> sort ->
unique, on the device.

The counterpart of the JAX package's ops/sketch.py, for its main path: the
shared dynamic-window step `sketch_batch_packed_dyn`, the compact-upload
step `sketch_batch_compact` (streaming segments and the device pipeline),
the finish behind both, and `merge_sketches` (the streaming accumulator).  A sketch is a SORTED UNIQUE array of 128-bit keys (4 u32 words)
padded to a static capacity with all-ones rows, plus a count and the
pre-dedup kept count `raw_kept` (capacity overflow => raw_kept > capacity,
and the caller retries).

Keys travel as stacked planes (kw, G, m) of int32 holding the u32 bits; kw
= finish_words(window) low words carry every valid key.  The kernels
K1 and K7 (ops/cuda/extract.py), K2/K3 (ops/cuda/compact.py) and K4
(ops/cuda/sort.py) do the work; the glue here keeps the JAX planner's
shapes (n, nw_prog, k_slots, the compaction chain, sort_m, capacity), so
every intermediate compares with the JAX reference and raw_kept matches.

Where the JAX `_finish_dispatch` takes `_finish_runs` (Pallas K8) or the
tiled `_finish_candidates` branch (K9), this port takes the sort-everything
branch of `_finish_candidates` instead: it gives the same keys and count.
The JAX `SKS_COMPACT_EXPAND=xla` branch of `sketch_batch_compact` is not
ported: K7 takes every bounds width.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from .cuda.compact import compact_global, compact_rows
from .cuda.extract import extract_compact, extract_compact_raw, packed_body
from .cuda.sort import sort_rows

SENTINEL = -1                 # all-ones u32 in an int32 container
KEY_WORDS = 4
LANES = 128


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
    return _finish_dispatch(planes, rowcnt, k_slots, capacity, scale)


def sketch_batch_compact(packed: torch.Tensor, bounds: torch.Tensor,
                         rid0: torch.Tensor, vlen: torch.Tensor,
                         mask_words: Sequence[int], salt: int, *, n: int,
                         window: int, scale: int, variant: str,
                         capacity: int) -> SketchBatch:
    """The sketch step from compact uploads (the JAX sketch_batch_compact):
    packed (G, packed_body(n)/16) int32 raw 2-bit words, bounds (G, K)
    int32 sorted interior run starts padded with the body length, rid0
    (G,) int32 the id of the run open at position 0, vlen (G,) int32 the
    real code count.  The window is static here as in JAX: the kernel
    covers nw = n - window + 1 windows, which fixes k_slots, the output
    rows and so raw_kept."""
    if 16 * packed.shape[1] != packed_body(n):
        raise ValueError(f"packed has {packed.shape[1]} words, expected "
                         f"packed_body({n}) / 16 = {packed_body(n) // 16}")
    nw = n - window + 1
    k_slots = _k_slots_for(nw, scale, capacity)
    planes, rowcnt = extract_compact_raw(
        packed, bounds, rid0, vlen, mask_words, salt, window=window, nw=nw,
        scale=scale, variant=variant, k_slots=k_slots,
        out_words=finish_words(window))
    return _finish_dispatch(planes, rowcnt, k_slots, capacity, scale)


def _finish_dispatch(planes, rowcnt, k_slots: int, capacity: int,
                     scale: int) -> SketchBatch:
    _, g, m = planes.shape
    if (capacity >= 1024 and m % LANES == 0
            and _tree_chain(m, 128.0 / k_slots, scale, capacity, g)
            is not None):
        return _finish_tree(planes, rowcnt, k_slots, capacity, scale)
    return _finish_sort_all(planes, rowcnt, k_slots, capacity)


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


def _finish_sort_all(planes, rowcnt, k_slots: int,
                     capacity: int) -> SketchBatch:
    """Sort-everything finish (the JAX `_finish_candidates` untiled
    branch): pad the candidates to a power of two of at least 1024, sort
    (K4), cut or pad to capacity, then adjacent-unique and K3."""
    m = planes.shape[2]
    buf = _pad_to(sort_rows(_pad_to(planes, _next_pow2(max(m, 1024)))),
                  capacity)
    valid_total = rowcnt.clamp(max=k_slots).sum(1)
    overflow = (rowcnt > k_slots).any(1)
    return _unique(buf, valid_total, rowcnt.sum(1), overflow, capacity)


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
