"""K4 sort, K8 run sort, K9 truncating sort, K5 and K10 merges of
multi-word keys (csrc/sort.cu).

K4 sorts each genome row of stacked planes (kw, G, N) int32 holding u32
words, word kw-1 most significant, N a power of two >= 1024; all-ones
sentinels sort last.  The JAX entry is bitonic_sort_128 on (N, W) keys,
batched by the finish's vmap.  K4 sorts tiles of 16,384 keys (kw <= 2) or
8,192 (kw 3-4), a quarter of that when a few rows would leave most SMs
idle, in one launch, 16 or 8 keys a thread in registers merged by merge
path in shared memory, and merges longer rows with K5's levels, one
launch a level, through a scratch tensor allocated here.

K8 (sort_runs_128) and K9 (sort_truncate_128) serve the finish fallbacks
of ops/sketch.py, batched over the rows as K4 is, on the same machinery
with 8 keys a thread.  K8 sorts every run of a row ascending in register
tiles of 2,048 or 4,096 entries whose levels stop at the run, and stores
odd runs reversed: one launch up to runs of 4,096, then K5's levels, the
last storing odd runs reversed (4 launches at runs of 32,768).  K9 keeps
each 32,768-key tile's cut = capacity / t smallest entries without
sorting what the cut drops: tiles that sort only their valid keys, by
levels that keep only a pair's first cut outputs, the tile's pieces
merged to its cut, then the t cuts of a row merged, 3 launches up to a
capacity of 8,192.  The library sizes both scratch tensors
(sks_sort_runs_scratch, sks_sort_truncate_scratch).

K5 (merge_sorted_runs) and K10 (merge_pair_streams) merge ascending packed
(key, gid) streams of pw <= 5 planes, laid out as the JAX package's lists
of (rows, 128) planes stacked into one (pw, rows, 128) int32 tensor; every
plane is part of the key.  merge_row_runs is K5 on each row of (kw, G, N)
planes (the merge rounds of the finish fallback _finish_runs).  Both are
merge-path kernels: each CTA finds its slice of the two inputs by a search
along its output diagonals and merges 2,048 outputs through shared memory,
so K10 is one launch a call and K5 one launch per merge level (log2 of the
run count; the levels below 2,048 entries share one launch).  A level
reads and writes every entry once, so bytes bound them; K5's levels
alternate between the output and a scratch tensor allocated here.
"""
from __future__ import annotations

import torch

from .. import u64ops
from . import build

LANES = 128
K4 = build.KERNELS["K4"]
K5 = build.KERNELS["K5"]
K8 = build.KERNELS["K8"]
K9 = build.KERNELS["K9"]
K10 = build.KERNELS["K10"]
TILE = 32768                 # K9's tile (the JAX sort.TILE_ELEMS)
MIN_SORT_TILE = 2048         # K4's smallest register tile (kw 3-4)


def sort_rows(planes: torch.Tensor) -> torch.Tensor:
    """planes (kw, G, N) int32 -> a sorted copy.  CPU tensors take the plain
    version; CUDA tensors launch K4."""
    if planes.dim() != 3 or not 1 <= planes.shape[0] <= 4:
        raise ValueError(f"sort_rows takes (kw<=4, G, N) planes, got "
                         f"{tuple(planes.shape)}")
    n = planes.shape[2]
    if n < 1024 or n & (n - 1):
        raise ValueError(f"N must be a power of two >= 1024, got {n}")
    if planes.device.type == "cpu":
        return sort_rows_plain(planes)
    dev = planes.device
    build.require(planes, "planes", torch.int32, 3, dev)
    kw, g, _ = planes.shape
    out = torch.empty_like(planes)
    scratch = torch.empty_like(planes) if n > MIN_SORT_TILE else None
    build.launch("sks_sort_rows", dev, planes.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), kw, g, n)
    K4.launches += 1
    return out


def sort_rows_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (any device): LSD radix over words —
    one stable torch.sort per word, lowest word first, on int64-held u32
    values, composing the permutation."""
    kw = planes.shape[0]
    perm = None
    for q in range(kw):
        key = u64ops.as_u32(planes[q])
        if perm is not None:
            key = key.gather(-1, perm)
        order = torch.sort(key, dim=-1, stable=True).indices
        perm = order if perm is None else perm.gather(-1, order)
    return torch.stack([planes[q].gather(-1, perm) for q in range(kw)])


def _check_stream(planes: torch.Tensor, name: str) -> None:
    if planes.dim() != 3 or planes.shape[2] != LANES or \
            not 1 <= planes.shape[0] <= 5:
        raise ValueError(f"{name} takes (pw<=5, rows, 128) planes, got "
                         f"{tuple(planes.shape)}")


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def merge_sorted_runs(planes: torch.Tensor, run_rows: int) -> torch.Tensor:
    """planes (pw, R, 128) int32 whose consecutive run_rows-row runs are
    each ascending -> the merged ascending stream, same shape.  The run
    count and the run length must be powers of two.  CPU tensors take the
    plain version; CUDA tensors launch K5."""
    _check_stream(planes, "merge_sorted_runs")
    r = planes.shape[1]
    if r % run_rows or not _pow2(r // run_rows) or not _pow2(run_rows):
        raise ValueError(f"{r} rows do not hold a power-of-two count of "
                         f"power-of-two runs of {run_rows} rows")
    if r == run_rows:
        return planes
    if planes.device.type == "cpu":
        return merge_sorted_runs_plain(planes, run_rows)
    return _merge_runs(planes, r * LANES, run_rows * LANES, r * LANES)


def merge_sorted_runs_plain(planes: torch.Tensor, run_rows: int
                            ) -> torch.Tensor:
    """Plain PyTorch version of K5 (any device): the whole stream through
    sort_rows_plain's stable LSD sorts.  Every valid packed value is a
    unique (key, gid), so the merge has exactly one correct output."""
    pw = planes.shape[0]
    return sort_rows_plain(planes.reshape(pw, 1, -1)).reshape(planes.shape)


def merge_pair_streams(pa: torch.Tensor, pb: torch.Tensor, *,
                       b_gid_offset: int = 0) -> torch.Tensor:
    """Two ascending streams (pw, rows, 128) int32, rows a power of two ->
    their merge (pw, 2 * rows, 128), stream B read with b_gid_offset added
    to plane 0 of every valid entry (plane pw-1 non-negative; sentinels
    stay all-ones).  The offset must keep B ascending: the blocked
    schedule's column gids, shifted into a free gid bit.  CPU tensors take
    the plain version; CUDA tensors launch K10, one launch."""
    _check_stream(pa, "merge_pair_streams")
    if pb.shape != pa.shape or not _pow2(pa.shape[1]):
        raise ValueError(f"merge_pair_streams takes two equal streams of a "
                         f"power-of-two row count, got {tuple(pa.shape)} "
                         f"and {tuple(pb.shape)}")
    if not 0 <= b_gid_offset < 2 ** 31:
        raise ValueError(f"b_gid_offset must lie in [0, 2^31), got "
                         f"{b_gid_offset}")
    if pa.device.type == "cpu" and pb.device.type == "cpu":
        return merge_pair_streams_plain(pa, pb, b_gid_offset=b_gid_offset)
    dev = pa.device
    build.require(pa, "pa", torch.int32, 3, dev)
    build.require(pb, "pb", torch.int32, 3, dev)
    pw, rows, _ = pa.shape
    out = torch.empty((pw, 2 * rows, LANES), dtype=torch.int32, device=dev)
    build.launch("sks_merge_pair", dev, pa.data_ptr(), pb.data_ptr(),
                 out.data_ptr(), pw, rows * LANES, b_gid_offset)
    K10.launches += 1
    return out


def merge_pair_streams_plain(pa: torch.Tensor, pb: torch.Tensor, *,
                             b_gid_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K10 (any device): B's valid entries
    shifted, then both streams through sort_rows_plain's stable LSD
    sorts."""
    if b_gid_offset:
        shift = (pb[-1] >= 0).to(torch.int32) * b_gid_offset
        pb = torch.cat([(pb[0] + shift)[None], pb[1:]])
    both = torch.cat([pa, pb], dim=1)
    return merge_sorted_runs_plain(both, pa.shape[1])


def merge_row_runs(planes: torch.Tensor, run: int) -> torch.Tensor:
    """planes (kw<=4, G, N) int32 whose runs of `run` entries are each
    ascending -> each row merged into one ascending run.  N and run powers
    of two.  CPU tensors take the plain version; CUDA tensors launch K5."""
    _check_rows(planes, "merge_row_runs")
    kw, g, n = planes.shape
    if not _pow2(n) or not _pow2(run) or run > n:
        raise ValueError(f"rows of {n} do not hold power-of-two runs of "
                         f"{run}")
    if run == n:
        return planes
    if planes.device.type == "cpu":
        return sort_rows_plain(planes)
    return _merge_runs(planes, g * n, run, n)


def _merge_runs(planes: torch.Tensor, n: int, run: int, seg: int
                ) -> torch.Tensor:
    """Launch K5 on the n entries of each plane: runs of `run` entries,
    merged within each segment of seg entries."""
    dev = planes.device
    build.require(planes, "planes", torch.int32, 3, dev)
    out = torch.empty_like(planes)
    scratch = torch.empty_like(planes)
    build.launch("sks_merge_runs", dev, planes.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), planes.shape[0], n, run, seg)
    K5.launches += 1
    return out


def _check_rows(planes: torch.Tensor, name: str) -> None:
    if planes.dim() != 3 or not 1 <= planes.shape[0] <= 4:
        raise ValueError(f"{name} takes (kw<=4, G, m) planes, got "
                         f"{tuple(planes.shape)}")


def sort_runs(planes: torch.Tensor, run: int) -> torch.Tensor:
    """planes (kw<=4, G, m) int32 -> a copy with each row's runs of `run`
    entries (a power of two >= 128 dividing m) sorted independently: run i
    of a row ascending if i is even, descending if odd (the JAX
    sort_runs_128 on each row).  CPU tensors take the plain version; CUDA
    tensors launch K8."""
    _check_rows(planes, "sort_runs")
    kw, g, m = planes.shape
    if run < LANES or not _pow2(run) or m % run:
        raise ValueError(f"runs of {run} entries do not tile rows of {m}")
    if planes.device.type == "cpu":
        return sort_runs_plain(planes, run)
    dev = planes.device
    build.require(planes, "planes", torch.int32, 3, dev)
    out = torch.empty_like(planes)
    words = build.lib().sks_sort_runs_scratch(kw, g, m, run)
    scratch = torch.empty(words, dtype=torch.int32, device=dev) if words \
        else None
    build.launch("sks_sort_runs", dev, planes.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), kw, g, m,
                 run)
    K8.launches += 1
    return out


def sort_runs_plain(planes: torch.Tensor, run: int) -> torch.Tensor:
    """Plain PyTorch version of K8 (any device): sort_rows_plain on every
    run, odd runs flipped."""
    kw, g, m = planes.shape
    x = sort_rows_plain(planes.reshape(kw, g * (m // run), run))
    x = x.reshape(kw, g, m // run, run)
    odd = (torch.arange(m // run, device=planes.device) % 2 == 1)[:, None]
    return torch.where(odd, x.flip(-1), x).reshape(kw, g, m)


def _truncate_shape(m: int, capacity: int) -> int:
    """The tile count t of K9's contract, checked."""
    t = m // TILE
    if m % TILE or t < 2 or not _pow2(t) or capacity % t or \
            not LANES <= capacity // t <= TILE or not _pow2(capacity // t):
        raise ValueError(f"sort_truncate takes m = t * {TILE} with t >= 2 a "
                         f"power of two and a power-of-two share capacity / "
                         f"t in [{LANES}, {TILE}], got m = {m}, capacity = "
                         f"{capacity}")
    return t


def sort_truncate(planes: torch.Tensor, capacity: int) -> torch.Tensor:
    """planes (kw<=4, G, m) int32, m = t * 32,768 -> (kw, G, capacity): per
    row, each tile's capacity / t smallest entries, merged ascending (the
    JAX sort_truncate_128 on each row).  The full sort's first capacity
    entries whenever no tile holds more than its share of valid keys.  CPU
    tensors take the plain version; CUDA tensors launch K9."""
    _check_rows(planes, "sort_truncate")
    kw, g, m = planes.shape
    _truncate_shape(m, capacity)
    if planes.device.type == "cpu":
        return sort_truncate_plain(planes, capacity)
    dev = planes.device
    build.require(planes, "planes", torch.int32, 3, dev)
    scratch = torch.empty(
        build.lib().sks_sort_truncate_scratch(kw, g, m, capacity),
        dtype=torch.int32, device=dev)
    out = torch.empty((kw, g, capacity), dtype=torch.int32, device=dev)
    build.launch("sks_sort_truncate", dev, planes.data_ptr(),
                 scratch.data_ptr(), out.data_ptr(), kw, g, m, capacity)
    K9.launches += 1
    return out


def sort_truncate_plain(planes: torch.Tensor, capacity: int) -> torch.Tensor:
    """Plain PyTorch version of K9 (any device): sort_rows_plain on every
    tile, each cut to its share, then on each row."""
    kw, g, m = planes.shape
    t = _truncate_shape(m, capacity)
    tiles = sort_rows_plain(planes.reshape(kw, g * t, TILE))
    return sort_rows_plain(tiles[..., :capacity // t].reshape(kw, g,
                                                              capacity))
