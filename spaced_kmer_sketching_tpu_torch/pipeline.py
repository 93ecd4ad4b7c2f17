"""Device-resident end-to-end pipeline: genomes -> sketches born on the
device -> per-block presorted (key, gid) caches -> macro-tiles -> (G, G)
intersections.

The port of the JAX package's pipeline.py for one device.  The two-step
path (`FracMinHashSketcher.sketch_files`, then `all_pairs_intersections`)
downloads every sketch and stacks and uploads them again; here the sketch
step's device keys feed `ops.gram.presort_block_packed` directly.  What
crosses the host boundary is the compact 2-bit genome uploads (ingest),
the per-genome counts and the (G, G) matrix.  The reference's one-flow
experiment (sketch all files -> all-pairs intersections -> ANI,
src/kmer-sketching.cpp:151-212) at collection scale (BASELINE config 4).

Flow per 128-genome block:

    ingest (parse, native C++; the next batch on a worker thread)  [host]
    -> 2-bit pack + run starts, uploaded (~0.25 B/nt)              [host]
    -> K7 extract + FracMinHash, finish (K2, K3, K4)               [device]
    -> live key words of the block's sketches, trimmed to its
       largest count                                               [device]
    -> presort_block_packed (K5)                                   [device]
    -> mesh_tile_sweep macro-tiles (K10, K6)                       [device]

Each block is presorted as soon as it leaves a lookahead window of
LOOKAHEAD blocks, so raw sketch keys wait in device memory for at most a
few blocks.

A genome whose sketch overflows the capacity (its raw kept count, read
with the block's counts, exceeds it) is sketched again alone, with the
others of its block that overflowed, at the power of two above that
count, doubling until none overflows, and spliced into its block before
the presort; the rest of the run keeps its capacity, unless the genome
holds more kept windows than the capacity (raw_kept > capacity + 1, not
just a row's chance overflow): the dispatches after it then take the
larger one.  No pass is thrown away.

Each phase is a span (observability.span; a range on the profiler's
timeline while one records) whose seconds `phases` books: pipeline.job
(the call), pipeline.attempt (the sketch pass, first dispatch to the
assembled cache), pipeline.ingest_wait and pipeline.ingest (ingest_s,
ingest_work_s), pipeline.dispatch and pipeline.block_read (sketch_s),
pipeline.redo (redo_s: a block's re-sketch, inside pipeline.attempt),
pipeline.presort and pipeline.assemble (presort_s), allpairs.sweep
(allpairs_s).  The three taken once a dispatch (ingest_wait, ingest,
dispatch) are timed but open no range: a gap under them is named by the
aten op the host was in, inside pipeline.attempt.  restart_s (and the
pipeline's `restarts`) read 0: they booked the whole-run restart this
re-sketch replaced.  The counter pipeline_host_syncs counts the host's
blocking reads: a block's counts, a re-sketch's counts, the assembled
cache's synchronize (on a GPU), a sampled genome's keys, the matrix, and
(on a GPU) K6's count of the runs it multiplied, which gram_kept_runs
books; pipeline_sketch_redos counts the re-sketch dispatches.

Given a mesh of one process (JAX pipeline.py:418-725; `MeshDevicePipeline`
is the JAX name for it) the same flow runs over its slots: each dispatch
carries one block a slot, sketched (K7, the finish) and presorted (K5) on
the slot's device; the blocks are padded to the widest, gathered into one
cache a distinct device, and the macro-tiles (K10, K6) split over the
slots (allpairs.mesh_tile_sweep).

Not ported (ROADMAP.md): the JAX `_tile_binner` knob, `pair_batch` (the
port's tile sweep has no batches) and the `block` option (every caller
uses 128).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .ingest.fasta import PackedSeqs, read_fasta
from .models.fracminhash import FracMinHashSketcher, Sketch
from .observability import count, get_logger, span
from .ops.cuda import gram_tiles
from .ops.cuda.extract import pack2bit, packed_body
from .ops.gram import _guard_words, pack_plan, presort_block_packed
from .parallel.allpairs import BLOCK, GIDBITS, mesh_tile_sweep
from .parallel.distributed import world_size
from .parallel.mesh import Mesh, make_mesh
from .parallel.sketch import sharded_sketch_compact_fn

log = get_logger(__name__)

LOOKAHEAD = 2        # blocks whose sketches may wait before their presort


@dataclasses.dataclass
class PipelineResult:
    """(G, G) intersection matrix + everything needed for ANI/verification."""
    inter: np.ndarray            # (G, G) int32 |A_i ∩ A_j|
    counts: np.ndarray           # (G,) int32 sketch sizes (ANI denominators)
    phases: Dict[str, float]     # seconds per phase (wall; phases overlap)
                                 # (redo_s: the re-sketches; restart_s 0)
    bytes_h2d: int               # host->device payload bytes (ingest)
    bytes_d2h: int               # device->host payload bytes (counts, matrix)
    sample_keys: Dict[int, np.ndarray]   # gid -> (count, 2) u64 sketch keys
    cache_cap: int = 0           # presort cache width (keys per genome)


# --- genome sources ---------------------------------------------------------
#
# A source is `load(s0, s1) -> list[PackedSeqs] | _DevicePlanes` for genome
# ids [s0, s1).  PackedSeqs batches are packed on the host (2-bit words)
# and uploaded compact; _DevicePlanes carries packed planes already on the
# device (e.g. drawn by the device generator), so ingest moves no bytes.
# The pipeline asks for each dispatch's range, and asks again for the range
# of a dispatch that held an overflowing genome: the same range must yield
# the same genomes, and the second call comes from the pipeline's thread
# while its prefetch thread may be in the source for the next batch
# (file_source, codes_source and device_source are safe for both).

@dataclasses.dataclass
class _DevicePlanes:
    p: torch.Tensor              # (g, body/16) int32 2-bit packed codes
    bounds: torch.Tensor         # (g, K) int32 interior run starts (pad body)
    rid0: torch.Tensor           # (g,) int32
    valid_len: torch.Tensor      # (g,) int32


def file_source(paths: Sequence[str], max_workers: int = 8) -> Callable:
    """Parse FASTA files [s0, s1) with a host thread pool (the reference's
    cilk_for-over-files ingest, src/kmer_set.cpp:124)."""
    def load(s0: int, s1: int) -> List[PackedSeqs]:
        with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(read_fasta, paths[s0:s1]))
    return load


def codes_source(g: int, n: int, seed: int = 0) -> Callable:
    """Synthetic host genomes: one deterministic random run per genome."""
    def load(s0: int, s1: int) -> List[PackedSeqs]:
        out = []
        for i in range(s0, s1):
            rng = np.random.default_rng(seed * 1_000_003 + i)
            out.append(PackedSeqs(
                codes=rng.integers(0, 4, n).astype(np.uint8),
                run_lens=np.array([n], np.int64)))
        return out
    return load


def device_source(g: int, n: int, seed: int = 0, device="cuda") -> Callable:
    """Genomes drawn on the device (every bit pair of a random word is a
    valid 2-bit code), one run of n codes each: the zero-ingest source that
    measures the device-resident path alone.  Batch [s0, s1) comes from a
    torch.Generator on `device` seeded with (seed, s0), so a batch can be
    drawn again to check its sketches."""
    dev = torch.device(device)
    words = packed_body(n) // 16
    meta = {}          # per-batch-size run metadata, uploaded once

    def load(s0: int, s1: int) -> _DevicePlanes:
        gg = s1 - s0
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1_000_003 + s0)
        p = torch.randint(-2 ** 31, 2 ** 31, (gg, words), generator=gen,
                          dtype=torch.int32, device=dev)
        if gg not in meta:
            meta[gg] = (torch.full((gg, 1), 16 * words, dtype=torch.int32,
                                   device=dev),
                        torch.zeros(gg, dtype=torch.int32, device=dev),
                        torch.full((gg,), n, dtype=torch.int32, device=dev))
        bounds, rid0, vlen = meta[gg]
        return _DevicePlanes(p=p, bounds=bounds, rid0=rid0, valid_len=vlen)
    return load


def _pack_host_batch(batch: Sequence[PackedSeqs], n: int):
    """Host genomes -> the compact upload of the sketch step: (p (g,
    packed_body(n)/16) int32 2-bit words, bounds (g, K) int32 run starts
    padded with the body length, rid0 (g,) int32 zeros, vlen (g,) int32)."""
    body = packed_body(n)
    g = len(batch)
    runs_max = max(1, max(pk.run_lens.size - 1 for pk in batch))
    k = 1 << max(3, (runs_max - 1).bit_length())
    p = np.empty((g, body // 16), np.uint32)
    bounds = np.full((g, k), body, np.int32)
    meta = np.zeros((2, g), np.int32)          # rid0, vlen
    for i, pk in enumerate(batch):
        p[i] = pack2bit(pk.codes, body // 16)
        starts = np.cumsum(pk.run_lens)[:-1]
        bounds[i, :starts.size] = starts
        meta[1, i] = pk.codes.size
    return p.view(np.int32), bounds, meta[0], meta[1]


def _refetch(source: Callable, g: int, dispatch: int, gids: Sequence[int]):
    """Genomes `gids` again, each taken from its dispatch's range asked of
    the source again (device_source draws a batch from its start, so a
    genome is only the same within the range it was asked in), as one
    batch of the source's kind."""
    planes, host = [], []
    for d0 in sorted({int(i) // dispatch * dispatch for i in gids}):
        batch = source(d0, min(g, d0 + dispatch))
        rows = [int(i) - d0 for i in gids if d0 <= i < d0 + dispatch]
        if isinstance(batch, _DevicePlanes):
            idx = torch.tensor(rows, device=batch.p.device)
            planes.append([getattr(batch, f.name).index_select(0, idx)
                           for f in dataclasses.fields(batch)])
        else:
            host.extend(batch[r] for r in rows)
    return _DevicePlanes(*map(torch.cat, zip(*planes))) if planes else host


def _to_width(keys: torch.Tensor, width: int) -> torch.Tensor:
    """(rows, w, kw) sketch keys cut or padded with all-ones (empty) slots
    to `width`."""
    if keys.shape[1] >= width:
        return keys[:, :width]
    return torch.nn.functional.pad(keys, (0, 0, 0, width - keys.shape[1]),
                                   value=-1)


# --- the pipeline -----------------------------------------------------------

class DevicePipeline:
    """End-to-end FASTA/codes -> (G, G) intersections with device-resident
    sketches.  The presort cache holds blocks of allpairs.BLOCK (128)
    genomes, as the blocked schedule does.

    Without a mesh everything runs on the sketcher's device and `dispatch`
    genomes ride each sketch step (it and the block divide one another).
    With a `mesh` of this one process (JAX pipeline.py:418-725) every
    dispatch carries one block a slot (`dispatch` = mesh.size * BLOCK),
    which the slot sketches by the compact step (K7, the finish) and
    presorts (K5) on its own device; the blocks are gathered into one
    cache a distinct device and the upper-triangle macro-tiles (K10, K6)
    split over the slots (allpairs.mesh_tile_sweep).  Multi-rank jobs run
    MeshSketcher.  Slots that share a device run one after another: they
    show no scaling."""

    def __init__(self, sketcher: FracMinHashSketcher, *, dispatch: int = 128,
                 mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = make_mesh((1, 1), [sketcher.device])
        else:
            if world_size() > 1 or len(set(mesh.ranks)) > 1:
                raise ValueError("a mesh pipeline runs in one process; a "
                                 "multi-rank job takes MeshSketcher")
            dispatch = mesh.size * BLOCK
        if BLOCK % dispatch and dispatch % BLOCK:
            raise ValueError(f"dispatch {dispatch} and the block {BLOCK} "
                             "must divide one another")
        self.sk = sketcher
        self.mesh = mesh
        self.dispatch = dispatch
        self.restarts = 0      # whole-run restarts: none since an overflow
                               # re-sketches its genomes alone (kept, 0,
                               # for its readers)

    # -- sketch dispatch ------------------------------------------------
    def _dispatch(self, batch, n: int, capacity: int):
        """Enqueue the compact sketch step (K7) of one genome batch on
        every slot; returns (the slots' SketchBatches, each of an equal
        share of the rows, and the bytes uploaded).  Over several slots a
        short batch is padded with empty genomes to a block a slot."""
        cfg = self.sk.config
        pad_to = self.dispatch if self.mesh.size > 1 else 0
        if isinstance(batch, _DevicePlanes):
            args = (batch.p, batch.bounds, batch.rid0, batch.valid_len)
            gg = batch.p.shape[0]
            if gg < pad_to:
                fills = (0, 16 * batch.p.shape[1], 0, 0)
                args = tuple(torch.cat([x, torch.full(
                    (pad_to - gg,) + tuple(x.shape[1:]), f, dtype=x.dtype,
                    device=x.device)]) for x, f in zip(args, fills))
            h2d = 0
        else:
            empty = PackedSeqs(codes=np.empty(0, np.uint8),
                               run_lens=np.empty(0, np.int64))
            args = _pack_host_batch(
                list(batch) + [empty] * (pad_to - len(batch)), n)
            h2d = sum(x.nbytes for x in args)
        step = sharded_sketch_compact_fn(
            self.mesh, n=n, window=cfg.window, salt=self.sk.salt,
            scale=cfg.scale, variant=cfg.hash_variant, capacity=capacity)
        return step(*args, self.sk.mask.words_u32), h2d

    def _redo(self, source, g: int, n: int, gids, raw: int):
        """Sketch genomes `gids` (raw kept counts up to `raw`) again at the
        power of two above `raw`, doubling until none overflows (as
        FracMinHashSketcher._collect_sketch).  Returns their keys (len,
        cap, 4) on the first slot's device, counts, cap and the bytes
        uploaded."""
        batch = _refetch(source, g, self.dispatch, gids)
        m = len(gids)
        h2d = 0
        while True:
            cap = 1 << math.ceil(math.log2(raw + 1))
            parts, up = self._dispatch(batch, n, cap)
            count("pipeline_sketch_redos")
            h2d += up
            raws = np.concatenate([p.raw_kept.cpu().numpy()
                                   for p in parts])[:m]
            count("pipeline_host_syncs")
            raw = int(raws.max())
            if raw <= cap:
                break
            log.info("pipeline re-sketch overflow -> cap=%d", cap)
        d = parts[0].keys.device
        keys = torch.cat([p.keys.to(d) for p in parts])[:m]
        counts = np.concatenate([p.count.cpu().numpy() for p in parts])[:m]
        return keys, counts, cap, h2d

    # -- run --------------------------------------------------------------
    def all_pairs(self, source: Callable, g: int, n: int, *,
                  verify_ids: Sequence[int] = ()) -> PipelineResult:
        """source(s0, s1) yields genomes [s0, s1); `n` is the nominal
        (maximum) genome length shaping every sketch step.  Returns the
        full ordered (G, G) intersection matrix (reference all-pairs incl.
        self, src/generators.hpp:45-58).

        A sketch that overflows the capacity is taken again alone (its
        dispatch's range asked of `source` a second time, from this
        thread, while the prefetch thread may be in the source: see the
        sources above) and re-sketched at a larger capacity before its
        block's presort; phases["redo_s"] books those seconds.  A genome
        with more kept windows than the capacity raises it for the
        dispatches after its block."""
        cfg = self.sk.config
        nw = n - cfg.window + 1
        if nw <= 0:
            raise ValueError("nominal genome length below window")
        with span("pipeline.job", log):
            return self._job(source, g, n, cfg.capacity_for(nw),
                             set(verify_ids))

    def _job(self, source, g: int, n: int, capacity: int,
             verify_ids) -> PipelineResult:
        cfg = self.sk.config
        block, dispatch = BLOCK, self.dispatch
        key_bits = min(128, 2 * cfg.window)
        kw = min(4, _guard_words(key_bits))
        pw = pack_plan(key_bits, GIDBITS)
        nb = (g + block - 1) // block

        phases = {"ingest_s": 0.0, "sketch_s": 0.0, "redo_s": 0.0,
                  "restart_s": 0.0, "presort_s": 0.0, "allpairs_s": 0.0}
        bytes_h2d = 0
        bytes_d2h = 0
        sample_keys: Dict[int, torch.Tensor] = {}
        blocks: List = [None] * nb   # per-block (pw, rows_b, 128) caches
        counts = np.zeros(g, np.int32)
        t_start = time.perf_counter()
        # per OPEN block: (index, key parts, raw_kept parts, count parts);
        # a part's width is the capacity it was sketched at
        pending: List = []

        def finalize(b_idx, keyparts, raws_d, counts_d):
            nonlocal bytes_h2d, bytes_d2h, capacity
            # reading the scalars waits for this block's sketches: device
            # time, booked under sketch_s
            with span("pipeline.block_read") as read:
                raws = torch.cat(raws_d).cpu().numpy()    # one slot's rows
                cnt = torch.cat(counts_d).cpu().numpy()
            count("pipeline_host_syncs")
            phases["sketch_s"] += read.seconds
            bytes_d2h += raws.nbytes + cnt.nbytes
            i0 = b_idx * block
            caps = np.repeat([p.shape[1] for p in keyparts],
                             [p.shape[0] for p in keyparts])
            width = max(p.shape[1] for p in keyparts)
            bad = np.nonzero(raws > caps)[0]
            if bad.size:
                with span("pipeline.redo", log) as redo:
                    gids = i0 + bad
                    log.info("pipeline sketch overflow: %d genome(s) of "
                             "block %d re-sketched", bad.size, b_idx)
                    rkeys, rcnt, rcap, h2d = self._redo(
                        source, g, n, gids, int(raws[bad].max()))
                    cnt[bad] = rcnt
                    bytes_h2d += h2d
                    bytes_d2h += 8 * bad.size
                    width = max(width, rcap)
                    for j, i in enumerate(gids):
                        if i in verify_ids:
                            sample_keys[int(i)] = rkeys[j].clone()
                    if (raws[bad] > caps[bad] + 1).any():
                        # more kept windows than the capacity, not a
                        # row's chance overflow: so are the later ones
                        capacity = max(capacity, rcap)
                phases["redo_s"] += redo.seconds
            with span("pipeline.presort") as presort:
                counts[i0:i0 + cnt.shape[0]] = cnt
                # the tile scan's work is linear in the cache width: trim
                # each block to its own largest count (a power of two >=
                # 128); parts of another width pad with empty slots
                cap_b = min(width, max(128, 1 << int(math.ceil(
                    math.log2(max(1, int(cnt.max(initial=1))))))))
                kb = torch.cat([_to_width(p, cap_b) for p in keyparts])
                if bad.size:
                    kb[torch.from_numpy(bad).to(kb.device)] = _to_width(
                        rkeys[:, :, :kw].to(kb.device), cap_b)
                if kb.shape[0] < block:    # ragged tail: sentinel sketches
                    pad = torch.full((block - kb.shape[0], cap_b, kw), -1,
                                     dtype=torch.int32, device=kb.device)
                    kb = torch.cat([kb, pad])
                blocks[b_idx] = presort_block_packed(
                    kb.contiguous(), key_bits=key_bits, gidbits=GIDBITS,
                    pw=pw)
                keyparts.clear()           # frees the raw sketch keys
            phases["presort_s"] += presort.seconds

        # the NEXT dispatch's source batch is fetched on one worker thread
        # while the main thread packs, uploads and enqueues the current
        # one.  ingest_s books only the visible wait for the prefetch; the
        # worker's own time is ingest_work_s, and overlap_eff = hidden /
        # min(ingest_work, sketch_work).
        ingest_work = [0.0]

        def timed_source(a, b):
            with span("pipeline.ingest", trace=False) as work:
                out = source(a, b)
            ingest_work[0] += work.seconds
            return out

        with span("pipeline.attempt", log) as attempt, \
                cf.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(timed_source, 0, min(g, dispatch))
            for s0 in range(0, g, dispatch):
                s1 = min(g, s0 + dispatch)
                with span("pipeline.ingest_wait", trace=False) as wait:
                    batch = fut.result()
                phases["ingest_s"] += wait.seconds
                if s1 < g:
                    fut = ex.submit(timed_source, s1, min(g, s1 + dispatch))
                with span("pipeline.dispatch", trace=False) as disp:
                    parts, h2d = self._dispatch(batch, n, capacity)
                bytes_h2d += h2d
                phases["sketch_s"] += disp.seconds
                # route block-aligned slices of each slot's rows into
                # per-block pending slots (dispatch and block divide one
                # another, so a dispatch never splits a block unevenly);
                # rows past g are padding
                per = parts[0].count.shape[0]
                for k, res in enumerate(parts):
                    p0 = s0 + k * per
                    for lo in range(0, min(per, s1 - p0), block):
                        b_idx = (p0 + lo) // block
                        hi = min(lo + block, s1 - p0)
                        if not pending or pending[-1][0] != b_idx:
                            pending.append((b_idx, [], [], []))
                        pending[-1][1].append(res.keys[lo:hi, :, :kw])
                        pending[-1][2].append(res.raw_kept[lo:hi])
                        pending[-1][3].append(res.count[lo:hi])
                for i in range(s0, s1):
                    if i in verify_ids:
                        k, r = divmod(i - s0, per)
                        sample_keys[i] = parts[k].keys[r].clone()
                # finalize blocks that left the lookahead window (complete:
                # the NEXT block has started receiving parts)
                while len(pending) > LOOKAHEAD + 1:
                    finalize(*pending.pop(0))
            while pending:
                finalize(*pending.pop(0))
            with span("pipeline.assemble") as assemble:
                rows_max = max(c.shape[1] for c in blocks)
                caches = {}
                for d in self.mesh.distinct():
                    cache = torch.full((nb, pw, rows_max, 128), -1,
                                       dtype=torch.int32, device=d)
                    for b, c in enumerate(blocks):
                        # all-ones rows appended to a sorted packed stream
                        # keep it sorted, so the pad to the widest block
                        # is exact
                        cache[b, :, :c.shape[1]] = c.to(d)
                    caches[d] = cache
                del blocks
                for d in caches:
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
                        count("pipeline_host_syncs")
            phases["presort_s"] += assemble.seconds
        phases["ingest_work_s"] = ingest_work[0]
        hidden = max(0.0, ingest_work[0] + phases["sketch_s"]
                     - attempt.seconds)
        denom = min(ingest_work[0], phases["sketch_s"])
        phases["overlap_eff"] = round(hidden / denom, 3) if denom > 0.05 \
            else None
        cap_p = rows_max * 128 // block

        samples = {}
        for i, keys in sample_keys.items():
            c = int(counts[i])
            samples[i] = Sketch(keys=keys[:c].cpu().numpy().view(np.uint32),
                                count=c, window=cfg.window,
                                mask=self.sk.mask).keys_u64()
            count("pipeline_host_syncs")
            bytes_d2h += c * 16

        gpus = [c.device for c in caches.values() if c.device.type == "cuda"]
        for d in gpus:
            gram_tiles.reset_kept_runs(d)
        with span("allpairs.sweep", log) as sweep:
            out = mesh_tile_sweep(self.mesh, caches, g)
        count("pipeline_host_syncs")             # the matrix's download
        for d in gpus:                           # K6's kept runs
            count("gram_kept_runs", gram_tiles.take_kept_runs(d))
            count("pipeline_host_syncs")
        phases["allpairs_s"] = sweep.seconds
        bytes_d2h += g * g * 4

        phases["total_s"] = time.perf_counter() - t_start
        return PipelineResult(inter=out, counts=counts, phases=phases,
                              bytes_h2d=bytes_h2d, bytes_d2h=bytes_d2h,
                              sample_keys=samples, cache_cap=cap_p)


class MeshDevicePipeline(DevicePipeline):
    """DevicePipeline over `mesh` (the JAX package's name for it)."""

    def __init__(self, sketcher: FracMinHashSketcher, mesh: Mesh):
        super().__init__(sketcher, mesh=mesh)


def all_pairs_from_files(sketcher: FracMinHashSketcher,
                         paths: Sequence[str], *, dispatch: int = 32,
                         max_workers: int = 8, mesh: Optional[Mesh] = None,
                         verify_ids: Sequence[int] = ()) -> PipelineResult:
    """One-flow FASTA files -> (G, G) intersection matrix with
    device-resident sketches (the reference experiment's sketch+compare
    flow, src/kmer-sketching.cpp:151-212).  The nominal genome length is
    bounded by the largest file size (a FASTA file's code count never
    exceeds its byte size).  With `mesh` the flow runs over it
    (one process; `dispatch` is then one block a slot)."""
    n = max(os.path.getsize(p) for p in paths)
    n = max(n, sketcher.config.window + 1)
    pipe = DevicePipeline(sketcher, dispatch=dispatch, mesh=mesh)
    return pipe.all_pairs(file_source(paths, max_workers), len(paths), n,
                          verify_ids=verify_ids)
