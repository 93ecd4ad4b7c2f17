"""FracMinHash spaced-seed sketcher — the port's main pipeline.

Host orchestration around the device sketch step:

    FASTA -> 2-bit codes (native C++) -> [device] K1 extract + hash-filter
    + row compaction -> K2/K3/K4 finish (sorted unique keys) -> Sketch
    -> all-pairs intersections -> [host float64] containment -> ANI

Files of _STREAM_THRESHOLD_BYTES or more (eukaryote chromosomes, BASELINE
config 5) stream instead: the native parser yields 2^24-code segments,
each is sketched on the device from a compact upload (2-bit words and run
starts, kernel K7) with a (window-1)-code carry, and the per-segment
sketches are merged on the device (merge_sketches).

All-pairs intersections are routed by the genome count G, as in the JAX
package: G <= 8 with the native library takes the host sorted merge;
8 < G <= 2048 (or G <= 8 without the native library) the device Gram
(ops/gram.py: K5 merge, K6 scan); larger G the single-device blocked
schedules (parallel/allpairs.py: K5 per block, K10 + K6 per macro-tile),
in core while the slab and the presorted cache fit the device budget
(each sketch packed bit-tight from its own keys, keys of up to 64 bits),
else out of core from blocks stacked on demand.

`intersections` (pairwise, the reference's pair lists) and
`all_pairs_intersections_probe` (the cross-check engine) run the
binary-search probe of ops/intersect.py on the sketcher's device.

Fused multi-seed sketching (BASELINE config 3, `sketch_packed_multiseed`)
uploads one genome in the compact form and runs S spaced seeds over it in
one K7 launch (seed-batch mode) and one finish of S rows.

The batch step packs each genome on the host into its 2-bit code words
and run ends (~0.25 B/nt) and uploads them at every dispatch; the run-id
plane the step reads is expanded from the run ends on the device.  Nothing
is kept across sketchers: keying a per-genome cache by the genome's content
cost the 62-config sweep more host time than the packs it saved.

The counterpart of the JAX package's models/fracminhash.py.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import math
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ani import binomial_estimator, containment
from ..config import SketchConfig
from ..ingest.fasta import PackedSeqs, read_fasta
from ..observability import get_logger, span
from ..ops.cuda.extract import pack2bit, packed_body
from ..ops.gram import (LANES, _guard_words, gram_all_pairs_ondevice,
                        pack_keys_tight_np)
from ..ops.intersect import intersection_tile, pair_intersection_batch
from ..ops.sketch import (finish_words, merge_sketches, sketch_batch_compact,
                          sketch_batch_packed_dyn)
from ..parallel.allpairs import blocked_all_pairs
from ..utils import boosthash, native
from ..utils.masks import SpacedSeedMask, spaced_seed_mask

log = get_logger(__name__)

_PAD_RUN = -1
NATIVE_MAX_GENOMES = 8       # host sorted merge up to here (native library)
ONDEVICE_MAX_GENOMES = 2048  # one device Gram up to here, then blocked


@dataclasses.dataclass
class Sketch:
    """Host-side sketch: sorted unique 128-bit keys as (n, 4) uint32 words.
    save/load use the JAX package's .npz format unchanged."""
    keys: np.ndarray           # (count, 4) uint32, sorted ascending (128-bit)
    count: int
    window: int
    mask: SpacedSeedMask
    name: str = ""

    def keys_u64(self) -> np.ndarray:
        """(count, 2) uint64 [lo, hi] view for host-side comparisons."""
        k = self.keys.astype(np.uint64)
        lo = k[:, 0] | (k[:, 1] << np.uint64(32))
        hi = k[:, 2] | (k[:, 3] << np.uint64(32))
        return np.stack([lo, hi], axis=1)

    def save(self, path: str) -> None:
        np.savez(path, keys=self.keys, count=self.count, window=self.window,
                 mask_lo=np.uint64(self.mask.lo), mask_hi=np.uint64(self.mask.hi),
                 mask_window=self.mask.window, mask_k=self.mask.k,
                 name=np.str_(self.name))

    @staticmethod
    def load(path: str) -> "Sketch":
        z = np.load(path, allow_pickle=False)
        mask = SpacedSeedMask(window=int(z["mask_window"]), k=int(z["mask_k"]),
                              lo=int(z["mask_lo"]), hi=int(z["mask_hi"]))
        return Sketch(keys=z["keys"], count=int(z["count"]),
                      window=int(z["window"]), mask=mask, name=str(z["name"]))


def _bucket_size(n: int, quantum: int = 16384) -> int:
    """Pad genomes to few distinct sizes (the JAX package's buckets, so the
    planner's shapes match it)."""
    if n <= quantum:
        return quantum
    return 1 << math.ceil(math.log2(n))


def resolve_device(device) -> torch.device:
    """A torch.device; asking for CUDA without a usable GPU raises (the
    port never carries on on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available (torch.cuda.is_available() is False)")
    return dev


class GenomeUpload(NamedTuple):
    """One genome on the device for the batch step: its codes as (n/16,)
    int32 2-bit words (pack2bit, zeros past the genome) and its run ends
    (R,) int32 (the cumulative run lengths)."""
    words: torch.Tensor
    ends: torch.Tensor


def upload_genomes(genomes: Sequence[PackedSeqs], n: int,
                   device: torch.device) -> List[GenomeUpload]:
    """`genomes` packed on the host for bucket `n` and uploaded to
    `device`, one span sketch.pack_upload a genome."""
    out = []
    for pk in genomes:
        with span("sketch.pack_upload"):
            words = pack2bit(np.ascontiguousarray(pk.codes, np.uint8),
                             n // 16)
            ends = np.cumsum(pk.run_lens, dtype=np.int64).astype(np.int32)
            out.append(GenomeUpload(_upload(words.view(np.int32), device),
                                    _upload(ends, device)))
    return out


def _stack_uploads(entries: Sequence[GenomeUpload], n: int):
    """The batch step's (packed (G, n/16) int32, run_id (G, n) int32) from
    genome uploads, built on their device into new tensors: a run's
    positions hold its index, positions past the last run end _PAD_RUN."""
    dev = entries[0].words.device
    packed = torch.stack([e.words for e in entries])
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    run_id = torch.empty((len(entries), n), dtype=torch.int32, device=dev)
    for row, e in zip(run_id, entries):
        torch.searchsorted(e.ends, pos, right=True, out_int32=True, out=row)
        row.masked_fill_(row == e.ends.numel(), _PAD_RUN)
    return packed, run_id


class FracMinHashSketcher:
    """One (window, k) sketching experiment on a single device."""

    _STREAM_THRESHOLD_BYTES = 1 << 28    # files past ~256M nt stream

    def __init__(self, config: SketchConfig,
                 mask: Optional[SpacedSeedMask] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.mask = mask if mask is not None else spaced_seed_mask(
            config.window, config.k, config.mask_seed)
        self.salt = boosthash.fmh_salt(self.mask.lo, self.mask.hi,
                                       config.window, config.nonce,
                                       config.hash_variant)

    # ---- sketching --------------------------------------------------------------
    def _empty_sketch(self, name: str) -> Sketch:
        return Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                      window=self.config.window, mask=self.mask, name=name)

    def sketch_packed(self, packed: PackedSeqs, name: str = "") -> Sketch:
        return self.sketch_packed_batch([packed], names=[name])[0]

    def sketch_file(self, path: str) -> Sketch:
        """One FASTA's sketch, named by its path, from the whole file (the
        JAX method): equal to sketch_files([path])[0]."""
        return self.sketch_packed(read_fasta(path), name=path)

    def _dispatch_sketch(self, genomes: Sequence[PackedSeqs], n: int,
                         capacity: int):
        """Enqueue the sketch step of genomes sharing bucket `n`, each
        packed and uploaded and the batch stacked on the device; the
        launches run asynchronously, so the host takes the next batch
        while the device sketches this one.  Returns a handle for
        _collect_sketch."""
        cfg = self.config
        args = _stack_uploads(upload_genomes(genomes, n, self.device), n)
        kw = finish_words(cfg.window)

        def make(cap):
            def step(packed_, rid_):
                return sketch_batch_packed_dyn(
                    packed_, rid_, self.mask.words_u32, self.salt, cfg.window,
                    n=n, kw=kw, scale=cfg.scale, variant=cfg.hash_variant,
                    capacity=cap)
            return step

        return (make(capacity)(*args), args, make, capacity)

    def _collect_sketch(self, handle):
        """Wait for a dispatched batch, running the overflow retry if
        needed: only the overflowed genomes are re-sketched, at the
        smallest power-of-two capacity above their raw kept count.
        Returns numpy (keys (G, cap, 4) uint32, counts)."""
        res, args, make, capacity = handle
        raws = res.raw_kept.cpu().numpy()
        keys = res.keys.cpu().numpy().view(np.uint32)
        counts = res.count.cpu().numpy()
        raw = int(raws.max())
        if raw <= capacity:
            return keys, counts
        bad = np.nonzero(raws > capacity)[0]
        sel_idx = torch.from_numpy(bad).to(args[0].device)
        sel = tuple(a.index_select(0, sel_idx) for a in args)
        while True:
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("sketch overflow: retry %d/%d genomes cap=%d",
                     bad.size, raws.shape[0], capacity)
            res2 = make(capacity)(*sel)
            raws2 = res2.raw_kept.cpu().numpy()
            raw = int(raws2.max())
            if raw <= capacity:
                break
        keys2 = res2.keys.cpu().numpy().view(np.uint32)
        counts2 = res2.count.cpu().numpy()
        # splice the retried genomes back (the buffer may have to widen)
        for bi, gi in enumerate(bad):
            c = int(counts2[bi])
            if c > keys.shape[1]:
                pad = np.full((keys.shape[0], c - keys.shape[1], 4),
                              0xFFFFFFFF, dtype=keys.dtype)
                keys = np.concatenate([keys, pad], axis=1)
            keys[gi, :c] = keys2[bi, :c]
            keys[gi, c:] = 0xFFFFFFFF
            counts[gi] = c
        return keys, counts

    def sketch_packed_multiseed(self, packed: PackedSeqs,
                                masks: Optional[Sequence[SpacedSeedMask]]
                                = None,
                                seeds: Optional[Sequence[int]] = None,
                                name: str = "") -> List[Sketch]:
        """Fused multi-seed sketching: S spaced seeds over ONE genome in
        one device step (BASELINE config 3).  masks: explicit seed masks
        (each of this sketcher's window); seeds: mask RNG seeds at this
        config's (window, k), default 0..7.  Returns one Sketch per seed,
        each carrying its own mask, equal to sketching with each mask
        alone.  The genome goes up once in the compact form (2-bit words
        and run starts); K7 runs every seed over it in one launch, and an
        overflow re-runs all seeds at the power of two above the largest
        raw kept count."""
        cfg = self.config
        if masks is None:
            masks = [spaced_seed_mask(cfg.window, cfg.k, s)
                     for s in (seeds if seeds is not None else range(8))]
        for m in masks:
            if m.window != cfg.window:
                raise ValueError(f"mask window {m.window} != config "
                                 f"window {cfg.window}")
        nw = packed.total_windows(cfg.window)
        if nw <= 0:
            return [Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                           window=cfg.window, mask=m, name=name)
                    for m in masks]
        salts = [boosthash.fmh_salt(m.lo, m.hi, cfg.window, cfg.nonce,
                                    cfg.hash_variant) for m in masks]
        masks_w = np.stack([m.words_u32 for m in masks])
        n, args = self._compact_upload(packed.codes,
                                       np.cumsum(packed.run_lens)[:-1], 0)
        capacity = cfg.capacity_for(nw)
        while True:
            out = sketch_batch_compact(
                *args, masks_w, salts, n=n, window=cfg.window,
                scale=cfg.scale, variant=cfg.hash_variant, capacity=capacity)
            raw = int(out.raw_kept.max())
            if raw <= capacity:
                break
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("multiseed overflow: retry cap=%d", capacity)
        keys = out.keys.cpu().numpy().view(np.uint32)
        counts = out.count.cpu().numpy()
        return [Sketch(keys=keys[i, :int(counts[i])].copy(),
                       count=int(counts[i]), window=cfg.window,
                       mask=masks[i], name=name)
                for i in range(len(masks))]

    def sketch_file_streaming(self, path: str, segment_nt: int = 1 << 24,
                              name: str = "") -> Sketch:
        """Bounded-memory sketch of an arbitrarily large FASTA: the native
        two-pass streaming parser yields `segment_nt`-code chunks; each
        chunk is sketched on the device with a (window-1)-code carry, so
        windows spanning chunk boundaries are counted exactly once, and the
        per-chunk sketches are merged on the device (merge_sketches).
        Equal to sketching the whole file: host memory is O(segment_nt +
        sketch), never O(genome)."""
        cfg = self.config
        w = cfg.window
        carry = np.empty(0, np.uint8)          # the last w-1 codes so far
        carry_starts = np.empty(0, np.int64)   # run starts inside the carry
        carry_rid0 = 0       # id of the run open at the carry's first code
        pending = collections.deque()   # dispatched, not yet collected
        seg_bufs = []        # device (cap_i, 4) sentinel-padded sketches
        seg_counts = []

        def drain_one():
            keys, count = self._collect_sketch_device(pending.popleft())
            if count:
                seg_bufs.append(keys[0])
                seg_counts.append(count)

        for codes, run_ends, _ in native.fasta_stream(path, segment_nt):
            # the segment is carry + chunk.  Its run starts are the carry's
            # and the chunk's run ends (the parser ends every run it
            # closes, at the chunk's end too, so a run closed by the
            # previous chunk has its end in the carry); only their
            # positions matter to which windows are valid
            rid0 = carry_rid0
            starts = np.concatenate([carry_starts, carry.size + run_ends])
            seg = np.concatenate([carry, codes])
            if w > 1:
                cut = max(0, seg.size - (w - 1))
                carry = seg[cut:]
                carry_starts = starts[starts > cut] - cut
                carry_rid0 = rid0 + int(np.searchsorted(starts, cut, "right"))
            if seg.size < w:
                continue
            pending.append(self._dispatch_sketch_compact(seg, starts, rid0))
            if len(pending) == 2:
                # waits only for the older segment's work (its own event):
                # the newer one runs on while the host parses onward
                drain_one()
        while pending:
            drain_one()
        return self._merge_segments(seg_bufs, seg_counts, name)

    def _merge_segments(self, seg_bufs, seg_counts, name: str) -> Sketch:
        """The streamed segments' device sketches ((cap_i, 4) int32,
        sentinel padded) merged on the device into one Sketch."""
        w = self.config.window
        if not seg_bufs:
            return self._empty_sketch(name)
        if len(seg_bufs) == 1:
            keys, count = seg_bufs[0][:seg_counts[0]], seg_counts[0]
        else:
            # buffers cut to a common power of two >= every count, the
            # segment axis padded to a power of two with empty sketches:
            # the JAX merge's shapes
            capm = max(256, _next_pow2(sum(seg_counts)))
            cut = max(256, _next_pow2(max(seg_counts)))
            s2 = _next_pow2(len(seg_bufs))
            dev = seg_bufs[0].device
            stack = torch.full((s2, cut, 4), -1, dtype=torch.int32,
                               device=dev)
            for i, buf in enumerate(seg_bufs):
                r = min(cut, buf.shape[0])   # valid rows <= count <= cut
                stack[i, :r] = buf[:r]
            counts = torch.zeros(s2, dtype=torch.int32)
            counts[:len(seg_counts)] = torch.tensor(seg_counts)
            merged = merge_sketches(stack, counts.to(dev), capm,
                                    kw=finish_words(w))
            count = int(merged.count)
            keys = merged.keys[:count]
        return Sketch(keys=keys.cpu().numpy().view(np.uint32), count=count,
                      window=w, mask=self.mask, name=name)

    def _collect_sketch_device(self, handle):
        """Wait for a dispatched single-genome batch but keep its keys on
        the device (only raw_kept and the count cross to the host); an
        overflow re-sketches this batch at the smallest power-of-two
        capacity above its raw kept count.  Returns (keys (1, cap, 4)
        int32 on the device, count)."""
        res, scalars, args, make, capacity = handle
        raw, count = (int(x) for x in scalars())
        while raw > capacity:
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("sketch overflow: retry cap=%d", capacity)
            res = make(capacity)(*args)
            raw, count = int(res.raw_kept.max()), int(res.count[0])
        return res.keys, count

    def _compact_upload(self, codes: np.ndarray, starts: np.ndarray,
                        rid0: int):
        """One genome's compact upload for sketch_batch_compact: its bucket
        n and the device (packed words, bounds, rid0, vlen), copied from
        pinned memory without blocking the host."""
        n = _bucket_size(codes.size + self.config.window)
        body = packed_body(n)
        host = (pack2bit(codes, body // 16).view(np.int32)[None],
                np.append(starts, body).astype(np.int32)[None],
                np.array([rid0], np.int32), np.array([codes.size], np.int32))
        return n, tuple(_upload(x, self.device) for x in host)

    def _dispatch_sketch_compact(self, codes: np.ndarray, starts: np.ndarray,
                                 rid0: int):
        """Compact-upload dispatch of one genome (a streaming segment): its
        2-bit words and sorted run starts go up without blocking the host,
        K7 derives the run ids on the device
        (ops/sketch.sketch_batch_compact), and raw_kept and the count start
        back at once.  Returns a handle for _collect_sketch_device."""
        cfg = self.config
        capacity = cfg.capacity_for(codes.size - cfg.window + 1)
        n, args = self._compact_upload(codes, starts, rid0)

        def make(cap):
            def step(p_, b_, rid0_, vlen_):
                return sketch_batch_compact(
                    p_, b_, rid0_, vlen_, self.mask.words_u32, self.salt,
                    n=n, window=cfg.window, scale=cfg.scale,
                    variant=cfg.hash_variant, capacity=cap)
            return step

        res = make(capacity)(*args)
        scalars = _download_later(torch.stack([res.raw_kept.max(),
                                               res.count[0]]))
        return (res, scalars, args, make, capacity)

    def sketch_files(self, paths: Sequence[str], max_workers: int = 8,
                     on_error: str = "raise") -> List[Sketch]:
        """Host threads parse the files; genomes sharing a padded shape go
        through the device in one batch.  Files of _STREAM_THRESHOLD_BYTES
        or more stream (sketch_file_streaming) when the native library is
        built, and take the whole-file path otherwise.  The output follows
        the order of `paths`.

        on_error: 'raise' mirrors the reference (a bad file kills the run);
        'skip' turns a failed parse or stream into an empty sketch and a
        log line."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"unknown on_error {on_error!r}")
        big = set()
        if native.available():
            for p in paths:
                try:
                    if os.path.getsize(p) >= self._STREAM_THRESHOLD_BYTES:
                        big.add(p)
                except OSError:
                    pass     # missing files keep read_fasta's error parity

        def read(p):
            try:
                return read_fasta(p)
            except Exception:
                if on_error == "raise":
                    raise
                log.exception("skipping unreadable genome %s", p)
                return PackedSeqs(codes=np.empty(0, np.uint8),
                                  run_lens=np.empty(0, np.int64))

        with span("sketch.files", log):
            streamed = {}
            for p in sorted(big):
                try:
                    streamed[p] = self.sketch_file_streaming(p, name=p)
                except Exception:
                    if on_error == "raise":
                        raise
                    log.exception("skipping unreadable genome %s", p)
                    streamed[p] = self._empty_sketch(p)
            small = [p for p in paths if p not in big]
            with span("sketch.parse_wait"), \
                    cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
                packed = list(ex.map(read, small))
            sketched = iter(self.sketch_packed_batch(packed, names=small))
            return [streamed[p] if p in big else next(sketched)
                    for p in paths]

    def sketch_packed_batch(self, packed_list: Sequence[PackedSeqs],
                            names: Optional[Sequence[str]] = None
                            ) -> List[Sketch]:
        """Sketch many genomes, batching same-shaped ones per dispatch."""
        cfg = self.config
        names = names or [""] * len(packed_list)
        out: List[Optional[Sketch]] = [None] * len(packed_list)
        groups = {}
        for i, pk in enumerate(packed_list):
            nwin = pk.total_windows(cfg.window)
            if nwin <= 0:
                out[i] = self._empty_sketch(names[i])
                continue
            n = _bucket_size(int(pk.codes.size) + cfg.window)
            groups.setdefault(n, []).append((i, pk, nwin))

        # double-buffered dispatch: pack chunk k+1 on the host while the
        # device sketches chunk k (launches are asynchronous)
        chunk_g = 8
        chunks = []
        for n, members in groups.items():
            for off in range(0, len(members), chunk_g):
                chunks.append((n, members[off:off + chunk_g]))

        def finalize(pending):
            members, handle = pending
            keys, counts = self._collect_sketch(handle)
            for j, (i, _, _) in enumerate(members):
                c = int(counts[j])
                out[i] = Sketch(keys=keys[j, :c].copy(), count=c,
                                window=cfg.window, mask=self.mask,
                                name=names[i])

        pending = None
        for n, members in chunks:
            capacity = max(cfg.capacity_for(nw) for _, _, nw in members)
            handle = self._dispatch_sketch([pk for _, pk, _ in members], n,
                                           capacity)
            if pending is not None:
                finalize(pending)
            pending = (members, handle)
        if pending is not None:
            finalize(pending)
        return out  # type: ignore[return-value]

    # ---- all-pairs ANI ------------------------------------------------------------
    def stack_sketches(self, sketches: Sequence[Sketch]) -> torch.Tensor:
        """Sketches -> (G, cap, kw) int32 keys on the sketcher's device,
        all-ones padded past each count, cap the power of two >= 128 that
        holds the largest (the JAX method also returns the counts; the
        padding marks them).  Only the kw = _guard_words(2 * window) low
        key words travel: canonical keys have no bits at or above
        2 * window, and the guard word keeps sentinel detection exact."""
        keys = _stack_host(sketches, _stack_cap(sketches),
                           _guard_words(2 * self.config.window))
        return torch.from_numpy(keys.view(np.int32)).to(self.device)

    def all_pairs_intersections(self, sketches: Sequence[Sketch]) -> np.ndarray:
        """(G, G) intersection counts; the diagonal holds the sketch sizes.
        G <= 8 with the native library: the native sorted merge on the
        downloaded sketches.  Otherwise on the sketcher's device: the Gram
        engine up to ONDEVICE_MAX_GENOMES (stack_sketches), the blocked
        schedule above, handed the host sketches (blocked_source) as the
        JAX sketcher hands it its host slab: the in-core cache gets each
        sketch packed bit-tight from its own keys, the out-of-core schedule
        each block's key words stacked when it needs them."""
        g = len(sketches)
        if g <= NATIVE_MAX_GENOMES and native.available():
            u64s = [s.keys_u64() for s in sketches]
            out = np.zeros((g, g), np.int32)
            for i in range(g):
                out[i, i] = sketches[i].count
                for j in range(i + 1, g):
                    out[i, j] = out[j, i] = native.intersect_sorted(
                        u64s[i], u64s[j])
            return out
        if g <= ONDEVICE_MAX_GENOMES:
            return gram_all_pairs_ondevice(
                self.stack_sketches(sketches),
                key_bits=2 * self.config.window).cpu().numpy()
        return blocked_all_pairs(**self.blocked_source(sketches))

    def blocked_source(self, sketches: Sequence[Sketch]) -> dict:
        """blocked_all_pairs' arguments for host sketches, with no
        full-width slab: a block-provider that stacks a block's key words
        (kw = _guard_words(2 * window)) when the word transport asks for
        it, and a packer that packs each sketch bit-tight straight from its
        own keys (pack_keys_tight_np into its row of the block)."""
        key_bits = 2 * self.config.window
        cap, kw = _stack_cap(sketches), _guard_words(key_bits)

        def counts(i0: int, i1: int) -> np.ndarray:
            return np.array([s.count for s in sketches[i0:i1]], np.int32)

        def provider(i0: int, i1: int):
            return _stack_host(sketches[i0:i1], cap, kw), counts(i0, i1)

        def pack(i0: int, i1: int, out: np.ndarray) -> np.ndarray:
            c = counts(i0, i1)
            for j, s in enumerate(sketches[i0:i1]):
                pack_keys_tight_np(s.keys[None], c[j:j + 1], key_bits,
                                   out=out[j:j + 1])
            return c
        return dict(keys=provider, g=len(sketches), key_bits=key_bits,
                    device=self.device, pack=pack)

    def _stack_full(self, sketches: Sequence[Sketch], cap: int):
        """Sketches -> (keys (G, cap, 4) int32 all-ones padded, counts (G,)
        int32) on the sketcher's device: the probe's layout (the JAX
        `stack_sketches` with a given cap)."""
        keys = np.full((len(sketches), cap, 4), 0xFFFFFFFF, dtype=np.uint32)
        counts = np.zeros(len(sketches), dtype=np.int32)
        for i, s in enumerate(sketches):
            keys[i, :s.count] = s.keys
            counts[i] = s.count
        return (torch.from_numpy(keys.view(np.int32)).to(self.device),
                torch.from_numpy(counts).to(self.device))

    def intersections(self, sketches_a: Sequence[Sketch],
                      sketches_b: Sequence[Sketch]) -> np.ndarray:
        """Pairwise |A_i ∩ B_i| for two equal-length sketch lists by the
        probe (ops/intersect.py) on the sketcher's device (reference
        kmer_set.cpp:143-184 incl. its length-mismatch error)."""
        if len(sketches_a) != len(sketches_b):
            raise ValueError("Mismatched pair-list lengths")
        cap = _next_pow2(max([s.count for s in
                              list(sketches_a) + list(sketches_b)] or [1]))
        ka, ca = self._stack_full(sketches_a, cap)
        kb, cb = self._stack_full(sketches_b, cap)
        return pair_intersection_batch(ka, ca, kb, cb).cpu().numpy()

    def all_pairs_intersections_probe(self, sketches: Sequence[Sketch],
                                      tile: int = 64) -> np.ndarray:
        """(G, G) matrix by the binary-search probe in (tile x tile)
        blocks on the sketcher's device: the cross-check engine beside the
        Gram."""
        g = len(sketches)
        cap = _next_pow2(max([s.count for s in sketches] or [1]))
        keys, counts = self._stack_full(sketches, cap)
        out = np.zeros((g, g), dtype=np.int32)
        for r0 in range(0, g, tile):
            r1 = min(r0 + tile, g)
            for c0 in range(0, g, tile):
                c1 = min(c0 + tile, g)
                out[r0:r1, c0:c1] = intersection_tile(
                    keys[r0:r1], counts[r0:r1], keys[c0:c1],
                    counts[c0:c1]).cpu().numpy()
        return out

    def ani_from_intersections(self, inter: np.ndarray,
                               counts_first: np.ndarray) -> np.ndarray:
        """containment uses the FIRST set of the ordered pair as denominator
        (src/kmer-sketching.cpp:198); ANI = containment^(1/k) with k = care
        positions (mask.count()/2, src/kmer-sketching.cpp:164)."""
        c = containment(inter, counts_first)
        return binomial_estimator(c, self.mask.care_positions)


def _stack_cap(sketches: Sequence[Sketch]) -> int:
    """The all-pairs engines' capacity: the power of two >= 128 that holds
    the largest sketch."""
    return max(LANES, _next_pow2(max([s.count for s in sketches] or [1])))


def _stack_host(sketches: Sequence[Sketch], cap: int, kw: int) -> np.ndarray:
    """(len, cap, kw) uint32 keys of `sketches`, all-ones padded."""
    keys = np.full((len(sketches), cap, kw), 0xFFFFFFFF, dtype=np.uint32)
    for i, s in enumerate(sketches):
        keys[i, :s.count] = s.keys[:, :kw]
    return keys


def _next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(n, 1))))


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; a CUDA copy goes from pinned
    memory and does not block the host."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _download_later(t: torch.Tensor):
    """Start copying `t` to the host; returns a function that waits for
    the work queued up to now, and no later work, and gives the values as
    numpy."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def wait():
        done.synchronize()
        return host.numpy()
    return wait
