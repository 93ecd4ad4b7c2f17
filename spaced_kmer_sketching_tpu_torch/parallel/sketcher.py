"""Mesh-backed sketcher: the execution engine of the driver's `--mesh`.

The counterpart of the JAX package's parallel/sketcher.py.  MeshSketcher
subclasses FracMinHashSketcher, so the driver and the sweep run unchanged
on a mesh:
  * `sketch_packed` sends a genome of at least `seq_par_threshold` codes
    through the sequence-parallel ring (parallel/sequence.py: K11 per
    chunk, the merge), and files past the streaming threshold stream
    through the ring segment by segment;
  * a batch (`sketch_files`, `sketch_packed_batch`) is sharded over the
    slots (parallel/sketch.py: K1 and the finish per slot), each rank
    parsing only the genomes its own slots hold (local_batch_rows);
  * the all-pairs matrix comes from mesh_all_pairs_packed (K5 per block
    once per distinct device, K10 and K6 per macro-tile, tiles split over
    the slots), or from the probe tiled over the grid.
Results are bit-identical to the single-device sketcher.

Under several ranks every rank holds every result: per-slot outputs are
all-gathered, and every rank runs the ring and the merges.
"""
from __future__ import annotations

import concurrent.futures as cf
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SketchConfig
from ..ingest.fasta import PackedSeqs, read_fasta
from ..models.fracminhash import FracMinHashSketcher, Sketch, _next_pow2
from ..observability import get_logger, span
from ..ops.gram import _guard_words
from ..ops.sketch import SketchBatch
from ..utils import native
from ..utils.masks import SpacedSeedMask
from .allpairs import mesh_all_pairs_packed, sharded_all_pairs_fn
from .distributed import (all_gather, all_reduce, global_mesh,
                          local_batch_rows)
from .mesh import Mesh, pad_to_multiple
from .sequence import (sequence_parallel_sketch_compact_fn,
                       sequence_parallel_sketch_fn)
from .sketch import gather_batches, pack_genome_batch, sharded_sketch_fn

log = get_logger(__name__)


class MeshSketcher(FracMinHashSketcher):
    """FracMinHashSketcher whose batched steps run over a mesh; its own
    `device` is its first local slot's."""

    #: genomes of at least this many codes take the sequence-parallel ring
    seq_par_threshold: int = 1 << 22

    def __init__(self, config: SketchConfig, mesh: Optional[Mesh] = None,
                 mask: Optional[SpacedSeedMask] = None,
                 seq_par_threshold: Optional[int] = None):
        self.mesh = mesh if mesh is not None else global_mesh()
        super().__init__(config, mask,
                         device=self.mesh.devices[self.mesh.local_slots()[0]])
        if seq_par_threshold is not None:
            self.seq_par_threshold = seq_par_threshold

    # ---- long genomes: the sequence-parallel ring --------------------------
    def sketch_packed(self, packed: PackedSeqs, name: str = "") -> Sketch:
        cfg = self.config
        nwin = packed.total_windows(cfg.window)
        if nwin <= 0 or int(packed.codes.size) < self.seq_par_threshold:
            return super().sketch_packed(packed, name)
        out = self._seq_parallel_batch(packed.codes,
                                       np.cumsum(packed.run_lens)[:-1], 0,
                                       nwin)
        count = int(out.count)
        return Sketch(keys=out.keys[:count].cpu().numpy().view(np.uint32),
                      count=count, window=cfg.window, mask=self.mask,
                      name=name)

    def _seq_parallel_batch(self, codes_u8: np.ndarray, starts: np.ndarray,
                            rid0: int, nwin: int) -> SketchBatch:
        """One sequence over the ring -> its merged SketchBatch, retried on
        overflow at the power of two above the ring's raw kept count.  With
        the native packer the ring takes the compact upload (2-bit words
        and run starts, expanded on each slot's device); otherwise the
        full code and run-id planes."""
        cfg = self.config
        total = int(codes_u8.size)
        # whole 128-code rows a slot (and n/16 words divide the ring)
        n = pad_to_multiple(total + cfg.window, self.mesh.size * 128)
        args = dict(window=cfg.window, salt=self.salt, scale=cfg.scale,
                    variant=cfg.hash_variant)
        if native.available():
            p = native.pack2bit(np.ascontiguousarray(codes_u8, np.uint8),
                                n // 16)
            k = 1 << max(3, int(starts.size - 1).bit_length()
                         if starts.size else 3)
            bounds = np.full(k, n, np.int32)
            bounds[:starts.size] = starts
            inputs = (p.view(np.int32), bounds, np.array([rid0], np.int32),
                      np.array([total], np.int32))
            make = sequence_parallel_sketch_compact_fn
        else:
            codes = np.zeros(n, dtype=np.uint8)
            codes[:total] = codes_u8
            run_id = np.full(n, -1, dtype=np.int32)
            run_id[:total] = rid0
            for i, s in enumerate(starts):
                run_id[int(s):total] = rid0 + i + 1
            inputs = (codes, run_id)
            make = sequence_parallel_sketch_fn
        capacity = cfg.capacity_for(nwin)
        while True:
            out = make(self.mesh, capacity=capacity, **args)(
                *inputs, self.mask.words_u32)
            raw = int(out.raw_kept)
            if raw <= capacity:
                return out
            # raw (the ring's total kept before dedup) >= the merged unique
            # count, so a chunk overflow AND a merge truncation both retry
            capacity = 1 << math.ceil(math.log2(raw + 1))
            log.info("sequence-parallel overflow -> retry cap=%d", capacity)

    def sketch_file_streaming(self, path: str, segment_nt: int = 1 << 24,
                              name: str = "") -> Sketch:
        """Bounded-memory streaming ON THE MESH: the native two-pass parser
        yields segments, each sketched over the ring with a (window-1)-code
        carry, and the segment sketches merge on the device.  Equal to the
        single-device streaming and whole-file sketches.  Under several
        ranks every rank parses the file (each segment's ring is a
        collective), so it must be on a filesystem they share."""
        if not native.available():
            return super().sketch_file_streaming(path, segment_nt, name)
        w = self.config.window
        carry = np.empty(0, np.uint8)
        carry_starts = np.empty(0, np.int64)    # starts within the carry
        cur_run = 0
        prev_open = True
        seg_bufs, seg_counts = [], []
        for codes, run_ends, open_run in native.fasta_stream(path,
                                                             segment_nt):
            if not prev_open:
                cur_run += 1
            seg_codes = np.concatenate([carry, codes])
            starts = np.concatenate([carry_starts,
                                     run_ends + carry.size]).astype(np.int64)
            rid0 = cur_run
            cur_run += len(run_ends)
            prev_open = open_run
            if w > 1:
                carry = seg_codes[-(w - 1):]
                cut = seg_codes.size - carry.size
                carry_starts = starts[starts >= cut] - cut
            nwin = seg_codes.size - w + 1
            if nwin <= 0:
                continue
            out = self._seq_parallel_batch(seg_codes, starts, rid0, nwin)
            cnt = int(out.count)
            if cnt:
                seg_bufs.append(out.keys)
                seg_counts.append(cnt)
        return self._merge_segments(seg_bufs, seg_counts, name)

    # ---- ingest: each rank parses the genomes its slots hold ----------------
    def sketch_files(self, paths: Sequence[str], max_workers: int = 8,
                     on_error: str = "raise") -> List[Sketch]:
        """Genome-level data parallelism over the mesh, with the base
        class's routing: files past _STREAM_THRESHOLD_BYTES stream over the
        ring (every rank parses them: each segment's ring is a
        collective); every other file is parsed only by the rank whose
        slots hold its row of the sharded batch."""
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
        small = [p for p in paths if p not in big]
        local = local_batch_rows(self.mesh, len(small), self.mesh.size)
        empty = PackedSeqs(codes=np.empty(0, np.uint8),
                           run_lens=np.empty(0, np.int64))

        def read(i):
            if i not in local:
                return empty
            try:
                return read_fasta(small[i])
            except Exception:
                if on_error == "raise":
                    raise
                log.exception("skipping unreadable genome %s", small[i])
                return empty

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
            with span("sketch.parse_wait"), \
                    cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
                packed = list(ex.map(read, range(len(small))))
            sketched = iter(self.sketch_packed_batch(packed, names=small)
                            if small else [])
            return [streamed[p] if p in big else next(sketched)
                    for p in paths]

    # ---- the sharded batch ------------------------------------------------
    def sketch_packed_batch(self, packed_list: Sequence[PackedSeqs],
                            names: Optional[Sequence[str]] = None
                            ) -> List[Sketch]:
        """One batch split over the slots (K1 and the finish on each).
        Under several ranks each rank holds only its own genomes (empty
        placeholders for the others'), so the genome sizes and window
        counts are all-gathered first: the padded length, the capacity and
        the per-genome guards then agree on every rank."""
        cfg = self.config
        names = list(names or [""] * len(packed_list))
        meta = np.array([[int(p.codes.size) for p in packed_list],
                         [p.total_windows(cfg.window) for p in packed_list]],
                        np.int64)
        allm = torch.stack(all_gather(torch.from_numpy(meta))).numpy()
        n_codes = int(allm[:, 0].max(initial=0))
        nwins = [int(x) for x in allm[:, 1].max(axis=0)]
        codes, run_ids, g = pack_genome_batch(packed_list, self.mesh.size,
                                              cfg.window, n_codes=n_codes)
        capacity = max([cfg.capacity_for(nw) for nw in nwins if nw > 0]
                       or [cfg.capacity_for(1)])
        while True:
            parts = sharded_sketch_fn(
                self.mesh, window=cfg.window, salt=self.salt,
                scale=cfg.scale, variant=cfg.hash_variant,
                capacity=capacity)(codes, run_ids, self.mask.words_u32)
            raw = all_reduce(torch.stack([b.raw_kept.max().to(self.device)
                                          for b in parts]).max(), "max")
            if int(raw) <= capacity:
                break
            capacity = 1 << math.ceil(math.log2(int(raw) + 1))
            log.info("sharded sketch overflow -> retry cap=%d", capacity)
        res = gather_batches(parts)
        keys = res.keys.cpu().numpy().view(np.uint32)
        counts = res.count.cpu().numpy()
        return [Sketch(keys=keys[i, :c].copy(), count=c, window=cfg.window,
                       mask=self.mask, name=names[i])
                for i, c in ((i, int(counts[i]) if nwins[i] > 0 else 0)
                             for i in range(g))]

    # ---- all-pairs over the mesh -------------------------------------------
    def all_pairs_intersections(self, sketches: Sequence[Sketch]
                                ) -> np.ndarray:
        """(G, G) intersections by mesh_all_pairs_packed: one host slab,
        each block presorted once per distinct device, the upper-triangle
        macro-tiles split over the slots.  Equal to the single-device
        engines."""
        g = len(sketches)
        cap = max(1, _next_pow2(max([s.count for s in sketches] or [1])))
        key_bits = min(128, 2 * self.config.window)
        kw = min(4, _guard_words(key_bits))
        keys = np.full((g, cap, kw), 0xFFFFFFFF, dtype=np.uint32)
        for i, s in enumerate(sketches):
            keys[i, :s.count] = s.keys[:, :kw]
        return mesh_all_pairs_packed(self.mesh, keys, key_bits=key_bits)

    def all_pairs_intersections_shardmap(self, sketches: Sequence[Sketch]
                                         ) -> np.ndarray:
        """The probe tiled over the ("r", "c") grid (the cross-check
        engine)."""
        g = len(sketches)
        gp = pad_to_multiple(max(g, 1), self.mesh.size)
        cap = max(1, _next_pow2(max([s.count for s in sketches] or [1])))
        keys = np.full((gp, cap, 4), 0xFFFFFFFF, dtype=np.uint32)
        counts = np.zeros(gp, dtype=np.int32)
        for i, s in enumerate(sketches):
            keys[i, :s.count] = s.keys
            counts[i] = s.count
        out = sharded_all_pairs_fn(self.mesh)(
            torch.from_numpy(keys.view(np.int32)), torch.from_numpy(counts))
        return out[:g, :g].numpy()
