"""FracMinHash spaced-seed sketcher — the port's main pipeline.

Host orchestration around the device sketch step:

    FASTA -> 2-bit codes (native C++) -> [device] K1 extract + hash-filter
    + row compaction -> K2/K3/K4 finish (sorted unique keys) -> Sketch
    -> all-pairs intersections -> [host float64] containment -> ANI

All-pairs intersections are routed by the genome count G, as in the JAX
package: G <= 8 with the native library takes the host sorted merge;
8 < G <= 2048 (or G <= 8 without the native library) the device Gram
(ops/gram.py: K5 merge, K6 scan); larger G the single-device block-cache
schedule (parallel/allpairs.py: K5 per block, K10 + K6 per macro-tile).

The counterpart of the JAX package's models/fracminhash.py for the main
path.  Not ported yet (ROADMAP.md): streaming of eukaryote-scale files
(module 6) and fused multi-seed sketching (module 5).  The TPU upload
cache is left behind.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ani import binomial_estimator, containment
from ..config import SketchConfig
from ..ingest.fasta import PackedSeqs, read_fasta
from ..observability import count as obs_count, get_logger, span
from ..ops.cuda.extract import pack2bit_rows
from ..ops.gram import LANES, _guard_words, gram_all_pairs_ondevice
from ..ops.sketch import finish_words, sketch_batch_packed_dyn
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


class FracMinHashSketcher:
    """One (window, k) sketching experiment on a single device."""

    _STREAM_THRESHOLD_BYTES = 1 << 28    # files past ~256M nt need streaming

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
    def sketch_packed(self, packed: PackedSeqs, name: str = "") -> Sketch:
        return self.sketch_packed_batch([packed], names=[name])[0]

    def _dispatch_sketch(self, codes: np.ndarray, run_id: np.ndarray,
                         capacity: int):
        """Pack and upload a (G, n) batch and enqueue its sketch step; the
        launches run asynchronously, so the host packs the next batch while
        the device sketches this one.  Returns a handle for
        _collect_sketch."""
        cfg = self.config
        n = codes.shape[1]
        packed = torch.from_numpy(pack2bit_rows(codes).view(np.int32))
        args = (packed.to(self.device), torch.from_numpy(run_id).to(self.device))
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
        Returns numpy (keys (G, cap, 4) uint32, counts, raws)."""
        res, args, make, capacity = handle
        raws = res.raw_kept.cpu().numpy()
        keys = res.keys.cpu().numpy().view(np.uint32)
        counts = res.count.cpu().numpy()
        raw = int(raws.max())
        if raw <= capacity:
            return keys, counts, raws
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
            raws[gi] = raws2[bi]
        return keys, counts, raws

    def sketch_files(self, paths: Sequence[str]) -> List[Sketch]:
        """Host threads parse the files; genomes sharing a padded shape go
        through the device in one batch.  An unreadable file raises, as in
        the reference (a bad file kills the run).  Files of
        _STREAM_THRESHOLD_BYTES or more need the streaming path, which is
        not ported yet."""
        for p in paths:
            try:
                big = os.path.getsize(p) >= self._STREAM_THRESHOLD_BYTES
            except OSError:
                big = False      # missing files keep read_fasta's error parity
            if big:
                raise NotImplementedError(
                    f"{p}: files of {self._STREAM_THRESHOLD_BYTES} bytes or "
                    "more need streaming ingest (ROADMAP module 6), which "
                    "the PyTorch port does not have yet")

        with span("sketching", log):
            with cf.ThreadPoolExecutor(max_workers=8) as ex:
                packed = list(ex.map(read_fasta, paths))
            return self.sketch_packed_batch(packed, names=list(paths))

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
                out[i] = Sketch(keys=np.empty((0, 4), np.uint32), count=0,
                                window=cfg.window, mask=self.mask,
                                name=names[i])
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
            keys, counts, raws = self._collect_sketch(handle)
            for j, (i, pk, nw) in enumerate(members):
                c = int(counts[j])
                out[i] = Sketch(keys=keys[j, :c].copy(), count=c,
                                window=cfg.window, mask=self.mask,
                                name=names[i])
                obs_count("runs", int(pk.run_lens.size))
                obs_count("windows", nw)
                obs_count("kept_kmers", int(raws[j]))
                obs_count("unique_kmers", c)
            obs_count("genomes", len(members))

        pending = None
        for n, members in chunks:
            g = len(members)
            codes = np.zeros((g, n), dtype=np.uint8)
            run_id = np.full((g, n), _PAD_RUN, dtype=np.int32)
            for j, (_, pk, _) in enumerate(members):
                codes[j, :pk.codes.size] = pk.codes
                pos = 0
                for rid, ln in enumerate(pk.run_lens):
                    run_id[j, pos:pos + int(ln)] = rid
                    pos += int(ln)
            capacity = max(cfg.capacity_for(nw) for _, _, nw in members)
            handle = self._dispatch_sketch(codes, run_id, capacity)
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
        kw = _guard_words(2 * self.config.window)
        cap = max(LANES, _next_pow2(max([s.count for s in sketches] or [1])))
        keys = np.full((len(sketches), cap, kw), 0xFFFFFFFF, dtype=np.uint32)
        for i, s in enumerate(sketches):
            keys[i, :s.count] = s.keys[:, :kw]
        return torch.from_numpy(keys.view(np.int32)).to(self.device)

    def all_pairs_intersections(self, sketches: Sequence[Sketch]) -> np.ndarray:
        """(G, G) intersection counts; the diagonal holds the sketch sizes.
        G <= 8 with the native library: the native sorted merge on the
        downloaded sketches.  Otherwise on the sketcher's device
        (stack_sketches): the Gram engine up to ONDEVICE_MAX_GENOMES, the
        blocked block-cache schedule above."""
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
        keys = self.stack_sketches(sketches)
        key_bits = 2 * self.config.window
        if g <= ONDEVICE_MAX_GENOMES:
            return gram_all_pairs_ondevice(keys,
                                           key_bits=key_bits).cpu().numpy()
        return blocked_all_pairs(keys, key_bits=key_bits)

    def ani_from_intersections(self, inter: np.ndarray,
                               counts_first: np.ndarray) -> np.ndarray:
        """containment uses the FIRST set of the ordered pair as denominator
        (src/kmer-sketching.cpp:198); ANI = containment^(1/k) with k = care
        positions (mask.count()/2, src/kmer-sketching.cpp:164)."""
        c = containment(inter, counts_first)
        return binomial_estimator(c, self.mask.care_positions)


def _next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(n, 1))))
