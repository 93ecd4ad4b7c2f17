"""Sequence-parallel (context-parallel) sketching of one long sequence.

The counterpart of the JAX package's parallel/sequence.py.  The reference
walks a sequence one nucleotide at a time (src/kmer_sliding.cpp:144-185);
a window depends only on its own `window` codes, so the sequence splits
exactly into contiguous chunks, one a slot of the flattened ("r", "c")
ring, each extended by a (window - 1)-code halo: the next chunk's first
codes and run ids.  The last chunk's halo would wrap around to chunk 0,
so its run ids are -1.  Each slot sketches its chunk with
ops/sketch.sketch_core (K11, the chunked top-k, K4); the chunk sketches
are gathered and merged (merge_sketches: K4, K3) and the raw kept counts
summed over the ring.  Run ids are global, so a non-ACGT split inside a
chunk or across a chunk edge keeps its windows invalid as on one device.

Between slots of one process the halo and the chunk sketches are device
copies; across ranks the heads move by an all-gather, the sketches by an
all-gather and raw_kept by an all-reduce.  Every rank merges the ring's
sketches once, on its first slot's device, so every rank holds the same
sketch.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from ..ops.sketch import SketchBatch, finish_words, merge_sketches, sketch_core
from .distributed import all_gather, all_reduce
from .mesh import Mesh, process_rank, split_range
from .sketch import gather_slots


def _ring(mesh: Mesh, codes: List[torch.Tensor], rids: List[torch.Tensor],
          mask_words, *, window: int, salt: int, scale: int, variant: str,
          capacity: int) -> SketchBatch:
    """Sketch this process's chunks (codes[i], rids[i] of local slot i, on
    its device) with their halos, and merge the whole ring's sketches."""
    halo = window - 1
    slots = mesh.local_slots()
    # the chunk after this process's last is the next rank's first
    heads = list(zip(all_gather(codes[0][:halo]), all_gather(rids[0][:halo])))
    nxt = heads[(process_rank() + 1) % len(heads)]
    keys, counts, raws = [], [], []
    for i, s in enumerate(slots):
        d = mesh.devices[s]
        hc, hr = ((codes[i + 1][:halo], rids[i + 1][:halo])
                  if i + 1 < len(slots) else nxt)
        if s == mesh.size - 1:
            hr = torch.full_like(hr, -1)
        local = sketch_core(torch.cat([codes[i], hc.to(d)]),
                            torch.cat([rids[i], hr.to(d)]), mask_words,
                            window=window, salt=salt, scale=scale,
                            variant=variant, capacity=capacity)
        keys.append(local.keys[None])
        counts.append(local.count.reshape(1))
        raws.append(local.raw_kept.reshape(1))
    dev = mesh.devices[slots[0]]
    merged = merge_sketches(gather_slots(keys), gather_slots(counts),
                            capacity, kw=finish_words(window))
    raw = all_reduce(torch.cat([r.to(dev) for r in raws]).sum())
    return SketchBatch(keys=merged.keys, count=merged.count, raw_kept=raw)


def sequence_parallel_sketch_fn(mesh: Mesh, *, window: int, salt: int,
                                scale: int, variant: str,
                                capacity: int) -> Callable:
    """(codes (n,) integer 0..3, run_id (n,) int32, mask_words) -> the
    merged SketchBatch of ONE sequence (keys (capacity, 4), count and
    raw_kept 0-d), n a multiple of the mesh size, chunked contiguously over
    the ring.  Equal to sketch_core on the whole sequence."""
    def run(codes, run_id, mask_words) -> SketchBatch:
        codes, run_id = torch.as_tensor(codes), torch.as_tensor(run_id)
        n = codes.shape[0]
        parts = [(codes[split_range(n, mesh.size, s)].to(mesh.devices[s]),
                  run_id[split_range(n, mesh.size, s)].to(mesh.devices[s]))
                 for s in mesh.local_slots()]
        return _ring(mesh, [c for c, _ in parts], [r for _, r in parts],
                     mask_words, window=window, salt=salt, scale=scale,
                     variant=variant, capacity=capacity)
    return run


def sequence_parallel_sketch_compact_fn(mesh: Mesh, *, window: int,
                                        salt: int, scale: int, variant: str,
                                        capacity: int) -> Callable:
    """sequence_parallel_sketch_fn from a compact upload: (p (n/16,) raw
    2-bit words, 16 codes a word LSB first (utils/native.pack2bit), bounds
    (K,) int32 sorted interior run starts padded with n, rid0 (1,) and
    valid_len (1,) int32, mask_words) -> the merged SketchBatch; p's length
    a multiple of the mesh size.  Each slot expands its own chunk's codes
    on its device and its run ids from global positions, rid0 + #(bounds
    <= pos), -1 from valid_len on: the host never builds the 8 B/nt code
    and run-id planes."""
    def run(p, bounds, rid0, valid_len, mask_words) -> SketchBatch:
        p = torch.as_tensor(p)
        if p.dtype != torch.int32:          # u32 words -> their int32 bits
            p = p.view(torch.int32)
        nwords = p.shape[0]
        chunk = 16 * (nwords // mesh.size)
        bounds = torch.as_tensor(bounds).long()
        r0 = int(torch.as_tensor(rid0)[0])
        vlen = int(torch.as_tensor(valid_len)[0])
        codes, rids = [], []
        for s in mesh.local_slots():
            d = mesh.devices[s]
            words = p[split_range(nwords, mesh.size, s)].to(d)
            shifts = 2 * torch.arange(16, device=d, dtype=torch.int32)
            codes.append(((words[:, None] >> shifts) & 3).reshape(chunk)
                         .to(torch.uint8))
            pos = s * chunk + torch.arange(chunk, device=d)
            r = r0 + torch.searchsorted(bounds.to(d), pos, right=True)
            rids.append(torch.where(pos < vlen, r, -1).to(torch.int32))
        return _ring(mesh, codes, rids, mask_words, window=window,
                     salt=salt, scale=scale, variant=variant,
                     capacity=capacity)
    return run
