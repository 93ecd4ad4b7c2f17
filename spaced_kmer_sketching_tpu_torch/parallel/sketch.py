"""Genome-level data-parallel sketching over the mesh.

The counterpart of the JAX package's parallel/sketch.py (the reference's
`cilk_for` over FASTA files, src/kmer_set.cpp:112-133): a batch of genomes
padded to one length is split contiguously over the flattened ("r", "c")
slots (mesh.data_rows), and every slot sketches its own genomes on its
device with the single-device step, with no communication between slots:
`sharded_sketch_fn` runs ops/sketch.sketch_batch (K1, then the finish),
`sharded_sketch_compact_fn` runs sketch_batch_compact (K7, then the
finish).  Each returns one SketchBatch per slot of this process, on the
slot's device; `gather_batches` joins every slot's (and every rank's) in
slot order.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..ops.sketch import SketchBatch, sketch_batch, sketch_batch_compact
from .distributed import all_gather
from .mesh import Mesh, data_rows, pad_to_multiple


def slot_rows(mesh: Mesh, x, slot: int, device) -> torch.Tensor:
    """Slot `slot`'s rows of x (a numpy array or a tensor with a leading
    genome axis) as a tensor on `device`."""
    part = x[data_rows(mesh, x.shape[0], slot)]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(device)


def sharded_sketch_fn(mesh: Mesh, *, window: int, salt: int, scale: int,
                      variant: str, capacity: int) -> Callable:
    """(codes (G, n) integer 0..3, run_ids (G, n) int32, mask_words) ->
    [SketchBatch of each local slot's G / mesh.size genomes], G a multiple
    of the mesh size (pad with all -1 run-id rows)."""
    def run(codes, run_ids, mask_words) -> List[SketchBatch]:
        return [sketch_batch(
            slot_rows(mesh, codes, s, mesh.devices[s]),
            slot_rows(mesh, run_ids, s, mesh.devices[s]), mask_words,
            window=window, salt=salt, scale=scale, variant=variant,
            capacity=capacity) for s in mesh.local_slots()]
    return run


def sharded_sketch_compact_fn(mesh: Mesh, *, n: int, window: int, salt: int,
                              scale: int, variant: str,
                              capacity: int) -> Callable:
    """The compact-upload step: (p (G, packed_body(n)/16) int32 raw 2-bit
    words, bounds (G, K) int32 run starts padded with the body length,
    rid0 (G,), valid_len (G,), mask_words) -> [SketchBatch of each local
    slot], G a multiple of the mesh size.  Each slot's words expand on its
    own device (K7)."""
    def run(p, bounds, rid0, valid_len, mask_words) -> List[SketchBatch]:
        out = []
        for s in mesh.local_slots():
            d = mesh.devices[s]
            out.append(sketch_batch_compact(
                *(slot_rows(mesh, x, s, d) for x in (p, bounds, rid0,
                                                     valid_len)),
                mask_words, salt, n=n, window=window, scale=scale,
                variant=variant, capacity=capacity))
        return out
    return run


def gather_slots(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """This process's slots' parts (leading slot-row axis) and every other
    rank's, concatenated in slot order on the first part's device."""
    local = torch.cat([p.to(parts[0].device) for p in parts])
    return torch.cat(all_gather(local))


def gather_batches(parts: Sequence[SketchBatch]) -> SketchBatch:
    """Every slot's SketchBatch joined along the genome axis."""
    return SketchBatch(*(gather_slots([getattr(b, f) for b in parts])
                         for f in SketchBatch._fields))


def pack_genome_batch(packed_list: Sequence, mesh_size: int, window: int,
                      n_codes: int = None):
    """Pad G genomes to one length and a multiple of the mesh size ->
    (codes (G', n) uint8, run_ids (G', n) int32 (-1 on padding), G).

    n_codes: the largest genome length over every rank, for a rank whose
    packed_list holds empty placeholders for other ranks' genomes: the
    padded length must agree across ranks."""
    g = len(packed_list)
    gp = pad_to_multiple(max(g, 1), mesh_size)
    n = max([p.codes.size for p in packed_list] + [window, n_codes or 0]) \
        + window
    n = pad_to_multiple(n, 128)
    codes = np.zeros((gp, n), dtype=np.uint8)
    run_ids = np.full((gp, n), -1, dtype=np.int32)
    for i, p in enumerate(packed_list):
        t = p.codes.size
        codes[i, :t] = p.codes
        pos = 0
        for rid, ln in enumerate(p.run_lens):
            run_ids[i, pos:pos + int(ln)] = rid
            pos += int(ln)
    return codes, run_ids, g
