"""Experiment driver + CLI of the PyTorch port — the reference `main`.

Mirrors src/kmer-sketching.cpp:151-240, as the JAX package's driver does:
  * one experiment = generate mask (seed 0) -> sketch all FASTA files ->
    all-pairs intersections (ordered, incl. self) -> containment (denominator
    = FIRST set of each ordered pair) -> ANI -> append CSV rows;
  * wall-clock spans printed to stdout in the reference's exact format
    ("Time taken for sketching = X ms" / "Time taken for comparison = X ms",
    src/kmer-sketching.cpp:175,203), taken after the device work is done;
  * the argv contract `prog OUTPUT_CSV FASTA...` and the hard-coded sweep —
    (w=10,k=10) fresh CSV, then k=11..40 with w=k, then k=10..40 with w=k+10,
    all appended (src/kmer-sketching.cpp:214-240).

`--device` (default cuda) is the counterpart of the JAX driver's
`--platform`: `cuda` without a GPU raises, `cpu` runs the kernels' plain
PyTorch versions.  Collections of more than _PIPELINE_MIN_GENOMES genomes
on a GPU take the one-flow device pipeline (pipeline.py), as the JAX driver
routes them; its CSV is the two-step path's byte for byte.  As in the JAX
driver, `--pairing ring` writes the adjacent pairs (i, i+1 mod n) by the
probe, `--store DIR` checkpoints sketches and lets a killed sweep resume
at pair level, and `--profile DIR` writes a profiler trace (torch.profiler
here).

`--mesh RxC|auto` runs sketching and all-pairs over a device mesh
(parallel/sketcher.MeshSketcher) after `init_distributed()`: under
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) every rank runs this CLI on its own GPU over NCCL (gloo with
`--device cpu`) and writes the same CSV; without it the mesh is this
process's GPUs (`auto`: all of them; RxC must name as many) or, with
`--device cpu`, R x C CPU slots.  A single-process mesh run takes the
MeshDevicePipeline under the same size rule.  The JAX driver's
SKS_DEVICE_PIPELINE knob is not ported (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import SketchConfig
from .csvout import write_to_csv
from .generators import all_pair_indices, ring_pair_indices
from .models.fracminhash import FracMinHashSketcher, Sketch
from .observability import get_logger
from .parallel.distributed import world_size
from .pipeline import all_pairs_from_files

log = get_logger(__name__)


#: collections above this size route through the device pipeline (the
#: JAX driver's threshold)
_PIPELINE_MIN_GENOMES = 512


def _use_device_pipeline(sk: FracMinHashSketcher, filenames, pairing: str,
                         store) -> bool:
    """Route a collection through the one-flow device pipeline when it
    takes all pairs and no store, the sketcher is on a GPU, it has more
    than _PIPELINE_MIN_GENOMES genomes, no file needs the streaming path,
    and padding every genome to the largest file at most doubles the
    device work (the pipeline shapes every genome to the largest file; the
    two-step path buckets them by size).  A mesh sketcher routes only in
    one process (MeshDevicePipeline); a multi-rank job stays on
    MeshSketcher."""
    if pairing != "all" or store is not None:
        return False
    if getattr(sk, "mesh", None) is not None and world_size() > 1:
        return False
    if sk.device.type != "cuda" or len(filenames) <= _PIPELINE_MIN_GENOMES:
        return False
    try:
        sizes = [os.path.getsize(f) for f in filenames]
    except OSError:
        return False         # missing files keep read_fasta's error parity
    if max(sizes) >= sk._STREAM_THRESHOLD_BYTES:
        return False
    return max(sizes) * len(sizes) <= 2 * sum(sizes)


def run_experiment(window_size: int, kmer_size: int, filenames: Sequence[str],
                   output_filename: str, is_append: bool,
                   config: Optional[SketchConfig] = None,
                   sketcher: Optional[FracMinHashSketcher] = None,
                   echo_timings: bool = True, device="cuda", store=None,
                   pairing: str = "all", resume_done=None,
                   make_sketcher=None) -> np.ndarray:
    """One (window, k) experiment over `filenames`; returns the flat ANI list
    in reference pair order (all ordered pairs incl. self, row-major; with
    pairing="ring" the adjacent pairs (i, i+1 mod n),
    src/generators.hpp:21-34).

    `store` (a store.SketchStore) reuses checkpointed sketches and saves
    new ones.  `resume_done` (a Counter from store.completed_pairs_in_csv,
    consumed in place) makes the experiment resumable at PAIR level: rows
    already present in the output CSV are neither recomputed (a
    fully-finished config skips sketching entirely) nor rewritten, so a
    killed sweep rerun appends exactly the missing rows in order — the
    final CSV is byte-identical to an uninterrupted run (the reference's
    append-mode accumulation contract, src/kmer-sketching.cpp:53-70).

    `make_sketcher` (cfg -> sketcher) selects the engine: the CLI passes
    MeshSketcher under --mesh."""
    cfg = config or SketchConfig(window=window_size, k=kmer_size)
    if (cfg.window, cfg.k) != (window_size, kmer_size):
        cfg = SketchConfig(window=window_size, k=kmer_size,
                           mask_seed=cfg.mask_seed, scale=cfg.scale,
                           nonce=cfg.nonce, hash_variant=cfg.hash_variant,
                           sketch_capacity=cfg.sketch_capacity)
    sk = sketcher or (make_sketcher(cfg) if make_sketcher
                      else FracMinHashSketcher(cfg, device=device))
    g = len(filenames)
    pairs = ring_pair_indices(g) if pairing == "ring" else all_pair_indices(g)

    write_row = None
    if resume_done is not None:
        bits = sk.mask.bitstring()
        write_row = []
        for i, j in pairs:
            key = (str(filenames[i]), str(filenames[j]), str(window_size),
                   bits)
            if resume_done.get(key, 0) > 0:
                resume_done[key] -= 1
                write_row.append(False)
            else:
                write_row.append(True)
        if not any(write_row):
            log.info("resume: config (w=%d, k=%d) already complete, skipped",
                     window_size, kmer_size)
            return np.empty(0)

    t0 = time.perf_counter()
    inter = None
    if _use_device_pipeline(sk, filenames, pairing, store):
        res = all_pairs_from_files(sk, filenames,
                                   mesh=getattr(sk, "mesh", None))
        counts, inter = res.counts, res.inter
        # the pipeline's phases interleave: ingest + sketch + presort count
        # as sketching, the tile sweep and the host math below as comparison
        ph = res.phases
        sketch_s = ph["ingest_s"] + ph["sketch_s"] + ph["presort_s"]
        t1 = time.perf_counter() - ph["allpairs_s"]
    else:
        if store is not None:
            sketches: List[Sketch] = store.sketch_files_resumable(
                sk, filenames)
        else:
            sketches = sk.sketch_files(filenames)
        if sk.device.type == "cuda":
            torch.cuda.synchronize(sk.device)
        t1 = time.perf_counter()
        sketch_s = t1 - t0
        counts = [s.count for s in sketches]
    if echo_timings:
        print(f"Time taken for sketching = {sketch_s * 1e3} ms")

    counts = np.asarray(counts, dtype=np.int64)
    if pairing == "ring":
        inter_flat = sk.intersections([sketches[i] for i, _ in pairs],
                                      [sketches[j] for _, j in pairs])
        ani = sk.ani_from_intersections(
            np.asarray(inter_flat), np.array([counts[i] for i, _ in pairs]))
    else:
        if inter is None:
            inter = sk.all_pairs_intersections(sketches)  # (G, G) int32
        # ordered pairs row-major: pair (i, j) -> denominator |set_i|
        ani = sk.ani_from_intersections(inter.reshape(-1),
                                        np.repeat(counts, max(g, 1)))
    t2 = time.perf_counter()
    if echo_timings:
        print(f"Time taken for comparison = {(t2 - t1) * 1e3} ms")
    names1 = [str(filenames[i]) for i, _ in pairs]
    names2 = [str(filenames[j]) for _, j in pairs]
    values = list(map(float, ani))
    if write_row is not None:
        names1 = [n for n, w in zip(names1, write_row) if w]
        names2 = [n for n, w in zip(names2, write_row) if w]
        values = [v for v, w in zip(values, write_row) if w]
    write_to_csv(names1, names2, values, window_size, sk.mask,
                 output_filename, is_append)
    return ani


def reference_sweep_schedule():
    """The 62 (window, k, is_append) configs of the reference main
    (src/kmer-sketching.cpp:219-239)."""
    sched = [(10, 10, False)]
    sched += [(k, k, True) for k in range(11, 41)]
    sched += [(k + 10, k, True) for k in range(10, 41)]
    return sched


def run_reference_sweep(output_filename: str, filenames: Sequence[str],
                        config: Optional[SketchConfig] = None,
                        echo_timings: bool = True, device="cuda",
                        store=None, make_sketcher=None) -> None:
    """The reference's 62-config main loop.  With a store and an existing
    output CSV, the sweep RESUMES: rows already in the CSV are skipped at
    pair level (fully-finished configs skip sketching entirely; a config
    killed mid-write appends only its missing rows), so the final CSV is
    byte-identical to an uninterrupted run."""
    resume_done = None
    if store is not None and os.path.exists(output_filename):
        from .store import completed_pairs_in_csv
        resume_done = completed_pairs_in_csv(output_filename)
        if resume_done:
            log.info("resume: %d rows already in %s",
                     sum(resume_done.values()), output_filename)
    for window, k, is_append in reference_sweep_schedule():
        if resume_done:
            is_append = True       # never truncate a CSV being resumed
        run_experiment(window, k, filenames, output_filename, is_append,
                       config=config, echo_timings=echo_timings,
                       device=device, store=store, resume_done=resume_done,
                       make_sketcher=make_sketcher)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="spaced-kmer-sketching-tpu-torch",
        description="Spaced k-mer FracMinHash ANI estimation on a CUDA GPU "
                    "(PyTorch port)")
    parser.add_argument("output_csv")
    parser.add_argument("fastas", nargs="+")
    parser.add_argument("--window", type=int, default=None,
                        help="run ONE experiment at this window (with --k) "
                             "instead of the reference's 62-config sweep")
    parser.add_argument("--k", type=int, default=None)
    parser.add_argument("--scale", type=int, default=SketchConfig.scale)
    parser.add_argument("--nonce", type=int, default=SketchConfig.nonce)
    parser.add_argument("--mask-seed", type=int, default=SketchConfig.mask_seed)
    parser.add_argument("--hash-variant", choices=("modern", "legacy"),
                        default=SketchConfig.hash_variant)
    parser.add_argument("--append", action="store_true",
                        help="append to the CSV (single-experiment mode)")
    parser.add_argument("--pairing", choices=("all", "ring"), default="all",
                        help="all: full ordered n^2 incl. self-pairs "
                             "(reference main); ring: adjacent (i, i+1 mod n)")
    parser.add_argument("--store", default=None, metavar="DIR",
                        help="sketch checkpoint directory: reruns reuse "
                             "already-computed sketches")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace to DIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the kernels; raises "
                             "without a GPU) or cpu (their plain versions)")
    parser.add_argument("--mesh", default=None, metavar="RxC|auto",
                        help="run sketching and all-pairs over a 2-D device "
                             "mesh (e.g. 2x4); 'auto' takes every GPU of "
                             "the job (with --device cpu, one CPU slot a "
                             "rank)")
    args = parser.parse_args(argv)

    from .utils.hostmem import tune as _malloc_tune
    _malloc_tune()

    if (args.window is None) != (args.k is None):
        parser.error("--window and --k must be given together")
    base = SketchConfig(
        window=args.window or 10, k=args.k or 10, scale=args.scale,
        nonce=args.nonce, mask_seed=args.mask_seed,
        hash_variant=args.hash_variant)

    store = None
    if args.store:
        from .store import SketchStore
        store = SketchStore(args.store)

    make_sketcher = None
    joined = torch.distributed.is_initialized()
    if args.mesh:
        from .parallel.distributed import global_mesh, init_distributed
        from .parallel.sketcher import MeshSketcher
        shape = None if args.mesh == "auto" else tuple(
            int(x) for x in args.mesh.lower().replace(",", "x").split("x"))
        if shape is not None and len(shape) != 2:
            parser.error("--mesh takes RxC or auto")
        init_distributed(backend="nccl" if torch.device(args.device).type
                         == "cuda" else "gloo")
        mesh = global_mesh(shape, device=args.device)
        make_sketcher = lambda cfg: MeshSketcher(cfg, mesh)  # noqa: E731

    ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        ctx = profile(activities=activities,
                      on_trace_ready=tensorboard_trace_handler(args.profile))
    try:
        with ctx:
            if args.window is not None:
                run_experiment(args.window, args.k, args.fastas,
                               args.output_csv, args.append, config=base,
                               device=args.device, store=store,
                               pairing=args.pairing,
                               make_sketcher=make_sketcher)
            else:
                run_reference_sweep(args.output_csv, args.fastas,
                                    config=base, device=args.device,
                                    store=store, make_sketcher=make_sketcher)
    except FileNotFoundError as e:
        # reference CLI error parity: an unopenable FASTA prints to stderr
        # and exits 1 (src/fasta_processing.cpp:86-90) — the exact bytes,
        # including the trailing space and the leading space on the second
        # line ("Unable to open <f>. \n Exiting..." << std::endl)
        msg = str(e)
        prefix = "Unable to open "
        fname = msg[len(prefix):] if msg.startswith(prefix) else msg
        print(f"Unable to open {fname}. \n Exiting...", file=sys.stderr)
        return 1
    finally:
        if not joined and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()   # the job it joined
    return 0


if __name__ == "__main__":
    sys.exit(main())
