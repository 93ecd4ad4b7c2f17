#!/usr/bin/env python3
"""Time the blocked schedule's two host transports on one GPU.

On 4,096 host sketches drawn as chip_smoke.py phase 6 draws them
(blocked_sketches: ~25,000 40-bit keys each, capacity 32,768; here from
seed 0), this script runs blocked_all_pairs over the sketcher's host
source (FracMinHashSketcher.blocked_source) by the word transport and by
the bit-tight transport with allpairs.PACK_THREADS set to each of
THREADS, in turns (each value once ascending, once descending, the word
transport first and last), and prints for each run its wall, the
packer's and the stacker's summed thread time and the bytes uploaded.
Every matrix must equal the first.  Run from the repository root on a
machine with an NVIDIA GPU and nvcc:

    python3 spaced_kmer_sketching_tpu_torch/tools/time_transport.py

It prints the card's name and power limit and one JSON line per run.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

THREADS = (2, 4, 6, 8)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_transport: no CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cuda")
    sketches = cs.blocked_sketches(np.random.default_rng(0), sk.mask)
    src = sk.blocked_source(sketches)
    spent = {}

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[key] += time.perf_counter() - t0
        return run
    args = dict(src, pack=timed(src["pack"], "pack"),
                keys=timed(src["keys"], "stack"))
    runs = [("words", None), *(("tight", n) for n in THREADS),
            *(("tight", n) for n in reversed(THREADS)), ("words", None)]
    allpairs.blocked_all_pairs(**src)                  # warm-up
    first = None
    for transport, threads in runs:
        if threads is not None:
            allpairs.PACK_THREADS = threads
        spent.update(pack=0.0, stack=0.0)
        observability.reset_counters()
        t0 = time.perf_counter()
        out = allpairs.blocked_all_pairs(**args, transport=transport)
        wall = time.perf_counter() - t0
        if first is None:
            first = out
        elif not np.array_equal(out, first):
            print(f"time_transport: {transport} at {threads} threads gave "
                  "another matrix", file=sys.stderr)
            return 1
        print(json.dumps({
            "transport": transport, "pack_threads": threads, "wall_s": wall,
            "pack_thread_ms": spent["pack"] * 1e3,
            "stack_thread_ms": spent["stack"] * 1e3,
            "h2d_bytes": observability.counters().get("blocked_h2d_bytes",
                                                      0),
            "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
