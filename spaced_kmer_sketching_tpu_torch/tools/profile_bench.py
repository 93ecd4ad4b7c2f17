#!/usr/bin/env python3
"""Run one mode of the port's bench under torch.profiler on one GPU.

    python3 spaced_kmer_sketching_tpu_torch/tools/profile_bench.py \
        --mode sketch [any flag of python -m spaced_kmer_sketching_tpu_torch.bench]

Runs the bench's `main` with the given flags inside one profile (CPU and
CUDA activity; the whole run, set-up and gates included), then prints the
bench's own line and, as the last line, one JSON object: the device time
and launches of every kernel the run launched, by name (the port's
hand-written kernels are those in the `sks::` namespace, the rest PyTorch's
own), the sum of those device times, the run's host wall, and their
quotient, the share of the wall the device was busy.  Exits with the
bench's code.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spaced_kmer_sketching_tpu_torch import bench

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rc = bench.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or not us:
            continue
        kernels[e.key[:120]] = [us / 1e3, e.count]
    busy_ms = sum(ms for ms, _ in kernels.values())
    print(json.dumps({
        "device_ms": busy_ms, "wall_s": wall,
        "device_busy_share": busy_ms / 1e3 / wall,
        "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1][0]))}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
