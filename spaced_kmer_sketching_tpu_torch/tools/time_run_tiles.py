#!/usr/bin/env python3
"""Time variants of the port's K8 and K9 register tiles on one GPU.

K8 (sort_runs) and K9 (sort_truncate) sort SKS_RUN_E keys a thread in
registers, then merge by merge path in shared memory, in tiles of
SKS_RUN_TILE entries; K8 takes tiles of SKS_RUN_TILE_MIN for runs up to
that size (csrc/sort.cu).  This script builds the kernel library as it is
and once for each variant below with those macros set (build.load), holds
each variant's K8 and K9 against the plain PyTorch versions at their
timed shapes (kw 2), and times them with CUDA events and torch.profiler
(device time by kernel, device launches of one call).  Run from the
repository root on a machine with an NVIDIA GPU and nvcc:

    python3 spaced_kmer_sketching_tpu_torch/tools/time_run_tiles.py

It prints the card's name and power limit and one JSON line per variant
and shape.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# name -> the macros of csrc/sort.cu it sets (the library's own first)
VARIANTS = {
    "library": (),
    "4 keys a thread": ("SKS_RUN_E=4",),
    "16 keys a thread": ("SKS_RUN_E=16",),
    "tiles of 2,048": ("SKS_RUN_TILE=2048",),
    "K8 tiles of 4,096 at every run": ("SKS_RUN_TILE_MIN=4096",),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_run_tiles: no CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build, sort

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    libs = {name: build.load(defines) for name, defines in VARIANTS.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = build.stream_ptr(dev)

    def keys(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def report(what, shape, name, out, want, call):
        call()
        by_kernel = cs.profile_kernels(lambda: [call() for _ in range(20)])
        print(json.dumps({
            "kernel": what, "shape": shape, "variant": name,
            "max_abs_err": cs.max_abs_err([out], [want]),
            "ms": cs.time_ms(call, 50),
            "device_ms": cs.device_ms(call, 20),
            "device_launches": cs.device_launches(call),
            "device_ms_by_kernel": {k: v[0] / 20
                                    for k, v in by_kernel.items()}}))

    for g, runs, run in [(8, 2, 2048), (1, 8, 32768)]:
        m = runs * run
        z = keys((2, g, m))
        z[:, :, ::7] = z[:, :, 1:2]
        z[:, :, -run // 2:] = -1
        want = sort.sort_runs_plain(z, run)
        for name, lib in libs.items():
            out = torch.empty_like(z)
            scratch = torch.empty(
                max(lib.sks_sort_runs_scratch(2, g, m, run), 1),
                dtype=torch.int32, device=dev)

            def call():
                build.check(lib.sks_sort_runs(
                    z.data_ptr(), out.data_ptr(), scratch.data_ptr(), 2, g,
                    m, run, stream), "sks_sort_runs")
            report("K8", [2, g, runs, run], name, out, want, call)
    for t, cap in [(4, 2048), (16, 8192)]:
        m = t * sort.TILE
        z = torch.full((2, 1, m), -1, dtype=torch.int32, device=dev)
        hit = torch.rand(m, device=dev, generator=gen) < cap / (2 * m)
        z[:, 0, hit] = keys((2, int(hit.sum())))
        want = sort.sort_truncate_plain(z, cap)
        for name, lib in libs.items():
            out = torch.empty((2, 1, cap), dtype=torch.int32, device=dev)
            scratch = torch.empty(lib.sks_sort_truncate_scratch(2, 1, m, cap),
                                  dtype=torch.int32, device=dev)

            def call():
                build.check(lib.sks_sort_truncate(
                    z.data_ptr(), scratch.data_ptr(), out.data_ptr(), 2, 1,
                    m, cap, stream), "sks_sort_truncate")
            report("K9", [2, 1, t, cap], name, out, want, call)
    return 0


if __name__ == "__main__":
    sys.exit(main())
