"""Multi-slot dry run of the port's sharded paths at tiny shapes.

The counterpart of the JAX package's `__graft_entry__.dryrun_multichip`:

    python -c "from spaced_kmer_sketching_tpu_torch.dryrun import \\
        dryrun_multichip; dryrun_multichip(8)"

runs, on n_devices slots of `device`,
  1. the driver CLI with `--mesh auto` (and, on the CPU, `--mesh RxC` over
     n_devices slots) against the single-device CSV, byte for byte;
  2. the sequence-parallel ring over one 512 * n_devices-code sequence,
     against sketch_core on the whole sequence;
  3. its compact-upload variant, against the ring.
It switches no process-wide setting: the caller names the device.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device="cpu") -> None:
    from .driver import main as driver_main
    from .ops.sketch import sketch_core
    from .parallel.mesh import _factor2d, make_mesh
    from .parallel.sequence import (sequence_parallel_sketch_compact_fn,
                                    sequence_parallel_sketch_fn)
    from .utils import boosthash, native
    from .utils.masks import spaced_seed_mask

    dev = torch.device(device)
    window, k, scale, cap = 20, 16, 5, 1024   # no overflow: ~820 kept
    rng = np.random.default_rng(1)

    # 1. the driver CLI over the mesh, byte-identical to one device
    with tempfile.TemporaryDirectory() as td:
        fastas = []
        for i in range(max(3, n_devices // 2)):
            p = os.path.join(td, f"g{i}.fa")
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 2500))
            with open(p, "w") as f:
                f.write(f">g{i}\n{seq}\n")
            fastas.append(p)
        common = [*fastas, "--window", "20", "--k", "16", "--scale", "20",
                  "--device", device]
        single = os.path.join(td, "single.csv")
        if driver_main([single, *common]) != 0:
            raise RuntimeError("dryrun: the single-device CLI failed")
        want = open(single).read()
        meshes = ["auto"]
        if dev.type == "cpu":
            r, c = _factor2d(n_devices)
            meshes.append(f"{r}x{c}")
        for m in meshes:
            out = os.path.join(td, f"mesh_{m}.csv")
            if driver_main([out, *common, "--mesh", m]) != 0:
                raise RuntimeError(f"dryrun: the CLI with --mesh {m} failed")
            if open(out).read() != want:
                raise RuntimeError(f"dryrun: --mesh {m} CSV != one device's")
            if want.count("\n") != len(fastas) ** 2 + 1:
                raise RuntimeError("dryrun: the CSV misses rows")

    # 2. the ring over one sequence
    mesh = make_mesh(devices=[dev] * n_devices)
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    n = 512 * n_devices
    seq = rng.integers(0, 4, n).astype(np.uint8)
    rid = np.zeros(n, np.int32)
    args = dict(window=window, salt=salt, scale=scale, variant="modern",
                capacity=cap)
    merged = sequence_parallel_sketch_fn(mesh, **args)(seq, rid,
                                                       mask.words_u32)
    ref = sketch_core(torch.from_numpy(seq).to(dev),
                      torch.from_numpy(rid).to(dev), mask.words_u32, **args)
    count = int(merged.count)
    if count <= 0 or int(merged.raw_kept) > cap or count != int(ref.count) \
            or not torch.equal(merged.keys.cpu(), ref.keys.cpu()):
        raise RuntimeError("dryrun: the ring != sketch_core")

    # 3. the compact-upload ring
    if native.available():
        p = native.pack2bit(seq, n // 16).view(np.int32)
        merged_c = sequence_parallel_sketch_compact_fn(mesh, **args)(
            p, np.array([n], np.int32), np.zeros(1, np.int32),
            np.array([n], np.int32), mask.words_u32)
        if int(merged_c.count) != count or not torch.equal(
                merged_c.keys.cpu(), merged.keys.cpu()):
            raise RuntimeError("dryrun: the compact ring != the ring")
