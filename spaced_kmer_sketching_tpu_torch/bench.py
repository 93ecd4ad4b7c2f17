"""The port's benchmark: one verified JSON line per mode on the card.

    python -m spaced_kmer_sketching_tpu_torch.bench [--mode MODE]
        [--device cuda|cpu] [--nt N] [--iters I] ...

The counterpart of the repository's `bench.py` (which runs the JAX
package), with its five modes, flags and data: every genome and sketch
comes from the same seeds and generator calls, so the two benches sketch
the same inputs.
  sketch     G genomes of --nt codes, packed and uploaded once, through
             ops/sketch.sketch_batch_packed (K1, then the finish route the
             shape takes);
  allpairs   G synthetic sketches of capacity 8,192 through the on-device
             Gram (default and --ondevice: K5, K6), the block-cache
             schedule (--blocked: K5, K10, K6) or the probe (--probe,
             ops/intersect.all_pairs_matrix);
  multiseed  --seeds spaced seeds over one compactly uploaded genome in one
             step (ops/sketch.sketch_batch_compact: K7's seed-batch mode,
             the finish of S rows; BASELINE config 3);
  stream     a synthetic FASTA of --nt codes through sketch_file_streaming,
             cold and warm (K7, the finish, the device merge; config 5);
  e2e        genomes -> (G, G) intersections through pipeline.DevicePipeline
             (or, with --e2e-mesh, pipeline.MeshDevicePipeline over every
             local device: each GPU, or one CPU slot) from files, host
             codes or device-drawn genomes (config 4).

Timing: the kernel library is loaded (built by nvcc at first use) before
anything is timed (`build_s`).  The step modes (sketch, allpairs,
multiseed) make one untimed warm-up call, then --iters calls each timed on
the host clock up to a synchronize (`step_ms`, the median, with
`step_ms_min` and `step_ms_max`), then, on the card, CUDA events around
--iters more calls with no host sync between them (`events_ms`, per
call).  stream and e2e report host walls of whole passes.  `vs_baseline`
divides by the native C++ scalar pipeline's rate (native/sketchlib.cpp)
measured in the same run.  Every line names its device (`platform`,
`device`, `power_limit_w` from nvidia-smi), its peak device memory and
`launches`, each hand-written kernel's launches over the whole run (the
wrappers' counters: none on the CPU, where the plain versions run); a CPU
run's metric carries the prefix `cpu_`.

Each line is the last line of stdout, with `verified` from the mode's gate
against the native pipeline (`null` under --no-verify); the exit code is 1
when a gate fails.  `--device cuda` without a GPU raises: nothing falls
back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .config import SketchConfig
from .ingest.fasta import read_fasta
from .models.fracminhash import FracMinHashSketcher, resolve_device
from .ops.cuda import build
from .ops.cuda.extract import out_rows, pack2bit
from .ops.gram import gram_all_pairs_ondevice
from .ops.intersect import all_pairs_matrix, intersection_tile
from .ops.sketch import (_k_slots_for, finish_route, sketch_batch_compact,
                         sketch_batch_packed)
from .parallel.allpairs import BLOCK, blocked_all_pairs
from .parallel.mesh import make_mesh
from .pipeline import (DevicePipeline, MeshDevicePipeline, codes_source,
                       device_source, file_source)
from .utils import boosthash, hostmem, native
from .utils.masks import spaced_seed_mask

MODES = ("sketch", "allpairs", "multiseed", "stream", "e2e")
SYNTH_CAP = 1 << 13       # allpairs: 8,192 keys a sketch (E. coli-sized)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m spaced_kmer_sketching_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--mode", choices=MODES, default="sketch")
    ap.add_argument("--nt", type=int, default=1 << 21,
                    help="genome length in nucleotides")
    ap.add_argument("--iters", type=int, default=16, metavar="I",
                    help="timed calls of the step modes (>= 1)")
    ap.add_argument("--window", type=int, default=20)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--scale", type=int, default=200)
    ap.add_argument("--genomes", type=int, default=128,
                    help="G for --mode allpairs and e2e")
    ap.add_argument("--seeds", type=int, default=8,
                    help="S for --mode multiseed")
    ap.add_argument("--segment-nt", type=int, default=1 << 24,
                    help="streaming segment size for --mode stream")
    ap.add_argument("--batch", type=int, default=8,
                    help="genomes per step in --mode sketch")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the gates against the native pipeline")
    engine = ap.add_mutually_exclusive_group()
    engine.add_argument("--probe", action="store_true",
                        help="allpairs: the binary-search probe "
                             "(ops/intersect.all_pairs_matrix)")
    engine.add_argument("--blocked", action="store_true",
                        help="allpairs: the block-cache schedule "
                             "(parallel/allpairs.blocked_all_pairs)")
    engine.add_argument("--ondevice", action="store_true",
                        help="allpairs: the on-device Gram "
                             "(ops/gram.gram_all_pairs_ondevice), also the "
                             "default")
    ap.add_argument("--block-size", type=int, default=BLOCK,
                    help=f"genomes per block (--blocked, e2e); the port's "
                         f"schedule fixes it at {BLOCK}")
    ap.add_argument("--pair-batch", type=int, default=None,
                    help="not supported: the port's tile sweep has no "
                         "pair batches")
    ap.add_argument("--e2e-source", choices=("files", "codes", "device"),
                    default="codes",
                    help="e2e genomes: FASTA files written to disk (the "
                         "whole ingest path), host RNG codes, or genomes "
                         "drawn on the device (no ingest)")
    ap.add_argument("--e2e-repeat", type=int, default=1,
                    help="runs of the e2e flow in one process; the last is "
                         "reported")
    ap.add_argument("--e2e-mesh", action="store_true",
                    help="e2e: MeshDevicePipeline over every local device "
                         "(one block a device a dispatch) in place of "
                         "DevicePipeline")
    ap.add_argument("--dispatch", type=int, default=128,
                    help="genomes per sketch dispatch in --mode e2e")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be >= 1")
    if args.block_size != BLOCK:
        ap.error(f"--block-size: the port's schedule fixes the block at "
                 f"{BLOCK} (parallel/allpairs.BLOCK)")
    if args.pair_batch is not None:
        ap.error("--pair-batch: the port's tile sweep has no pair batches "
                 "(parallel/allpairs.mesh_tile_sweep)")
    return args


# --- device, timing, output -------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _power_limit_w() -> Optional[float]:
    """The card's power limit, from nvidia-smi (None where it reads none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()[0]
        return float(out.rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def time_calls(step: Callable, dev: torch.device, iters: int):
    """One untimed warm-up call, `iters` calls each timed on the host clock
    up to a synchronize, then (on the card) CUDA events around `iters`
    calls with no host sync between them.  Returns (the warm-up's output,
    the last output, the timing fields)."""
    first = step()
    _sync(dev)
    walls = []
    out = first
    for _ in range(iters):
        t0 = time.perf_counter()
        out = step()
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    events_ms = None
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = step()
        end.record()
        end.synchronize()
        events_ms = start.elapsed_time(end) / iters
    return first, out, {"step_ms": float(np.median(walls)),
                        "step_ms_min": min(walls), "step_ms_max": max(walls),
                        "events_ms": events_ms, "iters": iters}


def emit(result: dict, dev: torch.device, build_s: Optional[float],
         verified: Optional[bool]) -> int:
    """Print the mode's JSON line (last line of stdout); 1 when its gate
    failed."""
    if dev.type == "cuda":
        fields = {"platform": "gpu", "device": torch.cuda.get_device_name(dev),
                  "power_limit_w": _power_limit_w(),
                  "peak_hbm_bytes": torch.cuda.max_memory_allocated(dev)}
    else:
        result["metric"] = "cpu_" + result["metric"]
        fields = {"platform": "cpu", "device": platform.machine() or "cpu",
                  "power_limit_w": None, "peak_hbm_bytes": None}
    launches = {k: kern.launches for k, kern in build.KERNELS.items()
                if kern.launches}
    result.update(fields, build_s=build_s, launches=launches,
                  verified=verified)
    print(json.dumps(result), flush=True)
    return 0 if verified in (True, None) else 1


def _fail(what: str) -> bool:
    print(f"VERIFY FAIL {what}", file=sys.stderr)
    return False


def _u64(keys: np.ndarray) -> np.ndarray:
    """(c, 4) uint32 key words -> (c, 2) uint64 [lo, hi] (the native
    layout)."""
    k = keys.astype(np.uint64)
    return np.ascontiguousarray(np.stack(
        [k[:, 0] | (k[:, 1] << np.uint64(32)),
         k[:, 2] | (k[:, 3] << np.uint64(32))], axis=1))


def _first_mismatch(got: np.ndarray, ref: np.ndarray):
    n = min(got.shape[0], ref.shape[0])
    bad = np.nonzero((got[:n] != ref[:n]).any(1))[0]
    return int(bad[0]) if bad.size else f"len {got.shape[0]} vs {ref.shape[0]}"


def _route(nw: int, scale: int, capacity: int, g: int) -> str:
    """The finish route an nw-window extract of g rows takes."""
    k_slots = _k_slots_for(nw, scale, capacity)
    return finish_route(out_rows(nw) * k_slots, nw, k_slots, capacity, scale,
                        g)


def _capacity(n: int, scale: int) -> int:
    return 1 << max(10, (max(1, 2 * n // scale)).bit_length())


def _check_capacity(raw_kept: torch.Tensor, capacity: int) -> None:
    raw = int(raw_kept.max())
    if raw > capacity:
        raise RuntimeError(f"sketch overflow: raw kept {raw} > capacity "
                           f"{capacity}")


def _check_sketches(keys: np.ndarray, counts: np.ndarray, refs, what: str
                    ) -> bool:
    """Each row's keys (G, cap, 4) uint32 against the native (c, 2) u64."""
    ok = True
    for i, ref in enumerate(refs):
        c = int(counts[i])
        got = _u64(keys[i, :c])
        if c != ref.shape[0] or not np.array_equal(got, ref):
            ok = _fail(f"{what} {i}: device count {c} vs native "
                       f"{ref.shape[0]}; first mismatch at "
                       f"{_first_mismatch(got, ref)}")
    return ok


# --- modes -----------------------------------------------------------------

def bench_sketch(args, dev: torch.device, build_s=None) -> int:
    """The sketch step over a (G, n) batch packed and uploaded once."""
    window, k, scale = args.window, args.k, args.scale
    n, g = args.nt, args.batch
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (g, n)).astype(np.uint8)
    capacity = _capacity(n, scale)
    packed = np.stack([pack2bit(row, -(-n // 16)) for row in codes])
    packed_d = torch.from_numpy(packed.view(np.int32)).to(dev)
    rid_d = torch.zeros((g, n), dtype=torch.int32, device=dev)

    def step():
        return sketch_batch_packed(packed_d, rid_d, mask.words_u32, salt,
                                   window=window, scale=scale,
                                   variant="modern", capacity=capacity)

    _, out, timing = time_calls(step, dev, args.iters)
    _check_capacity(out.raw_kept, capacity)
    windows = g * (n - window + 1)
    rate = windows / (timing["step_ms"] / 1e3)
    keys = out.keys.cpu().numpy().view(np.uint32)
    counts = out.count.cpu().numpy()

    # native baselines: one genome on one thread, the batch on every core
    # (the reference is parallel over files, kmer_set.cpp:124)
    cpu_rate = cpu_mt_rate = None
    nthreads = os.cpu_count() or 1
    one_run = np.array([n], dtype=np.int64)
    if native.available():
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            native.sketch_codes(codes[0], one_run, mask.lo, mask.hi, window,
                                salt, scale, False)
        cpu_rate = (n - window + 1) * reps / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        native.sketch_batch_mt(codes, mask.lo, mask.hi, window, salt, scale,
                               False, nthreads)
        cpu_mt_rate = windows / (time.perf_counter() - t0)

    # gate: every genome's keys, and an intersection tile by the probe on
    # the device, against the native pipeline and native merges
    verified = None
    if native.available() and not args.no_verify:
        refs = [native.sketch_codes(c, one_run, mask.lo, mask.hi, window,
                                    salt, scale, False) for c in codes]
        verified = _check_sketches(keys, counts, refs, "genome")
        t = min(g, 4)
        tile = intersection_tile(out.keys[:t], out.count[:t], out.keys[:t],
                                 out.count[:t]).cpu().numpy()
        for i in range(t):
            for j in range(t):
                want = native.intersect_sorted(refs[i], refs[j])
                if int(tile[i, j]) != want:
                    verified = _fail(f"intersect ({i},{j}): device "
                                     f"{int(tile[i, j])} vs native {want}")

    result = {
        "metric": "spaced_kmers_per_s", "value": rate, "unit": "windows/s",
        "vs_baseline": rate / cpu_rate if cpu_rate else None,
        "baseline_cpu_scalar_windows_per_s": cpu_rate,
        "vs_host_mt": rate / cpu_mt_rate if cpu_mt_rate else None,
        "baseline_cpu_host_windows_per_s": cpu_mt_rate,
        "host_threads": nthreads,
        "nt": n, "batch": g, "window": window, "k": k, "scale": scale,
        "capacity": capacity,
        "finish_route": _route(n - window + 1, scale, capacity, g),
        "sketch_count": int(counts[0]), **timing}
    return emit(result, dev, build_s, verified)


def synthetic_sketches(g: int, cap: int, window: int):
    """G sorted-unique sketches of `cap` keys sharing a common core (60%
    from a pool of 2 cap keys, 40% private), keys of 2 window bits like
    real masked canonical keys: the repository bench's all-pairs data
    (bench.py:325-345), from the same generator calls.  Returns (keys (G,
    cap, 4) uint32 all-ones padded, counts (G,) int32)."""
    rng = np.random.default_rng(0)
    kbits = min(62, 2 * window)
    pool = np.unique(rng.integers(0, 1 << kbits,
                                  size=2 * cap).astype(np.uint64))
    keys = np.full((g, cap, 4), 0xFFFFFFFF, dtype=np.uint32)
    counts = np.zeros((g,), np.int32)
    for i in range(g):
        shared = rng.choice(pool, size=int(cap * 0.6), replace=False)
        priv = rng.integers(0, 1 << kbits,
                            size=cap - shared.size).astype(np.uint64)
        u = np.unique(np.concatenate([shared, priv]))
        counts[i] = u.size
        keys[i, :u.size, 0] = (u & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :u.size, 1] = (u >> 32).astype(np.uint32)
        keys[i, :u.size, 2] = 0
        keys[i, :u.size, 3] = 0
    return keys, counts


def bench_allpairs(args, dev: torch.device, build_s=None,
                   cap: int = SYNTH_CAP) -> int:
    """The (G, G) intersection matrix of G synthetic sketches by one
    engine.  The gate: the full matrix against native merges, or for
    --blocked 256 sampled pairs and the diagonal."""
    g = args.genomes
    keys_np, counts_np = synthetic_sketches(g, cap, args.window)
    keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
    counts = torch.from_numpy(counts_np).to(dev)
    key_bits = 2 * args.window
    if args.probe:
        engine = "probe"

        def step():
            return all_pairs_matrix(keys, counts, row_tile=min(g, 8))
    elif args.blocked:
        engine = "blocked"

        def step():
            return blocked_all_pairs(keys, key_bits=key_bits)
    else:
        engine = "ondevice"

        def step():
            return gram_all_pairs_ondevice(keys, key_bits=key_bits)

    first, out, timing = time_calls(step, dev, args.iters)
    mat = np.asarray(torch.as_tensor(out).cpu()).astype(np.int64)
    pairs = g * g
    rate = pairs / (timing["step_ms"] / 1e3)
    u64s = [_u64(keys_np[i, :counts_np[i]]) for i in range(g)]

    verified = None
    if native.available() and not args.no_verify:
        verified = True
        if not np.array_equal(np.asarray(torch.as_tensor(first).cpu()), mat):
            verified = _fail(f"{engine}: the warm-up's matrix != the last "
                             "call's")
        if engine == "blocked":
            sample = np.random.default_rng(1).integers(0, g, size=(256, 2))
        else:
            sample = [(i, j) for i in range(g) for j in range(g)]
        for i, j in sample:
            want = native.intersect_sorted(u64s[i], u64s[j])
            if int(mat[i, j]) != want:
                verified = _fail(f"{engine} ({i},{j}): device "
                                 f"{int(mat[i, j])} vs native {want}")
                break
        if not np.array_equal(np.diag(mat), counts_np.astype(np.int64)):
            verified = _fail(f"{engine}: diagonal != sketch sizes")

    cpu_rate = None
    if native.available():
        s = min(g, 16)
        t0 = time.perf_counter()
        for i in range(s):
            for j in range(s):
                native.intersect_sorted(u64s[i], u64s[j])
        cpu_rate = s * s / (time.perf_counter() - t0)

    result = {
        "metric": ("ani_pairs_per_s_blocked" if engine == "blocked"
                   else "ani_pairs_per_s"),
        "value": rate, "unit": "pairs/s", "engine": engine,
        "vs_baseline": rate / cpu_rate if cpu_rate else None,
        "baseline_cpu_scalar_pairs_per_s": cpu_rate,
        "genomes": g, "sketch_cap": cap,
        "block": BLOCK if engine == "blocked" else None, **timing}
    return emit(result, dev, build_s, verified)


def bench_multiseed(args, dev: torch.device, build_s=None) -> int:
    """S spaced seeds over one genome in one step (BASELINE config 3): the
    genome's compact upload once, then sketch_batch_compact with (S, 4)
    masks and S salts a call, as sketch_packed_multiseed runs it."""
    window, k, scale, s, n = (args.window, args.k, args.scale, args.seeds,
                              args.nt)
    masks = [spaced_seed_mask(window, k, seed) for seed in range(s)]
    salts = [boosthash.fmh_salt(m.lo, m.hi, window, 1, "modern")
             for m in masks]
    masks_np = np.stack([m.words_u32 for m in masks])
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    capacity = _capacity(n, scale)
    sk = FracMinHashSketcher(SketchConfig(window=window, k=k, scale=scale),
                             device=dev)
    nb, up = sk._compact_upload(codes, np.empty(0, np.int64), 0)

    def step():
        return sketch_batch_compact(*up, masks_np, salts, n=nb,
                                    window=window, scale=scale,
                                    variant="modern", capacity=capacity)

    _, out, timing = time_calls(step, dev, args.iters)
    _check_capacity(out.raw_kept, capacity)
    window_seeds = s * (n - window + 1)
    rate = window_seeds / (timing["step_ms"] / 1e3)
    one_run = np.array([n], dtype=np.int64)

    cpu_rate = None
    refs = []
    if native.available():
        t0 = time.perf_counter()
        refs = [native.sketch_codes(codes, one_run, m.lo, m.hi, window, sv,
                                    scale, False)
                for m, sv in zip(masks, salts)]
        cpu_rate = window_seeds / (time.perf_counter() - t0)

    verified = None
    if native.available() and not args.no_verify:
        verified = _check_sketches(out.keys.cpu().numpy().view(np.uint32),
                                   out.count.cpu().numpy(), refs, "seed")

    result = {
        "metric": "multiseed_window_seeds_per_s", "value": rate,
        "unit": "window-seeds/s",
        "vs_baseline": rate / cpu_rate if cpu_rate else None,
        "baseline_cpu_scalar_window_seeds_per_s": cpu_rate,
        "nt": n, "bucket_nt": nb, "seeds": s, "window": window, "k": k,
        "scale": scale, "capacity": capacity,
        "finish_route": _route(nb - window + 1, scale, capacity, s),
        **timing}
    return emit(result, dev, build_s, verified)


def bench_stream(args, dev: torch.device, build_s=None) -> int:
    """Bounded-memory whole-file sketch of one long genome (BASELINE config
    5): a synthetic --nt FASTA (seed 0, lines of 2^22) through
    sketch_file_streaming twice, cold then warm; the warm pass is the rate.
    The gate: the sketch against the native whole-genome pipeline."""
    window, k, scale, n = args.window, args.k, args.scale, args.nt
    line = 1 << 22
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    fd, path = tempfile.mkstemp(suffix=".fa", prefix="sks_stream_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(b">stream_bench\n")
            for off in range(0, n, line):
                codes = rng.integers(0, 4, min(line, n - off)).astype(
                    np.uint8)
                f.write(lut[codes].tobytes())
                f.write(b"\n")

        sk = FracMinHashSketcher(SketchConfig(window=window, k=k,
                                              scale=scale), device=dev)
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.perf_counter()
        sk.sketch_file_streaming(path, segment_nt=args.segment_nt)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sketch = sk.sketch_file_streaming(path, segment_nt=args.segment_nt)
        wall = time.perf_counter() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    finally:
        os.unlink(path)
    rate = (n - window + 1) / wall

    cpu_rate = None
    verified = None
    if native.available() and not args.no_verify:
        rng2 = np.random.default_rng(0)
        codes = np.concatenate(
            [rng2.integers(0, 4, min(line, n - off)).astype(np.uint8)
             for off in range(0, n, line)])
        t0 = time.perf_counter()
        ref = native.sketch_codes(codes, np.array([n], np.int64),
                                  sk.mask.lo, sk.mask.hi, window, sk.salt,
                                  scale, False)
        cpu_rate = (n - window + 1) / (time.perf_counter() - t0)
        verified = _check_sketches(sketch.keys[None],
                                   np.array([sketch.count]), [ref], "stream")

    result = {
        "metric": "stream_nt_per_s", "value": rate, "unit": "nt/s",
        "vs_baseline": rate / cpu_rate if cpu_rate else None,
        "baseline_cpu_scalar_nt_per_s": cpu_rate,
        "nt": n, "segment_nt": args.segment_nt, "window": window, "k": k,
        "scale": scale, "sketch_count": int(sketch.count),
        "wall_s": wall, "cold_wall_s": cold_s,
        "peak_rss_gb": rss / 1e6, "peak_rss_before_gb": rss0 / 1e6}
    return emit(result, dev, build_s, verified)


def _device_codes(src, dispatch: int, g: int, n: int, i: int) -> np.ndarray:
    """Genome i's codes from a device source, drawn again as the pipeline
    drew its dispatch batch."""
    s0 = i // dispatch * dispatch
    words = src(s0, min(g, s0 + dispatch)).p[i - s0].cpu().numpy()
    shifts = 2 * np.arange(16, dtype=np.uint32)
    return ((words.view(np.uint32)[:, None] >> shifts) & 3).reshape(
        -1)[:n].astype(np.uint8)


def bench_e2e(args, dev: torch.device, build_s=None) -> int:
    """Genomes -> (G, G) intersections in one flow with device-resident
    sketches (pipeline.DevicePipeline, BASELINE config 4).  The gate, on up
    to 8 sampled genomes: their sketches against the native pipeline (on
    the codes drawn again for the device source), their pairs against
    native merges, and the diagonal against the counts."""
    g, n = args.genomes, args.nt
    cfg = SketchConfig(window=args.window, k=args.k, scale=args.scale)
    sk = FracMinHashSketcher(cfg, device=dev)
    if args.e2e_mesh:
        mesh = make_mesh(devices=None if dev.type == "cuda" else [dev])
        pipe = MeshDevicePipeline(sk, mesh)
    else:
        pipe = DevicePipeline(sk, dispatch=args.dispatch)
    rngv = np.random.default_rng(1)
    verify_ids = [] if args.no_verify else sorted(set(
        int(x) for x in rngv.integers(0, g, size=min(8, g))))

    tmpdir = None
    paths = []
    try:
        if args.e2e_source == "files":
            tmpdir = tempfile.mkdtemp(prefix="sks_e2e_")
            lut = np.frombuffer(b"ACGT", dtype=np.uint8)
            host_src = codes_source(g, n, seed=0)
            for i in range(g):
                pk = host_src(i, i + 1)[0]
                p = os.path.join(tmpdir, f"g{i:05d}.fa")
                with open(p, "wb") as f:
                    f.write(f">g{i}\n".encode())
                    f.write(lut[pk.codes].tobytes())
                    f.write(b"\n")
                paths.append(p)
            src = file_source(paths)
            nominal = max(os.path.getsize(p) for p in paths)
        elif args.e2e_source == "codes":
            src = codes_source(g, n, seed=0)
            nominal = n
        else:
            src = device_source(g, n, seed=0, device=dev)
            nominal = n

        for _ in range(max(1, args.e2e_repeat)):
            restarts0 = pipe.restarts
            res = pipe.all_pairs(src, g, nominal, verify_ids=verify_ids)
        restarts = pipe.restarts - restarts0
        wall = res.phases["total_s"]

        verified = None
        if verify_ids and native.available():
            verified = True
            for i in verify_ids:
                if args.e2e_source == "files":
                    pk = read_fasta(paths[i])
                    codes, runs = pk.codes, pk.run_lens.astype(np.int64)
                elif args.e2e_source == "codes":
                    codes = src(i, i + 1)[0].codes
                    runs = np.array([n], np.int64)
                else:
                    codes = _device_codes(src, pipe.dispatch, g, n, i)
                    runs = np.array([n], np.int64)
                ref = native.sketch_codes(
                    codes, runs, sk.mask.lo, sk.mask.hi, cfg.window, sk.salt,
                    cfg.scale, cfg.hash_variant == "legacy")
                got = res.sample_keys[i]
                if got.shape != ref.shape or not np.array_equal(got, ref):
                    verified = _fail(f"e2e sketch {i}: {got.shape[0]} keys "
                                     f"vs native {ref.shape[0]}")
            for i in verify_ids:
                for j in verify_ids:
                    want = native.intersect_sorted(res.sample_keys[i],
                                                   res.sample_keys[j])
                    if int(res.inter[i, j]) != want:
                        verified = _fail(f"e2e pair ({i},{j}): "
                                         f"{int(res.inter[i, j])} vs native "
                                         f"{want}")
            if not np.array_equal(np.diag(res.inter), res.counts):
                verified = _fail("e2e: diagonal != sketch sizes")
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)

    cpu_rate = None
    if native.available() and res.sample_keys:
        keys = list(res.sample_keys.values())
        t0 = time.perf_counter()
        for a in keys:
            for b in keys:
                native.intersect_sorted(a, b)
        cpu_rate = len(keys) ** 2 / (time.perf_counter() - t0)

    rate = g * g / wall
    result = {
        "metric": "e2e_ani_pairs_per_s", "value": rate, "unit": "pairs/s",
        "vs_baseline": rate / cpu_rate if cpu_rate else None,
        "baseline_cpu_scalar_pairs_per_s": cpu_rate,
        "source": args.e2e_source, "genomes": g, "nt": n,
        "window": args.window, "k": args.k, "scale": args.scale,
        "block": BLOCK, "dispatch": pipe.dispatch,
        "mesh": list(pipe.mesh.shape) if args.e2e_mesh else None,
        "sketch_cap": res.cache_cap, "wall_s": wall, "phases": res.phases,
        "bytes_h2d": int(res.bytes_h2d), "bytes_d2h": int(res.bytes_d2h),
        "restarts": restarts, "e2e_repeat": max(1, args.e2e_repeat)}
    return emit(result, dev, build_s, verified)


BENCHES = {"sketch": bench_sketch, "allpairs": bench_allpairs,
           "multiseed": bench_multiseed, "stream": bench_stream,
           "e2e": bench_e2e}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    hostmem.tune()
    build_s = None
    build.reset_launches()
    if dev.type == "cuda":
        # the kernel library (nvcc at first use) and the native library
        # load before anything is timed
        t0 = time.perf_counter()
        build.lib()
        native.available()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
    return BENCHES[args.mode](args, dev, build_s)


if __name__ == "__main__":
    sys.exit(main())
