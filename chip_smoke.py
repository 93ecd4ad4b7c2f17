#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and exits non-zero, printing no result, when no
CUDA GPU is usable or the port's package is not beside it.  Phases:
  1. build the Hopper kernels (csrc/*.cu) with nvcc;
  2. hold each kernel K1-K4 against its plain PyTorch version on the GPU,
     bit for bit, at the main path's shapes (n = 8,388,608 windows for kw
     = 1..4; the compaction stages the planner gives; the sort at 65,536
     keys, G = 2), and time both with CUDA events;
  3. write synthetic FASTAs from --seed (8 genomes of 4-6 Mnt with a few
     records and N-runs, genome 1 a 3%-mutated copy of genome 0) and run
     the CLI (`driver.main --window 20 --k 16 --device cuda`) on all 8, then
     on genomes 0 and 1 alone (BASELINE config 1, twice: cold and warm);
  4. run the CLI's 62-config reference sweep on genomes 0 and 1.
Every sketch of phases 3-4 must equal the native C++ scalar pipeline's
(native/sketchlib.cpp) and every CSV value the host math on those sketches.
The kernels' launch counters are reset before phase 3 and must all be
positive after phase 4.

Output: the card's name and power limit, a JSON line of per-kernel results
({"kernels": [...]}), and as the LAST line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
TOLERANCE = 0        # integer keys and counts: every comparison is exact
GENOMES = 8          # phase 3: the most the port's all-pairs takes (G <= 8)


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs, as integers."""
    err = 0
    for a, b in zip(got, want):
        need(a.shape == b.shape and a.dtype == b.dtype,
             f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# --- phase 2: each kernel against its plain version -------------------------

def phase_kernels(dev, rng, timer, n=8388608, length=5_000_000):
    """K1-K4 against their plain versions at the main path's shapes: n
    windows of a `length`-nt genome in three runs (G = 2), config 1's
    capacity and scale.  Returns per-kernel max_abs_err and times."""
    import torch

    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.ops import sketch as sk
    from spaced_kmer_sketching_tpu_torch.ops.cuda import compact, extract, sort
    from spaced_kmer_sketching_tpu_torch.utils import boosthash
    from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

    g, scale = 2, 200
    codes = rng.integers(0, 4, (g, n)).astype(np.uint8)
    rid = np.full((g, n), -1, np.int32)
    cut = length // 5 * 2
    rid[:, :cut] = 0                             # three runs, then padding
    rid[:, cut + 50:2 * cut] = 1
    rid[:, 2 * cut + 100:length] = 2
    packed = torch.from_numpy(extract.pack2bit_rows(codes).view(np.int32)
                              ).to(dev)
    run_id = torch.from_numpy(rid).to(dev)
    capacity = SketchConfig(window=20, k=16).capacity_for(length)
    res = {}

    # K1 at every key-word bucket; timed at kw = 2 (config 1's w = 20)
    err = 0
    for window, k in ((16, 12), (20, 16), (40, 30), (50, 40)):
        mask = spaced_seed_mask(window, k, 0)
        salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
        kw = sk.finish_words(window)
        nw = n - (16 * (kw - 1) + 1) + 1
        k_slots = sk._k_slots_for(nw, scale, capacity)
        args = dict(window=window, nw=nw, scale=scale, variant="modern",
                    k_slots=k_slots, out_words=kw)

        def kern():
            return extract.extract_compact(packed, run_id, mask.words_u32,
                                           salt, **args)

        def plain():
            return extract.extract_compact_plain(packed, run_id,
                                                 mask.words_u32, salt, **args)
        got, want = kern(), plain()
        err = max(err, max_abs_err(got, want))
        print(f"K1 w={window} kw={kw} k_slots={k_slots} "
              f"planes={tuple(got[0].shape)} kept={int(got[1].sum())} "
              f"max_abs_err={max_abs_err(got, want)}")
        if kw == 2:
            res["K1"] = dict(ms=timer(kern, 20), plain_ms=timer(plain, 3))
            k1_planes, k1_slots = got[0], k_slots
    res["K1"]["max_abs_err"] = err

    # K2 on the planner's chain over the real K1 output (kw = 2)
    kw, _, m = k1_planes.shape
    stages = sk._tree_chain(m, 128.0 / k1_slots, scale, capacity, g)
    need(bool(stages), f"no compaction chain planned for m={m}")
    planes, err = k1_planes, 0
    for si, (srows, k_out) in enumerate(stages):
        x = planes.reshape(kw, g, srows, 128)
        last = si == len(stages) - 1
        got = compact.compact_rows(x, k_out, with_counts=last)
        want = compact.compact_rows_plain(x, k_out, with_counts=last)
        e = max_abs_err([t for t in got if t is not None],
                        [t for t in want if t is not None])
        err = max(err, e)
        print(f"K2 stage {si}: rows={srows} k_out={k_out} max_abs_err={e}")
        if si == 0:
            res["K2"] = dict(
                ms=timer(lambda: compact.compact_rows(x, k_out), 20),
                plain_ms=timer(lambda: compact.compact_rows_plain(x, k_out),
                                 5))
        planes = got[0].reshape(kw, g, srows * k_out)
    res["K2"]["max_abs_err"] = err

    # K3 at the finish's two sizes: the padded chain output, the capacity
    mp = 1 << (max(planes.shape[2], capacity) - 1).bit_length()
    chain_out = sk._pad_to(planes, mp)
    got = compact.compact_global(chain_out)
    err = max_abs_err([got], [compact.compact_global_plain(chain_out)])
    holed = sort.sort_rows(got[:, :, :capacity].contiguous())
    holed[:, :, ::5] = -1
    err = max(err, max_abs_err([compact.compact_global(holed)],
                               [compact.compact_global_plain(holed)]))
    print(f"K3 n={mp} and n={capacity}: max_abs_err={err}")
    res["K3"] = dict(
        max_abs_err=err,
        ms=timer(lambda: compact.compact_global(chain_out), 20),
        plain_ms=timer(lambda: compact.compact_global_plain(chain_out), 5))

    # K4 at 65,536 keys, G = 2, kw = 1..4, with duplicates and sentinels
    err = 0
    for kw in (1, 2, 3, 4):
        z = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, 2, 65536),
                          dtype=torch.int32, device=dev)
        z[:, :, ::3] = z[:, :, 1:2]
        z[:, :, -1000:] = -1
        e = max_abs_err([sort.sort_rows(z)], [sort.sort_rows_plain(z)])
        err = max(err, e)
        print(f"K4 kw={kw} n=65536 G=2 max_abs_err={e}")
        if kw == 2:
            res["K4"] = dict(ms=timer(lambda: sort.sort_rows(z), 20),
                             plain_ms=timer(lambda: sort.sort_rows_plain(z),
                                              5))
    res["K4"]["max_abs_err"] = err
    for name, r in res.items():
        need(r["max_abs_err"] <= TOLERANCE,
             f"{name} disagrees with its plain version: {r}")
    return res


# --- phase 3-4 data and checks ------------------------------------------------

def write_genomes(dirpath: pathlib.Path, rng, count: int,
                  nt=(4_000_000, 6_000_000)):
    """FASTAs of nt[0]..nt[1] nucleotides: a few records each, N-runs
    inside; genome 1 is a 3%-substituted copy of genome 0."""
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    base = None
    paths = []
    for i in range(count):
        length = int(rng.integers(nt[0], nt[1] + 1))
        if i == 1:
            codes = base.copy()
            hit = rng.random(codes.size) < 0.03
            codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        else:
            codes = rng.integers(0, 4, length).astype(np.uint8)
        if i == 0:
            base = codes
        text = alphabet[codes]
        for start in rng.integers(0, text.size - 200, 3):
            text[start:start + int(rng.integers(10, 100))] = ord("N")
        cuts = np.sort(rng.integers(1, text.size, 2))
        path = dirpath / f"genome{i}.fa"
        with open(path, "wb") as f:
            for r, rec in enumerate(np.split(text, cuts)):
                f.write(f">genome{i}_record{r}\n".encode())
                lines = [rec[j:j + 80].tobytes()
                         for j in range(0, rec.size, 80)]
                f.write(b"\n".join(lines) + b"\n")
        paths.append(str(path))
    return paths


def record_sketches():
    """Capture every sketch list the CLI's sketcher returns."""
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher)
    captured = []
    orig = FracMinHashSketcher.sketch_files

    def recording(self, paths, *a, **kw):
        out = orig(self, paths, *a, **kw)
        captured.append((self, list(paths), out))
        return out
    FracMinHashSketcher.sketch_files = recording
    return captured


def run_cli(argv):
    """driver.main on argv; returns (stdout lines, sketching ms, comparison
    ms) with the timings summed over the run's experiments."""
    from spaced_kmer_sketching_tpu_torch import driver
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(argv)
    need(rc == 0, f"driver.main returned {rc}")
    lines = buf.getvalue().splitlines()
    ms = {"sketching": 0.0, "comparison": 0.0}
    for line in lines:
        m = re.fullmatch(r"Time taken for (sketching|comparison) = (\S+) ms",
                         line)
        need(m is not None, f"unexpected driver output {line!r}")
        ms[m.group(1)] += float(m.group(2))
    return lines, ms["sketching"], ms["comparison"]


def check_experiment(sketcher, paths, sketches, csv_rows, parsed):
    """Sketches equal the native scalar pipeline; CSV rows equal the host
    math on them.  `parsed` caches read_fasta per path."""
    from spaced_kmer_sketching_tpu_torch.ani import (binomial_estimator,
                                                     containment)
    from spaced_kmer_sketching_tpu_torch.csvout import format_double
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    from spaced_kmer_sketching_tpu_torch.utils import native

    cfg, mask = sketcher.config, sketcher.mask
    u64 = []
    for p, s in zip(paths, sketches):
        if p not in parsed:
            parsed[p] = read_fasta(p)
        pk = parsed[p]
        want = native.sketch_codes(pk.codes, pk.run_lens, mask.lo, mask.hi,
                                   cfg.window, sketcher.salt, cfg.scale,
                                   cfg.hash_variant == "legacy")
        got = s.keys_u64()
        need(s.count > 0 and np.array_equal(got, want),
             f"w={cfg.window} k={cfg.k} {p}: sketch of {s.count} keys != "
             f"native scalar pipeline's {want.shape[0]}")
        u64.append(want)
    g = len(paths)
    need(len(csv_rows) == g * g, f"{len(csv_rows)} CSV rows for {g} genomes")
    for i in range(g):
        for j in range(g):
            inter = (sketches[i].count if i == j
                     else native.intersect_sorted(u64[i], u64[j]))
            ani = binomial_estimator(containment(inter, sketches[i].count),
                                     mask.care_positions)
            want_row = (f"{paths[i]},{paths[j]},{format_double(float(ani))},"
                        f"{cfg.window},{mask.bitstring()}")
            need(csv_rows[i * g + j] == want_row,
                 f"CSV row {i * g + j}: {csv_rows[i * g + j]!r} != "
                 f"{want_row!r}")
            need(np.isfinite(ani) and 0 <= ani <= 1, f"ANI {ani}")


def run_main_path(paths, tmp: pathlib.Path, device: str) -> dict:
    """Phases 3-4 through the CLI, then their checks.  Returns the config-1
    timings and the kernels' launch counts of the CLI runs alone."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    captured = record_sketches()
    build.reset_launches()
    t0 = time.perf_counter()
    out3 = tmp / "config_w20_k16.csv"
    _, s_ms, c_ms = run_cli([str(out3), *paths, "--window", "20", "--k", "16",
                             "--device", device])
    print(f"phase 3: {len(paths)} genomes w=20 k=16: sketching {s_ms} ms, "
          f"comparison {c_ms} ms")
    cfg1 = []
    for rep in ("cold", "warm"):
        lines, s_ms, c_ms = run_cli([str(tmp / f"cfg1_{rep}.csv"), *paths[:2],
                                     "--window", "20", "--k", "16",
                                     "--device", device])
        cfg1.append((s_ms, c_ms))
        print(f"phase 3: config 1 ({rep}): " + " | ".join(lines))
    t3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    out4 = tmp / "sweep.csv"
    _, s_ms, c_ms = run_cli([str(out4), *paths[:2], "--device", device])
    t4 = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    print(f"phase 4: 62-config sweep on 2 genomes: {t4:.3f} s wall, "
          f"sketching {s_ms} ms, comparison {c_ms} ms in total")
    print(f"main path (phases 3-4, {t3 + t4:.3f} s): launches "
          + json.dumps(launches))

    # checks (no kernel runs here)
    t0 = time.perf_counter()
    parsed = {}
    csv3 = out3.read_text().splitlines()
    need(csv3[0] == "File 1,File 2,Estimated Value,Window Size,Mask",
         "CSV header")
    sk3, p3, sketches3 = captured[0]
    check_experiment(sk3, p3, sketches3, csv3[1:], parsed)
    ani01 = float(csv3[2].split(",")[2])
    need(0.9 < ani01 < 1.0, f"ANI of the 3%-mutated copy: {ani01}")
    for (skc, pc, sc), rep in zip(captured[1:3], ("cold", "warm")):
        rows = (tmp / f"cfg1_{rep}.csv").read_text().splitlines()[1:]
        check_experiment(skc, pc, sc, rows, parsed)
    csv4 = out4.read_text().splitlines()
    need(len(csv4) == 1 + 62 * 4, f"sweep CSV has {len(csv4)} lines")
    sweep = captured[3:]
    need(len(sweep) == 62, f"{len(sweep)} sweep experiments")
    buckets = set()
    for e, (skc, pc, sc) in enumerate(sweep):
        check_experiment(skc, pc, sc, csv4[1 + 4 * e:5 + 4 * e], parsed)
        buckets.add((2 * skc.config.window + 31) // 32)
    need(buckets == {1, 2, 3, 4}, f"key-word buckets {buckets}")
    print(f"checks: {len(captured)} experiments equal the native scalar "
          f"pipeline and the host ANI math (kw buckets {sorted(buckets)}) in "
          f"{time.perf_counter() - t0:.3f} s; ANI(genome0, genome1) = {ani01}")
    return {"launches": launches, "config1_warm": cfg1[1]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    from spaced_kmer_sketching_tpu_torch.utils import native
    from spaced_kmer_sketching_tpu_torch.utils.native import BUILD_DIR

    rng = np.random.default_rng(args.seed)

    # phase 1: build
    t0 = time.perf_counter()
    so = build.build()
    build.lib()
    need(native.available(), "native/sketchlib.cpp did not build")
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.3f} s "
          f"({so.name})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    kres = phase_kernels(torch.device("cuda", 0), rng, time_ms)
    print(f"phase 2: K1-K4 bit-exact vs plain in "
          f"{time.perf_counter() - t0:.3f} s")

    # phases 3-4: the main path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        paths = write_genomes(pathlib.Path(tmp), rng, GENOMES)
        print(f"data: {GENOMES} FASTAs written in "
              f"{time.perf_counter() - t0:.3f} s")
        run = run_main_path(paths, pathlib.Path(tmp), "cuda")
    for key, n_launch in run["launches"].items():
        need(n_launch > 0, f"{key} was not launched by the main path")

    kernels = []
    for key, kern in build.KERNELS.items():
        r = kres[key]
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": kern.source, "replaces": kern.replaces,
                        "launches": run["launches"][key],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    s_ms, c_ms = run["config1_warm"]
    print(f"config 1 (2 genomes, w=20, k=16, warm): sketching {s_ms} ms, "
          f"comparison {c_ms} ms; {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
