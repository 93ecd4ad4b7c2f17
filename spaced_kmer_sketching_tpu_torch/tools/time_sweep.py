#!/usr/bin/env python3
"""Time the CLI's sketching on the 62-config sweep and on BASELINE config
2, optionally beside a second checkout of the repository (a parent
commit), on one GPU.

Data are written once from --seed as chip_smoke.py writes them (2 FASTAs
of 4-6 Mnt with N-runs, genome 1 a 3%-substituted copy of genome 0; 100
related FASTAs of config 2).  Each turn is a process of its own that runs
the CLI (`driver.main`, --device cuda) three times: config 1 (w=20, k=16)
on the 2 genomes as a warm-up, the 62-config sweep on them, then config 2
(w=20, k=16).  It prints one JSON line: the summed "Time taken for
sketching" of the sweep and of config 2.  Turns: with --parent DIR (a
checkout of another commit, e.g. unpacked by `git archive`), the parent,
this checkout twice, the parent; else this checkout twice.  Every turn
must write the first turn's CSV bytes.  Run from the repository root:

    python3 spaced_kmer_sketching_tpu_torch/tools/time_sweep.py [--parent DIR]

It prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]


def sketching_ms(argv) -> float:
    """driver.main on argv; the summed "Time taken for sketching" ms."""
    from spaced_kmer_sketching_tpu_torch import driver
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(argv)
    if rc != 0:
        raise RuntimeError(f"driver.main returned {rc}")
    return sum(float(m.group(1)) for m in re.finditer(
        r"Time taken for sketching = (\S+) ms", buf.getvalue()))


def run_turn(repo: str, data: pathlib.Path, tag: str) -> dict:
    """One turn in this process, with the package of checkout `repo`."""
    sys.path.insert(0, repo)
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    build.build()
    build.lib()
    genomes = sorted(str(p) for p in (data / "sweep").glob("*.fa"))
    config2 = sorted(str(p) for p in (data / "config2").glob("*.fa"))
    out = {"repo": repo}
    sketching_ms([str(data / f"warm_{tag}.csv"), *genomes, "--window", "20",
                  "--k", "16", "--device", "cuda"])
    for name, argv in (
            ("sweep", [str(data / f"sweep_{tag}.csv"), *genomes]),
            ("config2", [str(data / f"config2_{tag}.csv"), *config2,
                         "--window", "20", "--k", "16"])):
        out[f"{name}_sketching_ms"] = sketching_ms([*argv, "--device",
                                                    "cuda"])
    return out


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of another commit")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--turn", nargs=3, metavar=("REPO", "DATA", "TAG"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.turn:
        repo, data, tag = args.turn
        print(json.dumps(run_turn(repo, pathlib.Path(data), tag)))
        return 0

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_sweep: no CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    cs = load_chip_smoke()
    here = str(ROOT)
    turns = [here, here]
    if args.parent:
        parent = str(pathlib.Path(args.parent).resolve())
        turns = [parent, *turns, parent]
    build_dir = ROOT / "spaced_kmer_sketching_tpu_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        data = pathlib.Path(tmp)
        rng = np.random.default_rng(args.seed)
        for sub in ("sweep", "config2"):
            (data / sub).mkdir()
        cs.write_genomes(data / "sweep", rng, 2)
        cs.write_collection(data / "config2", rng)
        lines = []
        for i, repo in enumerate(turns):
            proc = subprocess.run(
                [sys.executable, __file__, "--turn", repo, tmp, str(i)],
                capture_output=True, text=True, cwd=repo)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(lines[-1]), flush=True)
        for name in ("sweep", "config2"):
            want = (data / f"{name}_0.csv").read_bytes()
            for i in range(1, len(turns)):
                if (data / f"{name}_{i}.csv").read_bytes() != want:
                    print(f"time_sweep: turn {i}'s {name} CSV != turn 0's",
                          file=sys.stderr)
                    return 1
    print(f"every turn wrote the first turn's sweep and config 2 CSV bytes; "
          f"{smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
