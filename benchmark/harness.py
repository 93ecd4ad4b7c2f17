"""The benchmark's harness: finds a cell's configuration, traffic and
metrics by name, sets up, runs a closed loop for the window, checks what
the window produced against the plain reference, and prints the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name BENCHMARK.json gives it:

    <bench>/configs/<config>.json      sizes and guarantees of a deployment
    <bench>/traffic/<traffic>.json     the loop: "operation" names a module
                                       of <bench>/operations/, the rest its
                                       parameters ("genomes" updates the
                                       configuration's genome spec)
    <bench>/metrics/<metric>.py        read(run) -> a number, or None where
                                       the run has nothing for it to read

An operation is a class `Operation(cell, seed, device)` with `setup()`
(inputs and warm-up, counted in setup_s), `job()` (one timed unit; returns
a record dict, its results on the host), `release()` (after the window:
keep what the check needs, free the device), `check(records)` (the
comparison with the reference: a list of Check) and `close()`.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spaced_kmer_sketching_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct only where value <= limit.  `parts` splits the value by what
    it counts."""
    name: str
    value: float
    limit: float
    parts: Optional[Dict[str, float]] = None

    def as_dict(self) -> dict:
        d = {"value": self.value, "limit": self.limit}
        return d if self.parts is None else {**d, "parts": self.parts}

    def line(self) -> str:
        parts = "" if self.parts is None else " [" + ", ".join(
            f"{k} {v}" for k, v in self.parts.items()) + "]"
        return f"check {self.name} = {self.value} (limit {self.limit}){parts}"

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: pathlib.Path

    @property
    def genomes(self) -> dict:
        """The configuration's genome spec, updated by the traffic's."""
        return {**self.config.get("genomes", {}),
                **self.traffic.get("genomes", {})}


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    seed: int
    setup_s: float
    window: tuple                 # (start, end of the last job), host clock
    records: List[dict]           # one a job, in order
    counters: Dict[str, int]      # the program's counters, window's change
    trace: object = None          # trace.Trace (--trace 1)
    device_kind: str = ""


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, root: pathlib.Path = ROOT,
              bench: pathlib.Path = BENCH) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer, bench=bench)


def load_metric(bench: pathlib.Path, name: str):
    """The reader of metric `name`: <bench>/metrics/<name>.py's read."""
    path = bench / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = load_metric(run.cell.bench, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def operation(cell: Cell, seed: int, device):
    mod = importlib.import_module(
        f"benchmark.operations.{cell.traffic['operation']}")
    return mod.Operation(cell, seed, device)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load (whole names: the program's own name begins with one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def host_info() -> dict:
    """The host the run had: its CPUs and those the run could use."""
    return {"cpus": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0))
            if hasattr(os, "sched_getaffinity") else None}


def fix_cache_dirs(root: pathlib.Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the program builds its own kernel
    library under its _build directory, also inside the checkout)."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_process: float, device: str = "cuda", control: bool = False,
             host: Optional[dict] = None, root: pathlib.Path = ROOT,
             bench: pathlib.Path = BENCH) -> tuple:
    """One run of cell `name`: (result dict, list of Check).  The caller
    has checked for the card; `t_process` is the process's start on the
    host clock.  With `control`, the result also holds the checks of the
    operation's control: the reference in the program's place at a lower
    precision, or with a guarantee broken, compared in the same way."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.utils import hostmem

    from . import trace as trace_mod

    cell = load_cell(name, root, bench)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    op = operation(cell, seed, dev)
    records: List[dict] = []
    failed = 0
    checks: List[Check] = []
    try:
        hostmem.tune()        # as the program's command line does at start
        op.setup()
        if cuda:
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_process

        before = observability.counters()
        prof = None
        if trace:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        with record_function(trace_mod.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                r0 = time.perf_counter()
                try:
                    rec = op.job()
                except Exception:
                    traceback.print_exc()
                    failed += 1
                    break
                r1 = time.perf_counter()
                rec.update(t0=r0, t1=r1, wall_s=r1 - r0)
                records.append(rec)
                if r1 - t0 >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize(dev)
        traced = None
        if prof is not None:
            prof.stop()
            traced = trace_mod.from_profiler(prof)
            del prof
        after = observability.counters()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        op.release()
        run = Run(cell=cell, seed=seed, setup_s=setup_s,
                  window=(t0, records[-1]["t1"] if records else t0),
                  records=records,
                  counters={k: after.get(k, 0) - before.get(k, 0)
                            for k in set(after) | set(before)},
                  trace=traced,
                  device_kind=torch.cuda.get_device_name(dev) if cuda
                  else "cpu")
        metrics = read_metrics(run, cell.per_layer if trace
                               else cell.end_to_end)
        checks = op.check(records) if records else []
        controls = op.control(records) if control and records else None
    finally:
        op.close()
    correct = (bool(records) and failed == 0 and bool(checks)
               and all(c.ok for c in checks))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": run.device_kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power"] = power_limit()
    result = {"correct": correct, "attempted": len(records) + failed,
              "failed": failed, "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = trace_mod.busy_s(traced)
        device_info["window_s"] = traced.window_s
        result["breakdown"] = trace_mod.breakdown(traced)
    if host is not None:
        result["host"] = host
    if controls is not None:
        result["control"] = {c.name: c.as_dict() for c in controls}
    result["checks"] = {c.name: c.as_dict() for c in checks}
    return result, checks


def main(argv, t_process: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fix_cache_dirs(ROOT)
    import torch
    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_process=t_process,
                              host=host_info())
    bad = forbidden_modules()
    if bad:
        print("the run loaded forbidden modules: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
