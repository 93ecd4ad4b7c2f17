"""Two real processes over torch.distributed (gloo) running the port's
driver with --mesh, and the kernel wrappers' device guard.

The two workers run `python -m spaced_kmer_sketching_tpu_torch.driver ...
--mesh auto|2x4 --device cpu` with torchrun's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK); both CSVs must be byte-identical to the
JAX package's single-process run_experiment on the five uneven FASTAs of
tests/test_distributed_multiprocess.py.  The test skips only where
localhost sockets cannot bind, as that test does.

A CUDA launch goes to the calling thread's current device, so every
kernel wrapper (ops/cuda/{extract,compact,sort,gram_tiles,tight}.py) must
launch through build.launch, which makes the tensor's device current.
One GPU cannot show the fault, and the CPU has none; the check runs each
wrapper on meta tensors against a stand-in library that records the
device made current at each launch.
"""
import ast
import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.driver import run_experiment

from spaced_kmer_sketching_tpu_torch.ops.cuda import (build, compact, extract,
                                                      gram_tiles, sort, tight)

from test_distributed_multiprocess import K, SCALE, WINDOW, _write_fastas
from test_torch_mesh import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


# the CLI with MeshSketcher's streaming threshold set first (argv[1])
BOOT = ("import sys\n"
        "from spaced_kmer_sketching_tpu_torch.parallel.sketcher import "
        "MeshSketcher\n"
        "MeshSketcher._STREAM_THRESHOLD_BYTES = int(sys.argv[1])\n"
        "from spaced_kmer_sketching_tpu_torch import driver\n"
        "sys.exit(driver.main(sys.argv[2:]))\n")


@pytest.mark.parametrize("mesh,ring", [("auto", None), ("2x4", None),
                                       ("auto", 4500)])
def test_two_gloo_ranks_write_the_single_process_csv(tmp_path, mesh, ring):
    """Rank r owns slot r (auto) or slots 4r..4r+3 (2x4) and parses only
    the genomes they hold; both ranks write the JAX single-process CSV.
    With the streaming threshold at 4,500 bytes, six of eight files stream
    over the ring of both ranks (every rank parses them) and the rest keep
    their rows of the sharded batch, one on each rank."""
    try:
        port = _free_port()
    except OSError:
        pytest.skip("cannot bind localhost sockets in this environment")
    paths = _write_fastas(tmp_path)
    if ring:
        rng = np.random.default_rng(8)
        for i, n in enumerate((1500, 6000, 3000)):
            p = tmp_path / f"x{i}.fa"
            p.write_bytes(b">x\n" + np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, n)].tobytes() + b"\n")
            paths.append(str(p))
    want = tmp_path / "ref.csv"
    run_experiment(WINDOW, K, paths, str(want), False,
                   config=JaxConfig(window=WINDOW, k=K, scale=SCALE),
                   echo_timings=False)
    outs = [tmp_path / f"rank{r}.csv" for r in range(2)]
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), OMP_NUM_THREADS="1")
        cli = ["-c", BOOT, str(ring)] if ring else \
            ["-m", "spaced_kmer_sketching_tpu_torch.driver"]
        procs.append(subprocess.Popen(
            [sys.executable, *cli, str(outs[r]), *paths, "--window",
             str(WINDOW), "--k", str(K), "--scale", str(SCALE), "--device",
             "cpu", "--mesh", mesh],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        assert out.count("Time taken for") == 2
    for r in range(2):
        assert outs[r].read_bytes() == want.read_bytes(), f"rank {r}"


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, imported in a fresh process, loads no jax;
    no line of the port or of chip_smoke.py imports jax or the JAX
    package."""
    code = ("import importlib, pkgutil, sys, spaced_kmer_sketching_tpu_torch "
            "as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('jax' in sys.modules, "
            "'spaced_kmer_sketching_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]
    # \b after "tpu" does not match before "_torch"
    bad = re.compile(r"^\s*(import jax|from jax|(import|from) "
                     r"spaced_kmer_sketching_tpu\b)")
    files = [ROOT / "chip_smoke.py",
             *(ROOT / "spaced_kmer_sketching_tpu_torch").rglob("*.py")]
    for f in files:
        if "_build" in f.parts:          # build outputs, not the package
            continue
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not bad.match(line), f"{f}:{n}: {line}"


# --- the device guard --------------------------------------------------------

WRAPPER_MODULES = (extract, compact, sort, gram_tiles, tight)


def test_every_launch_goes_through_build_launch():
    """No wrapper calls a C entry that launches (every sks_* but the
    *_scratch sizing calls, which allocate nothing) except through
    build.launch, and every build.launch names an sks_* entry."""
    for mod in WRAPPER_MODULES:
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            name = node.func.attr
            if name.startswith("sks_"):
                assert name.endswith("_scratch"), \
                    f"{mod.__name__}:{node.lineno} calls {name} directly"
            if name == "launch":
                entry = node.args[0]
                assert isinstance(entry, ast.Constant) and \
                    entry.value.startswith("sks_"), \
                    f"{mod.__name__}:{node.lineno}"


class _Guard:
    """Stands in for torch.cuda.device: records the device made current."""
    current = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _Guard.current.append(self.device)

    def __exit__(self, *exc):
        _Guard.current.pop()


class _Lib:
    """Stands in for the kernel library: sizing calls return 0, launches
    record (entry, the device current at the call) and return 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            if not name.endswith("_scratch"):
                self.calls.append((name, _Guard.current[-1]
                                   if _Guard.current else None))
            return 0
        return entry


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


MASK, SALT = [0xFFFFFFFF, 0xFF, 0, 0], 12345
WRAPPERS = {
    "sks_compact_rows": lambda: compact.compact_rows(_meta(2, 1, 4, 128), 8),
    "sks_compact_global": lambda: compact.compact_global(_meta(2, 2, 4096)),
    "sks_extract_compact": lambda: extract.extract_compact(
        _meta(1, 2048), _meta(1, 32768), MASK, SALT, window=20, nw=32000,
        scale=200, variant="modern", k_slots=8, out_words=2),
    "sks_extract_compact_raw": lambda: extract.extract_compact_raw(
        _meta(1, 2112), _meta(1, 8), _meta(1), _meta(1), MASK, SALT,
        window=20, nw=32000, scale=200, variant="modern", k_slots=8,
        out_words=2),
    "sks_extract_filter": lambda: extract.extract_filter(
        _meta(1, 4096, dtype=torch.uint8), _meta(1, 4096), MASK, SALT,
        window=20, scale=200, variant="modern"),
    "sks_sort_rows": lambda: sort.sort_rows(_meta(2, 1, 1 << 16)),
    "sks_merge_runs": lambda: sort.merge_sorted_runs(_meta(2, 64, 128), 16),
    "sks_merge_pair": lambda: sort.merge_pair_streams(
        _meta(2, 64, 128), _meta(2, 64, 128), b_gid_offset=128),
    "sks_sort_runs": lambda: sort.sort_runs(_meta(2, 8, 4096), 2048),
    "sks_sort_truncate": lambda: sort.sort_truncate(_meta(2, 1, 1 << 17),
                                                    2048),
    "sks_gram_tiles": lambda: gram_tiles.gram_tile_scan(
        _meta(2, 64, 128), 8, 256, split=128),
}


@pytest.mark.parametrize("entry", sorted(WRAPPERS))
def test_wrapper_launches_under_the_tensors_device(monkeypatch, entry):
    """Each wrapper, given tensors that do not lie on the CPU, launches its
    kernel only while their device is the current one."""
    lib = _Lib()
    monkeypatch.setattr(build, "lib", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    saved = {k: v.launches for k, v in build.KERNELS.items()}
    try:
        WRAPPERS[entry]()
    finally:
        for k, v in build.KERNELS.items():
            v.launches = saved[k]
    assert lib.calls and {name for name, _ in lib.calls} == {entry}
    assert all(dev == torch.device("meta") for _, dev in lib.calls)
