"""The port's bench (spaced_kmer_sketching_tpu_torch/bench.py) on the CPU.

Every mode and every all-pairs engine runs in-process with `--device cpu`
(the kernels' plain versions) at tiny sizes and must print a verified last
line under a `cpu_` metric, with none of the JAX bench's TPU fields.  The
repository's JAX `bench.py` runs at the same arguments in subprocesses on
the CPU backend, and the two lines must give the same sketch counts and
cache width.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TPU_FIELDS = ("roofline_frac_vpu", "mfu_mxu", "mfu_mxu_allpairs",
              "transport_frac_est", "steps_per_dispatch")
# (label, arguments both benches take, the key whose value they share)
CROSS = {
    "sketch": (["--mode", "sketch", "--nt", "65536", "--batch", "2"],
               "sketch_count"),
    "stream": (["--mode", "stream", "--nt", "200000", "--segment-nt",
                "65536"], "sketch_count"),
    "e2e": (["--mode", "e2e", "--e2e-source", "codes", "--genomes", "16",
             "--nt", "50000", "--dispatch", "8"], "sketch_cap"),
}


def last_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def check_line(line: dict) -> None:
    assert line["verified"] is True
    assert line["metric"].startswith("cpu_")
    assert line["platform"] == "cpu" and line["power_limit_w"] is None
    assert line["launches"] == {}           # plain versions only
    assert not set(TPU_FIELDS) & set(line)
    assert line["value"] > 0


@pytest.fixture(autouse=True)
def no_malloc_tuning(monkeypatch):
    """bench.main tunes the process's allocator (utils/hostmem.tune); the
    test process keeps its own."""
    calls = []
    monkeypatch.setattr(bench.hostmem, "tune", lambda: calls.append(1))
    return calls


@pytest.fixture(scope="module")
def jax_lines():
    """The JAX bench's lines at CROSS's arguments, the three subprocesses
    run at once."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {k: subprocess.Popen(
        [sys.executable, "bench.py", "--platform", "cpu", "--iters", "1",
         *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, (argv, _) in CROSS.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-2000:]
        out[k] = last_line(stdout)
    return out


@pytest.mark.parametrize("mode", sorted(CROSS))
def test_mode_matches_the_jax_bench(mode, jax_lines, capsys,
                                    no_malloc_tuning):
    argv, key = CROSS[mode]
    assert bench.main([*argv, "--device", "cpu", "--iters", "1"]) == 0
    assert no_malloc_tuning == [1]
    line = last_line(capsys.readouterr().out)
    check_line(line)
    assert jax_lines[mode]["verified"] is True
    assert line[key] == jax_lines[mode][key]


@pytest.mark.parametrize("argv", [
    ["--mode", "multiseed", "--nt", "40000", "--seeds", "3"],
    ["--mode", "e2e", "--e2e-source", "files", "--genomes", "4", "--nt",
     "20000", "--dispatch", "4"],
    ["--mode", "e2e", "--e2e-source", "device", "--genomes", "6", "--nt",
     "20000", "--dispatch", "4", "--e2e-repeat", "2"],
], ids=["multiseed", "e2e-files", "e2e-device"])
def test_other_modes_are_verified(argv, capsys):
    assert bench.main([*argv, "--device", "cpu", "--iters", "1"]) == 0
    line = last_line(capsys.readouterr().out)
    check_line(line)
    if line["metric"] == "cpu_e2e_ani_pairs_per_s":
        assert line["restarts"] == 0 and line["source"] in argv


@pytest.mark.parametrize("engine,g,cap", [
    ("--probe", 16, 256), ("--ondevice", 16, 256), (None, 16, 256),
    ("--blocked", 16, 256), ("--blocked", 256, 128)])
def test_allpairs_engines_are_verified(engine, g, cap, capsys):
    """Each engine at a small capacity (the mode's `cap` keyword; the CLI
    keeps 8,192); blocked at G = 256 runs two blocks and three tiles."""
    argv = ["--device", "cpu", "--mode", "allpairs", "--iters", "1",
            "--genomes", str(g)] + ([engine] if engine else [])
    assert bench.bench_allpairs(bench.parse_args(argv), CPU, cap=cap) == 0
    line = last_line(capsys.readouterr().out)
    check_line(line)
    assert line["engine"] == (engine or "--ondevice")[2:]
    assert line["sketch_cap"] == cap and line["genomes"] == g


def jax_bench_sketches(g, cap, window):
    """bench.py:325-345 restated (the JAX bench's synthetic all-pairs
    sketches), with cap as a parameter."""
    rng = np.random.default_rng(0)
    kbits = min(62, 2 * window)
    pool = np.unique(rng.integers(0, 1 << kbits,
                                  size=2 * cap).astype(np.uint64))
    keys_np = np.full((g, cap, 4), 0xFFFFFFFF, dtype=np.uint32)
    counts_np = np.zeros((g,), np.int32)
    for i in range(g):
        shared = rng.choice(pool, size=int(cap * 0.6), replace=False)
        priv = rng.integers(0, 1 << kbits,
                            size=cap - shared.size).astype(np.uint64)
        u = np.unique(np.concatenate([shared, priv]))
        counts_np[i] = u.size
        keys_np[i, :u.size, 0] = (u & 0xFFFFFFFF).astype(np.uint32)
        keys_np[i, :u.size, 1] = (u >> 32).astype(np.uint32)
        keys_np[i, :u.size, 2] = 0
        keys_np[i, :u.size, 3] = 0
    return keys_np, counts_np


@pytest.mark.parametrize("g,cap,window", [(6, 8192, 20), (4, 256, 31)])
def test_synthetic_sketches_equal_the_jax_bench(g, cap, window):
    keys, counts = bench.synthetic_sketches(g, cap, window)
    want_keys, want_counts = jax_bench_sketches(g, cap, window)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("argv,what", [
    (["--block-size", "256"], "block"),
    (["--pair-batch", "8"], "pair batches"),
    (["--iters", "0"], "iters"),
])
def test_unsupported_flags_exit(argv, what, capsys):
    with pytest.raises(SystemExit) as e:
        bench.parse_args(argv)
    assert e.value.code == 2 and what in capsys.readouterr().err


def test_bench_imports_no_jax():
    code = ("import sys, spaced_kmer_sketching_tpu_torch.bench; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "False"


def test_cuda_without_gpu_exits_nonzero():
    """The default device is cuda; with no GPU the bench fails and prints
    no line (it never carries on on the CPU)."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from spaced_kmer_sketching_tpu_torch import bench; "
            "sys.exit(bench.main(['--mode', 'sketch', '--nt', '4096']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT)
    assert out.returncode != 0 and "cuda" in out.stderr
    assert out.stdout.strip() == ""


def test_no_tpu_constants_in_the_bench():
    src = pathlib.Path(bench.__file__).read_text()
    for word in ("PINNED", "197e12", "3.85e12", "roofline_frac_vpu",
                 "mfu_mxu", "110e6"):
        assert word not in src


def test_native_batch_baseline_counts():
    """native.sketch_batch_mt (the sketch mode's whole-host baseline)
    counts each genome's sketch as the scalar pipeline does."""
    from spaced_kmer_sketching_tpu_torch.utils import boosthash, native
    from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask
    if not native.available():
        pytest.skip("needs the native library (g++)")
    mask = spaced_seed_mask(20, 16, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, 20, 1, "modern")
    codes = np.random.default_rng(2).integers(0, 4, (3, 30000)).astype(
        np.uint8)
    got = native.sketch_batch_mt(codes, mask.lo, mask.hi, 20, salt, 50,
                                 False, 2)
    want = [native.sketch_codes(c, np.array([30000]), mask.lo, mask.hi, 20,
                                salt, 50, False).shape[0] for c in codes]
    np.testing.assert_array_equal(got, want)
