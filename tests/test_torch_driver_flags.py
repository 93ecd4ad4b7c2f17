"""The port CLI's `--pairing ring`, `--store` (with the sweep's pair-level
resume) and `--profile` against the JAX package's CLI: byte-identical
CSVs.

The port runs with `--device cpu` (the kernels' plain versions); the JAX
driver runs on the CPU backend.  FASTAs are made from a seed with numpy.
"""
import json
import types

import numpy as np
import torch

from spaced_kmer_sketching_tpu import driver as jax_driver
from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.store import SketchStore as JaxStore

from spaced_kmer_sketching_tpu_torch import driver
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.store import SketchStore

from test_driver import oracle_experiment, write_fasta
from oracle import mutate, random_genome


def ring_genomes(tmp_path):
    """test_driver.py::test_ring_pairing_mode's three genomes."""
    rng = np.random.default_rng(21)
    base = random_genome(rng, 2000)
    return [write_fasta(tmp_path / f"r{i}.fa", [g]) for i, g in enumerate(
        [base, mutate(rng, base, 0.04), random_genome(rng, 2000)])]


def test_ring_pairing_csv_is_the_jax_clis(tmp_path):
    paths = ring_genomes(tmp_path)
    args = ["--window", "12", "--k", "8", "--scale", "5", "--pairing", "ring"]
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_driver.main([str(want), *paths, *args]) == 0
    assert driver.main([str(got), *paths, *args, "--device", "cpu"]) == 0
    assert got.read_bytes() == want.read_bytes()
    lines = got.read_text().splitlines()
    assert len(lines) == 1 + 3           # ring: n pairs for n genomes
    assert lines[1].split(",")[:2] == [paths[0], paths[1]]
    assert lines[3].split(",")[:2] == [paths[2], paths[0]]
    full = oracle_experiment(paths, 12, 8, 5).reshape(3, 3)
    ani = driver.run_experiment(12, 8, paths, str(tmp_path / "o.csv"), False,
                                config=SketchConfig(window=12, k=8, scale=5),
                                echo_timings=False, device="cpu",
                                pairing="ring")
    np.testing.assert_array_equal(ani, [full[0, 1], full[1, 2], full[2, 0]])


def test_sweep_kill_and_resume_pair_level(tmp_path, monkeypatch):
    """test_driver.py::test_sweep_kill_and_resume_pair_level on the port:
    a sweep killed 4 rows into its third config and rerun with a store
    gives the uninterrupted run's bytes, which are the JAX sweep's; only
    the interrupted config sketches again."""
    sched = [(12, 8, False), (20, 20, True), (20, 10, True)]
    monkeypatch.setattr(driver, "reference_sweep_schedule", lambda: sched)
    monkeypatch.setattr(jax_driver, "reference_sweep_schedule", lambda: sched)
    rng = np.random.default_rng(7)
    paths = [write_fasta(tmp_path / f"g{i}.fa", [random_genome(rng, 1500)])
             for i in range(3)]

    want = tmp_path / "jax.csv"
    jax_driver.run_reference_sweep(str(want), paths,
                                   config=JaxConfig(window=12, k=8, scale=5),
                                   echo_timings=False,
                                   store=JaxStore(str(tmp_path / "stJ")))
    cfg = SketchConfig(window=12, k=8, scale=5)
    full = tmp_path / "full.csv"
    driver.run_reference_sweep(str(full), paths, config=cfg,
                               echo_timings=False, device="cpu",
                               store=SketchStore(str(tmp_path / "stA")))
    assert full.read_bytes() == want.read_bytes()
    lines = full.read_text().splitlines(keepends=True)
    rows_per_cfg = len(paths) ** 2
    assert len(lines) == 1 + len(sched) * rows_per_cfg

    resume = tmp_path / "resume.csv"
    resume.write_text("".join(lines[:1 + 2 * rows_per_cfg + 4]))
    sketched = []
    orig = FracMinHashSketcher.sketch_files
    monkeypatch.setattr(
        FracMinHashSketcher, "sketch_files",
        lambda self, ps, *a, **k: (sketched.extend(
            (self.config.window, self.config.k) for _ in ps),
            orig(self, ps, *a, **k))[1])
    driver.run_reference_sweep(str(resume), paths, config=cfg,
                               echo_timings=False, device="cpu",
                               store=SketchStore(str(tmp_path / "stB")))
    assert resume.read_bytes() == full.read_bytes()
    assert sketched == [(20, 10)] * len(paths)


def test_cli_store_rerun_sketches_nothing(tmp_path, monkeypatch):
    """`--store` through the CLI: the rerun reads every sketch back and
    writes the same bytes, which are the JAX CLI's."""
    paths = ring_genomes(tmp_path)
    args = ["--window", "12", "--k", "8", "--scale", "5"]
    want = tmp_path / "jax.csv"
    assert jax_driver.main([str(want), *paths, *args, "--store",
                            str(tmp_path / "stJ")]) == 0
    sketched = []
    orig = FracMinHashSketcher.sketch_files
    monkeypatch.setattr(FracMinHashSketcher, "sketch_files",
                        lambda self, ps, *a, **k: (sketched.extend(ps),
                                                   orig(self, ps, *a, **k))[1])
    for run in range(2):
        got = tmp_path / f"port{run}.csv"
        assert driver.main([str(got), *paths, *args, "--device", "cpu",
                            "--store", str(tmp_path / "st")]) == 0
        assert got.read_bytes() == want.read_bytes()
        assert sketched == paths
    assert (tmp_path / "st" / "index.json").exists()


def test_profile_writes_a_trace_and_the_same_csv(tmp_path):
    paths = ring_genomes(tmp_path)[:2]
    args = ["--window", "12", "--k", "8", "--scale", "5", "--device", "cpu"]
    plain, profiled = tmp_path / "plain.csv", tmp_path / "profiled.csv"
    assert driver.main([str(plain), *paths, *args]) == 0
    trace_dir = tmp_path / "trace"
    assert driver.main([str(profiled), *paths, *args, "--profile",
                        str(trace_dir)]) == 0
    assert profiled.read_bytes() == plain.read_bytes()
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_pipeline_gate_is_off_with_a_store_or_ring_pairing(tmp_path):
    paths = []
    for i in range(513):
        p = tmp_path / f"c{i}.fa"
        p.write_text(">c\n" + "ACGT" * 100 + "\n")
        paths.append(str(p))
    gpu = types.SimpleNamespace(device=torch.device("cuda"),
                                _STREAM_THRESHOLD_BYTES=1 << 28)
    assert driver._use_device_pipeline(gpu, paths, "all", None)
    assert not driver._use_device_pipeline(gpu, paths, "ring", None)
    assert not driver._use_device_pipeline(
        gpu, paths, "all", SketchStore(str(tmp_path / "st")))
