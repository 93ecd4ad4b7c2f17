"""The port's MeshDevicePipeline, the driver's --mesh, the bench's
--e2e-mesh and the dry run, against the JAX package on the 8 virtual CPU
devices of tests/conftest.py, the port's single-device paths and the JAX
CLI's CSV bytes.

The port runs on CPU slots, where every kernel wrapper takes its plain
PyTorch version; the JAX MeshDevicePipeline runs its portable CPU path.
Inputs are made from a seed with numpy.  Tolerance 0: counts,
intersections and keys are integers, CSVs are compared byte for byte.
"""
import json

import numpy as np
import pytest
import torch

import jax

from spaced_kmer_sketching_tpu import driver as jax_driver
from spaced_kmer_sketching_tpu import pipeline as jax_pipeline
from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher)
from spaced_kmer_sketching_tpu.parallel.mesh import make_mesh as jax_make_mesh

from spaced_kmer_sketching_tpu_torch import bench, driver, observability
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.dryrun import dryrun_multichip
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.parallel import distributed
from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
from spaced_kmer_sketching_tpu_torch.parallel.sketcher import MeshSketcher
from spaced_kmer_sketching_tpu_torch.pipeline import (
    DevicePipeline, MeshDevicePipeline, all_pairs_from_files, codes_source,
    device_source)
from spaced_kmer_sketching_tpu_torch.utils import native

from oracle import random_genome
from test_torch_mesh import one_torch_thread  # noqa: F401
from test_driver import write_fasta


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.inter, np.asarray(want.inter))


def test_mesh_pipeline_matches_jax_mesh_pipeline():
    """100 genomes over two distinct devices (a cache each; one dispatch:
    slot 0 a ragged block, slot 1 padding) == the JAX MeshDevicePipeline's
    portable path on one device and the port's DevicePipeline: counts,
    matrix and sample keys."""
    g, n = 100, 1400
    cfg = dict(window=14, k=10, scale=4)
    sk = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    pipe = MeshDevicePipeline(sk, make_mesh(devices=["cpu", "cpu:0"]))
    assert pipe.dispatch == 256
    ids = [0, 57, 99]
    res = pipe.all_pairs(codes_source(g, n, seed=3), g, n, verify_ids=ids)
    want = jax_pipeline.MeshDevicePipeline(
        JaxSketcher(JaxConfig(**cfg)), jax_make_mesh(
            devices=jax.devices()[:1])).all_pairs(
        jax_pipeline.codes_source(g, n, seed=3), g, n, verify_ids=ids)
    assert_same_result(res, want)
    single = DevicePipeline(sk).all_pairs(codes_source(g, n, seed=3), g, n,
                                          verify_ids=ids)
    assert_same_result(res, single)
    for i in ids:
        np.testing.assert_array_equal(res.sample_keys[i],
                                      np.asarray(want.sample_keys[i]))
        np.testing.assert_array_equal(res.sample_keys[i],
                                      single.sample_keys[i])
    assert res.cache_cap == want.cache_cap == single.cache_cap
    assert res.bytes_h2d > 0 and pipe.restarts == 0
    assert set(res.phases) >= {"ingest_s", "sketch_s", "presort_s",
                               "allpairs_s", "ingest_work_s", "overlap_eff",
                               "total_s"}


def test_mesh_pipeline_device_source_and_overflow_restart():
    """Device-drawn genomes on a 1 x 1 mesh (one ragged dispatch) with a
    sketch_capacity that overflows: the overflowing genomes are sketched
    again in the pass (no whole-run restart), the result equals the
    uncapped run's; sampled sketches equal the native pipeline on the
    codes drawn again, their pairs native merges, the matrix is symmetric
    with the counts on its diagonal."""
    g, n = 100, 3000
    sk = FracMinHashSketcher(SketchConfig(window=16, k=12, scale=6,
                                          sketch_capacity=256), device="cpu")
    pipe = MeshDevicePipeline(sk, make_mesh(devices=["cpu"]))
    src = device_source(g, n, seed=2, device="cpu")
    ids = [0, 57, 99]
    before = observability.counters().get("pipeline_sketch_redos", 0)
    res = pipe.all_pairs(src, g, n, verify_ids=ids)
    redos = observability.counters()["pipeline_sketch_redos"] - before
    assert pipe.restarts == 0 and redos > 0 and int(res.counts.max()) > 256
    assert res.phases["restart_s"] == 0.0 and res.phases["redo_s"] > 0
    assert res.bytes_h2d == 0
    uncapped = MeshDevicePipeline(FracMinHashSketcher(
        SketchConfig(window=16, k=12, scale=6), device="cpu"),
        make_mesh(devices=["cpu"])).all_pairs(src, g, n, verify_ids=ids)
    assert_same_result(res, uncapped)
    for i in ids:
        np.testing.assert_array_equal(res.sample_keys[i],
                                      uncapped.sample_keys[i])
    np.testing.assert_array_equal(res.inter, res.inter.T)
    np.testing.assert_array_equal(np.diag(res.inter), res.counts)
    if not native.available():
        return
    shifts = 2 * np.arange(16, dtype=np.uint32)
    want = {}
    for i in ids:
        s0 = i // pipe.dispatch * pipe.dispatch
        words = src(s0, min(g, s0 + pipe.dispatch)).p[i - s0].numpy() \
            .view(np.uint32)
        codes = ((words[:, None] >> shifts) & 3).reshape(-1)[:n]
        want[i] = native.sketch_codes(codes.astype(np.uint8), np.array([n]),
                                      sk.mask.lo, sk.mask.hi, 16, sk.salt, 6,
                                      False)
        np.testing.assert_array_equal(res.sample_keys[i], want[i])
    for i in ids:
        for j in ids:
            assert res.inter[i, j] == (want[i].shape[0] if i == j else
                                       native.intersect_sorted(want[i],
                                                               want[j]))


def test_mesh_pipeline_is_single_process(monkeypatch):
    monkeypatch.setattr("spaced_kmer_sketching_tpu_torch.pipeline.world_size",
                        lambda: 2)
    sk = FracMinHashSketcher(SketchConfig(window=14, k=10), device="cpu")
    with pytest.raises(ValueError, match="one process"):
        MeshDevicePipeline(sk, make_mesh(devices=["cpu"] * 2))


@pytest.fixture
def genomes(tmp_path):
    rng = np.random.default_rng(17)
    base = random_genome(rng, 2500)
    paths = []
    for i in range(5):
        g = [int(c) if rng.random() > 0.03 * i else int(rng.integers(0, 4))
             for c in base]
        paths.append(write_fasta(tmp_path / f"g{i}.fa",
                                 [g[:1800 + 100 * i], g[2000:]]))
    return paths


def test_driver_mesh_csv_is_jax_mesh_csv(genomes, tmp_path, monkeypatch):
    """driver --mesh 2x4 --device cpu writes the JAX driver's --mesh 2x4
    CSV and the port's single-device CSV byte for byte; routed through the
    MeshDevicePipeline (on 1 x 1, one 128-genome dispatch), the same
    bytes."""
    args = [*genomes, "--window", "12", "--k", "8", "--scale", "5"]
    want = tmp_path / "jax.csv"
    assert jax_driver.main([str(want), *args, "--mesh", "2x4"]) == 0
    single = tmp_path / "single.csv"
    assert driver.main([str(single), *args, "--device", "cpu"]) == 0
    got = tmp_path / "mesh.csv"
    assert driver.main([str(got), *args, "--device", "cpu",
                        "--mesh", "2x4"]) == 0
    assert got.read_bytes() == want.read_bytes() == single.read_bytes()
    meshes = []
    orig = all_pairs_from_files
    monkeypatch.setattr(driver, "_use_device_pipeline",
                        lambda sk, f, pairing, store: True)
    monkeypatch.setattr(driver, "all_pairs_from_files",
                        lambda sk, paths, mesh=None: (
                            meshes.append(mesh.shape),
                            orig(sk, paths, mesh=mesh))[1])
    routed = tmp_path / "routed.csv"
    assert driver.main([str(routed), *args, "--device", "cpu",
                        "--mesh", "1x1"]) == 0
    assert meshes == [(1, 1)]
    assert routed.read_bytes() == want.read_bytes()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):   # --device cuda
        driver.main([str(tmp_path / "gpu.csv"), *args, "--mesh", "auto"])


def test_pipeline_routing_of_a_mesh_sketcher(monkeypatch, tmp_path):
    """A mesh sketcher on a GPU takes the pipeline under the size rule in
    one process, never in a multi-rank job."""
    paths = []
    for i in range(513):
        p = tmp_path / f"c{i}.fa"
        p.write_text(">c\n" + "ACGT" * 100 + "\n")
        paths.append(str(p))
    sk = MeshSketcher(SketchConfig(window=14, k=10),
                      make_mesh(devices=["cpu"] * 2))
    monkeypatch.setattr(sk, "device", torch.device("cuda", 0))
    assert driver._use_device_pipeline(sk, paths, "all", None)
    monkeypatch.setattr(driver, "world_size", lambda: 2)
    assert not driver._use_device_pipeline(sk, paths, "all", None)


def test_bench_e2e_mesh_line(capsys):
    """--mode e2e --e2e-mesh on the CPU: a verified line from a 1 x 1
    mesh, one block a dispatch, against the native pipeline."""
    rc = bench.main(["--device", "cpu", "--mode", "e2e", "--genomes", "12",
                     "--nt", "6000", "--e2e-mesh", "--e2e-source", "device"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["verified"] is True
    assert line["mesh"] == [1, 1] and line["dispatch"] == 128
    assert line["metric"] == "cpu_e2e_ani_pairs_per_s"


def test_dryrun_multichip_on_cpu_slots():
    """The dry run: the CLI with --mesh auto and --mesh 2x4 against the
    single-device CSV, the ring against sketch_core, the compact ring
    against the ring, on 8 CPU slots."""
    assert distributed.world_size() == 1
    dryrun_multichip(8)
