"""The port's one-flow device pipeline (pipeline.py, BASELINE config 4) and
the driver's routing to it, against the JAX package's pipeline on the same
inputs, the port's two-step path, a host merge and the JAX CLI's CSV bytes.

The port runs on the CPU, where every kernel wrapper takes its plain
PyTorch version.  Inputs are made from a seed with numpy.  Tolerance 0:
keys, counts and intersections are integers, the CSV is compared byte for
byte.  The JAX pipeline runs its portable CPU path.
"""
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu import driver as jax_driver
from spaced_kmer_sketching_tpu import pipeline as jax_pipeline
from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher)

from spaced_kmer_sketching_tpu_torch import driver, observability
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import packed_body
from spaced_kmer_sketching_tpu_torch.pipeline import (
    DevicePipeline, all_pairs_from_files, codes_source, device_source)
from spaced_kmer_sketching_tpu_torch.utils import native

from oracle import random_genome
from test_driver import write_fasta
from test_torch_mesh import one_torch_thread  # noqa: F401

SYNCS = "pipeline_host_syncs"
REDOS = "pipeline_sketch_redos"


def host_matrix(sketches):
    """Intersection counts by host set intersection (independent engine)."""
    sets = [set(map(tuple, s.keys_u64().tolist())) for s in sketches]
    return np.array([[len(a & b) for b in sets] for a in sets], np.int32)


def assert_same_result(got, want):
    """Counts and the whole matrix, tolerance 0."""
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.inter, np.asarray(want.inter))


def test_pipeline_matches_two_step_path(tmp_path):
    """all_pairs_from_files == the JAX all_pairs_from_files,
    sketch_files + all_pairs_intersections (counts and matrix) and a host
    merge, with a ragged tail dispatch and block."""
    rng = np.random.default_rng(11)
    paths = [write_fasta(tmp_path / f"g{i}.fa",
                         [random_genome(rng, 1400 + 37 * i)])
             for i in range(10)]
    sk = FracMinHashSketcher(SketchConfig(window=12, k=8, scale=5),
                             device="cpu")
    res = all_pairs_from_files(sk, paths, dispatch=4, verify_ids=[2, 9])
    assert_same_result(res, jax_pipeline.all_pairs_from_files(
        JaxSketcher(JaxConfig(window=12, k=8, scale=5)), paths, dispatch=4))
    sketches = sk.sketch_files(paths)
    np.testing.assert_array_equal(res.counts, [s.count for s in sketches])
    np.testing.assert_array_equal(res.inter,
                                  sk.all_pairs_intersections(sketches))
    np.testing.assert_array_equal(res.inter, host_matrix(sketches))
    for i in (2, 9):
        np.testing.assert_array_equal(res.sample_keys[i],
                                      sketches[i].keys_u64())
    assert res.phases["total_s"] > 0 and res.bytes_h2d > 0
    assert set(res.phases) >= {"ingest_s", "sketch_s", "presort_s",
                               "allpairs_s", "ingest_work_s", "overlap_eff"}


def test_pipeline_multirecord_and_non_acgt(tmp_path):
    """Run-split genomes (records, non-ACGT characters) flow through the
    bounds of the compact upload as through the JAX pipeline and as
    read_fasta + sketch_files."""
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        s1 = "".join("ACGT"[c] for c in random_genome(rng, 700))
        s2 = "".join("ACGT"[c] for c in random_genome(rng, 500))
        p = tmp_path / f"m{i}.fa"
        p.write_text(f">a{i}\n{s1[:300]}NN{s1[300:]}\n>b{i}\n{s2}\n")
        paths.append(str(p))
    sk = FracMinHashSketcher(SketchConfig(window=10, k=7, scale=3),
                             device="cpu")
    res = all_pairs_from_files(sk, paths, dispatch=2)
    assert_same_result(res, jax_pipeline.all_pairs_from_files(
        JaxSketcher(JaxConfig(window=10, k=7, scale=3)), paths, dispatch=2))
    sketches = sk.sketch_files(paths)
    np.testing.assert_array_equal(res.counts, [s.count for s in sketches])
    np.testing.assert_array_equal(res.inter, host_matrix(sketches))


def test_codes_source_and_verify_keys():
    """codes_source genomes: the result equals the JAX DevicePipeline's on
    the JAX codes_source, the sampled keys equal the genomes' sketches, the
    matrix is symmetric with the counts on its diagonal."""
    sk = FracMinHashSketcher(SketchConfig(window=14, k=10, scale=4),
                             device="cpu")
    g, n = 6, 2000
    src = codes_source(g, n, seed=3)
    res = DevicePipeline(sk, dispatch=2).all_pairs(src, g, n,
                                                   verify_ids=[0, 3, 5])
    want_jax = jax_pipeline.DevicePipeline(
        JaxSketcher(JaxConfig(window=14, k=10, scale=4)), dispatch=2
    ).all_pairs(jax_pipeline.codes_source(g, n, seed=3), g, n,
                verify_ids=[0, 3, 5])
    assert_same_result(res, want_jax)
    assert set(res.sample_keys) == {0, 3, 5}
    for i in (0, 3, 5):
        want = sk.sketch_packed(src(i, i + 1)[0])
        assert res.counts[i] == want.count
        np.testing.assert_array_equal(res.sample_keys[i], want.keys_u64())
        np.testing.assert_array_equal(res.sample_keys[i],
                                      np.asarray(want_jax.sample_keys[i]))
    np.testing.assert_array_equal(res.inter, res.inter.T)
    np.testing.assert_array_equal(np.diag(res.inter), res.counts)


def test_device_source_on_the_cpu():
    """device_source draws its genomes with a torch.Generator on the
    pipeline's device (here the CPU): symmetric, counts on the diagonal,
    and a sampled sketch equals the native sketch of the batch drawn
    again."""
    sk = FracMinHashSketcher(SketchConfig(window=16, k=12, scale=6),
                             device="cpu")
    g, n = 5, 3000
    src = device_source(g, n, seed=2, device="cpu")
    res = DevicePipeline(sk, dispatch=4).all_pairs(src, g, n,
                                                   verify_ids=[4])
    np.testing.assert_array_equal(res.inter, res.inter.T)
    np.testing.assert_array_equal(np.diag(res.inter), res.counts)
    assert (res.counts > 300).all() and res.bytes_h2d == 0
    words = src(4, 5).p[0].numpy().view(np.uint32)
    codes = ((words[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3)
    codes = codes.reshape(-1)[:n].astype(np.uint8)
    assert src(4, 5).p.shape[1] * 16 == packed_body(n)
    if native.available():
        want = native.sketch_codes(codes, np.array([n]), sk.mask.lo,
                                   sk.mask.hi, 16, sk.salt, 6, False)
        np.testing.assert_array_equal(res.sample_keys[4], want)


def test_pipeline_capacity_overflow_retry():
    """A tiny sketch_capacity overflows every genome: each is sketched
    again in its block at a larger capacity, with no whole-run restart
    (one attempt, restarts and restart_s 0, redo_s booked); the run
    equals the JAX pipeline's retried run and the uncapped one."""
    g, n = 6, 40_000
    runs, redos = [], []
    for cap in (256, 0):
        pipe = DevicePipeline(FracMinHashSketcher(
            SketchConfig(window=20, k=16, scale=20, sketch_capacity=cap),
            device="cpu"))
        before = observability.counters().get(REDOS, 0)
        runs.append(pipe.all_pairs(codes_source(g, n, seed=4), g, n))
        redos.append(observability.counters().get(REDOS, 0) - before)
        assert pipe.restarts == 0 and runs[-1].phases["restart_s"] == 0.0
    assert int(runs[0].counts.max()) > 256
    assert redos[0] > 0 and runs[0].phases["redo_s"] > 0
    assert redos[1] == 0 and runs[1].phases["redo_s"] == 0.0
    assert_same_result(runs[0], jax_pipeline.DevicePipeline(JaxSketcher(
        JaxConfig(window=20, k=16, scale=20, sketch_capacity=256))
    ).all_pairs(jax_pipeline.codes_source(g, n, seed=4), g, n))
    assert_same_result(runs[0], runs[1])


# a period-7 unit with one kept window among its 7 at (20, 16, scale 200):
# a stretch of it keeps ~18 windows in each 128-window row, past the 16
# slots a row has at that scale and capacity
UNIT7 = np.array([3, 2, 0, 1, 3, 2, 0], np.uint8)


def planted_source(packed_cls, g, n, planted, stretch=280):
    """Random genomes of n codes; genome `planted` holds `stretch` codes of
    UNIT7, a chance overflow of a row's slots (its raw kept count one
    above the capacity) while its sketch fits the capacity."""
    def load(s0, s1):
        out = []
        for i in range(s0, s1):
            codes = np.random.default_rng(1000 + i).integers(
                0, 4, n).astype(np.uint8)
            if i == planted:
                codes[5000:5000 + stretch] = np.resize(UNIT7, stretch)
            out.append(packed_cls(codes=codes,
                                  run_lens=np.array([n], np.int64)))
        return out
    return load


def test_pipeline_resketches_one_overflowing_genome():
    """One genome among 136 (two blocks) overflows a row's slots: that
    genome alone is sketched again (one re-sketch dispatch, its one read),
    every block is read once, and the matrix and counts equal the JAX
    pipeline's (which restarts the run); the genome's sampled keys equal
    its two-step sketch (the sketcher's own retry), JAX's and native."""
    from spaced_kmer_sketching_tpu.ingest.fasta import (
        PackedSeqs as JaxPackedSeqs)
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
    g, n, planted = 136, 20_000, 130
    ids = [3, planted, 135]
    cfg = dict(window=20, k=16, scale=200)
    sk = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    unit = sk.sketch_packed(PackedSeqs(codes=np.resize(UNIT7, 280),
                                       run_lens=np.array([280])))
    assert unit.count == 1
    src = planted_source(PackedSeqs, g, n, planted)
    pipe = DevicePipeline(sk, dispatch=32)
    before = observability.counters()
    res = pipe.all_pairs(src, g, n, verify_ids=ids)
    after = observability.counters()
    redos = after.get(REDOS, 0) - before.get(REDOS, 0)
    syncs = after[SYNCS] - before.get(SYNCS, 0)
    assert redos == 1 and pipe.restarts == 0
    # two block reads, the re-sketch's, three sampled genomes, the
    # download (no synchronize on the CPU)
    assert syncs == 2 + redos + len(ids) + 1
    assert res.phases["redo_s"] > 0 and res.phases["restart_s"] == 0.0
    want_jax = jax_pipeline.DevicePipeline(
        JaxSketcher(JaxConfig(**cfg)), dispatch=32).all_pairs(
        planted_source(JaxPackedSeqs, g, n, planted), g, n, verify_ids=ids)
    assert_same_result(res, want_jax)
    for i in ids:
        want = sk.sketch_packed(src(i, i + 1)[0])
        assert res.counts[i] == want.count
        np.testing.assert_array_equal(res.sample_keys[i], want.keys_u64())
        np.testing.assert_array_equal(res.sample_keys[i],
                                      np.asarray(want_jax.sample_keys[i]))
    if native.available():
        pk = src(planted, planted + 1)[0]
        np.testing.assert_array_equal(res.sample_keys[planted],
                                      native.sketch_codes(
                                          pk.codes, pk.run_lens, sk.mask.lo,
                                          sk.mask.hi, 20, sk.salt, 200,
                                          False))


def test_pipeline_real_overflow_raises_the_capacity(monkeypatch):
    """A sketch_capacity below the sketch of one genome in every dispatch
    (raw_kept > capacity + 1, not a row's chance overflow): the blocks
    sketched before the first block's read re-sketch their long genomes,
    one re-sketch dispatch each, and the dispatches after it take the
    larger capacity, so fewer dispatches are re-sketched than run; the
    result equals the uncapped run's.  With no lookahead block 0 is read
    as block 1 receives its first dispatch, so two blocks show it."""
    from spaced_kmer_sketching_tpu_torch import pipeline
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
    monkeypatch.setattr(pipeline, "LOOKAHEAD", 0)
    g, n, dispatch = 192, 700, 32

    def src(s0, s1):       # genome 5 of each dispatch long, the rest short
        out = []
        for i in range(s0, s1):
            ln = n if i % dispatch == 5 else 400
            codes = np.random.default_rng(2000 + i).integers(
                0, 4, ln).astype(np.uint8)
            out.append(PackedSeqs(codes=codes,
                                  run_lens=np.array([ln], np.int64)))
        return out
    runs, redos = [], []
    for cap in (256, 0):
        sk = FracMinHashSketcher(SketchConfig(window=12, k=8, scale=2,
                                              sketch_capacity=cap),
                                 device="cpu")
        before = observability.counters().get(REDOS, 0)
        runs.append(DevicePipeline(sk, dispatch=dispatch).all_pairs(
            src, g, n))
        redos.append(observability.counters().get(REDOS, 0) - before)
    long = np.arange(5, g, dispatch)
    assert int(runs[0].counts[long].min()) > 256 + 1
    assert int(np.delete(runs[0].counts, long).max()) < 256
    # block 0 (dispatches 0-3) and block 1's first dispatch, enqueued
    # before block 0's read, are re-sketched; dispatch 5 is not
    assert redos == [2, 0] and redos[0] < g // dispatch
    assert_same_result(runs[0], runs[1])
    np.testing.assert_array_equal(np.diag(runs[0].inter), runs[0].counts)


def test_driver_pipeline_csv_is_the_jax_two_step_csv(tmp_path, monkeypatch,
                                                     capsys):
    """run_experiment routed through the pipeline writes the JAX CLI's
    two-step CSV byte for byte, with the reference's timing lines."""
    rng = np.random.default_rng(31)
    paths = [write_fasta(tmp_path / f"d{i}.fa", [random_genome(rng, 1200)])
             for i in range(5)]
    want = tmp_path / "jax.csv"
    monkeypatch.setenv("SKS_DEVICE_PIPELINE", "0")
    jax_driver.run_experiment(12, 8, paths, str(want), False,
                              config=JaxConfig(window=12, k=8, scale=5),
                              echo_timings=False)
    routed = []
    monkeypatch.setattr(driver, "_use_device_pipeline",
                        lambda sk, f, pairing, store:
                        routed.append(len(f)) or True)
    got = tmp_path / "port.csv"
    driver.run_experiment(12, 8, paths, str(got), False,
                          config=SketchConfig(window=12, k=8, scale=5),
                          device="cpu")
    assert routed == [5]
    assert got.read_bytes() == want.read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert [line.split(" = ")[0] for line in out] == [
        "Time taken for sketching", "Time taken for comparison"]


@pytest.fixture
def collection(tmp_path):
    """513 tiny FASTA files (sizes are what the routing reads)."""
    paths = []
    for i in range(513):
        p = tmp_path / f"c{i}.fa"
        p.write_text(">c\n" + "ACGT" * 100 + "\n")
        paths.append(str(p))
    return paths


def test_use_device_pipeline_decisions(collection, tmp_path):
    """Routing: a GPU sketcher, more than 512 genomes, no streaming-size
    file, padding at most doubling the work; the CPU never routes."""
    gpu = types.SimpleNamespace(device=torch.device("cuda"),
                                _STREAM_THRESHOLD_BYTES=1 << 28)
    cpu = types.SimpleNamespace(device=torch.device("cpu"),
                                _STREAM_THRESHOLD_BYTES=1 << 28)
    assert driver._use_device_pipeline(gpu, collection, "all", None)
    assert not driver._use_device_pipeline(cpu, collection, "all", None)
    assert not driver._use_device_pipeline(gpu, collection[:512], "all", None)
    big = types.SimpleNamespace(device=torch.device("cuda"),
                                _STREAM_THRESHOLD_BYTES=400)
    assert not driver._use_device_pipeline(big, collection, "all", None)
    skew = tmp_path / "skew.fa"
    skew.write_text(">s\n" + "ACGT" * 50000 + "\n")     # 500x the others
    assert not driver._use_device_pipeline(gpu, collection + [str(skew)],
                                           "all", None)
    assert not driver._use_device_pipeline(
        gpu, collection + [str(tmp_path / "missing.fa")], "all", None)


def test_mesh_is_not_ported(tmp_path):
    """The name stays from before the port had a mesh.  What is still not
    there is the multi-process MeshDevicePipeline (the JAX one is single
    controller too): a mesh whose slots belong to two ranks raises, while
    a mesh of this process runs and gives the single-device result."""
    from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(13)
    paths = [write_fasta(tmp_path / f"m{i}.fa", [random_genome(rng, 900)])
             for i in range(3)]
    sk = FracMinHashSketcher(SketchConfig(window=12, k=8), device="cpu")
    with pytest.raises(ValueError, match="one process"):
        all_pairs_from_files(sk, paths, mesh=make_mesh(
            devices=["cpu"] * 2, ranks=[0, 1]))
    assert_same_result(all_pairs_from_files(sk, paths, mesh=make_mesh(
        devices=["cpu"])), all_pairs_from_files(sk, paths, dispatch=2))


def test_pipeline_imports_no_jax():
    code = ("import sys, spaced_kmer_sketching_tpu_torch.pipeline; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
