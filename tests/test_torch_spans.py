"""The port's spans and host-sync counter (observability.py): a span's
seconds, its range on the profiler's timeline only while a profiler
records, the pipeline's and the tile sweep's spans nested in a job, an
overflow's re-sketch and the count of the host's blocking reads.

The port runs on the CPU, where every kernel wrapper takes its plain
PyTorch version; the profiler records the CPU alone.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spaced_kmer_sketching_tpu_torch import observability
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.observability import span
from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
from spaced_kmer_sketching_tpu_torch.pipeline import (
    DevicePipeline, MeshDevicePipeline, codes_source)

SYNCS = "pipeline_host_syncs"
REDOS = "pipeline_sketch_redos"


def traced(fn):
    """fn()'s result and its host ranges: {name: [(start, end) us]}."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start,
                                              e.time_range.end))
    return out, ranges


def inside(inner, outer) -> bool:
    return any(o0 <= inner[0] and inner[1] <= o1 for o0, o1 in outer)


def test_span_books_float_seconds_and_no_counter():
    before = observability.counters()
    with span("test.outer") as outer:
        with span("test.inner") as inner:
            sum(range(10_000))
    assert isinstance(outer.seconds, float) and isinstance(inner.seconds,
                                                           float)
    assert 0 < inner.seconds <= outer.seconds
    assert observability.counters() == before


def test_span_seconds_are_set_when_the_block_raises():
    with pytest.raises(KeyError):
        with span("test.raises") as s:
            raise KeyError
    assert s.seconds > 0


def test_span_opens_a_range_only_while_a_profiler_records(monkeypatch):
    """No record_function without a profiler (it costs even then); under
    one, a range of the span's name.  The guard is torch's private
    `_is_profiler_enabled`: a torch that drops it fails here."""
    opened = []
    real = observability.record_function
    monkeypatch.setattr(observability, "record_function",
                        lambda name: opened.append(name) or real(name))
    assert torch.autograd.profiler._is_profiler_enabled is False
    with span("test.off"):
        pass
    assert opened == []

    def on():
        with span("test.on"):
            pass
    _, ranges = traced(on)
    assert opened == ["test.on"] and len(ranges["test.on"]) == 1
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_untraced_span_opens_no_range_under_the_profiler(monkeypatch):
    """`trace=False`: timed, and no range even while a profiler records."""
    opened = []
    real = observability.record_function
    monkeypatch.setattr(observability, "record_function",
                        lambda name: opened.append(name) or real(name))

    def run():
        with span("test.timed", trace=False) as s:
            sum(range(10_000))
        return s
    s, ranges = traced(run)
    assert opened == [] and "test.timed" not in ranges
    assert s.seconds > 0


def test_pipeline_spans_nest_in_the_job():
    """A DevicePipeline job under the profiler: pipeline.job holds the
    attempt, its block reads, presorts and the assembly, and the sweep
    with its tile launches and download.  The spans taken once a dispatch
    (the prefetch wait, the source, the enqueue) are timed into phases
    and open no range."""
    g, n = 20, 3000
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=20),
                             device="cpu")
    res, ranges = traced(lambda: DevicePipeline(sk, dispatch=8).all_pairs(
        codes_source(g, n, seed=1), g, n))
    (job,) = ranges["pipeline.job"]
    for name in ("pipeline.dispatch", "pipeline.ingest_wait",
                 "pipeline.ingest"):
        assert name not in ranges, name
    for name, times in (("pipeline.attempt", 1),
                        ("pipeline.block_read", 1), ("pipeline.presort", 1),
                        ("pipeline.assemble", 1), ("allpairs.sweep", 1),
                        ("allpairs.tiles", 1), ("allpairs.download", 1)):
        assert len(ranges[name]) == times, name
        assert all(inside(r, [job]) for r in ranges[name]), name
    for name in ("pipeline.block_read", "pipeline.presort",
                 "pipeline.assemble"):
        assert all(inside(r, ranges["pipeline.attempt"])
                   for r in ranges[name]), name
    for name in ("allpairs.tiles", "allpairs.download"):
        assert inside(ranges[name][0], ranges["allpairs.sweep"]), name
    assert "pipeline.redo" not in ranges
    assert res.phases["restart_s"] == 0.0 and res.phases["redo_s"] == 0.0
    assert res.phases["allpairs_s"] > 0 and res.phases["sketch_s"] > 0
    assert res.phases["ingest_work_s"] > 0


@pytest.mark.parametrize("cap", [256, 0])
def test_restart_seconds_and_host_syncs(cap):
    """A capacity of 256 overflows every genome (as
    test_pipeline_capacity_overflow_retry forces it): they are sketched
    again inside the one attempt, in a pipeline.redo range whose seconds
    redo_s books, and no pass is thrown away (restarts 0, restart_s 0.0);
    without an overflow there is no re-sketch.  Syncs: a block read each,
    a re-sketch's read each, one sampled genome's keys, one download; the
    assembly synchronizes nothing on the CPU."""
    g, n = 6, 40_000
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=20,
                                          sketch_capacity=cap), device="cpu")
    pipe = DevicePipeline(sk)
    before = observability.counters()
    res, ranges = traced(lambda: pipe.all_pairs(codes_source(g, n, seed=4),
                                                g, n, verify_ids=[1]))
    after = observability.counters()
    syncs = after[SYNCS] - before.get(SYNCS, 0)
    redos = after.get(REDOS, 0) - before.get(REDOS, 0)
    assert pipe.restarts == 0 and res.phases["restart_s"] == 0.0
    assert (redos > 0) == (cap > 0)
    (attempt,) = ranges["pipeline.attempt"]
    reads = len(ranges["pipeline.block_read"])
    assert reads == 1                            # one block
    redo = ranges.get("pipeline.redo", [])
    assert len(redo) == (1 if cap else 0)        # one block re-sketched
    assert all(inside(r, [attempt]) for r in redo)
    assert len(ranges["pipeline.assemble"]) == 1
    assert syncs == reads + redos + 1 + len(ranges["allpairs.download"]) \
        == reads + redos + 2
    if redos:
        assert res.phases["redo_s"] > 0
        assert res.phases["redo_s"] == pytest.approx(
            sum(e - s for s, e in redo) / 1e6, rel=0.5, abs=1e-3)
    else:
        assert res.phases["redo_s"] == 0.0


def test_mesh_sweep_spans_and_syncs():
    """Over two CPU slots (two caches, the tiles split over the slots): the
    same spans, one download through the mesh route's all-reduce, and a
    sync a block read and the download (no synchronize on the CPU)."""
    g, n = 100, 1400
    sk = FracMinHashSketcher(SketchConfig(window=14, k=10, scale=4),
                             device="cpu")
    pipe = MeshDevicePipeline(sk, make_mesh(devices=["cpu", "cpu:0"]))
    before = observability.counters().get(SYNCS, 0)
    res, ranges = traced(lambda: pipe.all_pairs(codes_source(g, n, seed=3),
                                                g, n))
    syncs = observability.counters()[SYNCS] - before
    assert len(ranges["allpairs.download"]) == 1
    assert inside(ranges["allpairs.tiles"][0], ranges["allpairs.sweep"])
    assert syncs == len(ranges["pipeline.block_read"]) + 1
    np.testing.assert_array_equal(np.diagonal(res.inter), res.counts)


def test_sketch_files_spans(tmp_path):
    """The sweep's host path: sketch.files holds the parse wait and a
    pack and upload a genome, on a second pass of the same files too."""
    rng = np.random.default_rng(5)
    paths = []
    for i in range(2):
        p = tmp_path / f"g{i}.fa"
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
        p.write_text(f">g{i}\n{seq}\n")
        paths.append(str(p))
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=20),
                             device="cpu")
    for _ in range(2):
        _, ranges = traced(lambda: sk.sketch_files(paths))
        (files,) = ranges["sketch.files"]
        (wait,) = ranges["sketch.parse_wait"]
        assert inside(wait, [files])
        packs = ranges.get("sketch.pack_upload", [])
        assert len(packs) == 2
        assert all(inside(r, [files]) for r in packs)


def test_benchmark_reads_the_resketch():
    """The benchmark's readers of the re-sketch on what the pipeline books:
    allpairs.sketch_redos is the counter's change a job (0 with no
    overflow, where the counter never moved), allpairs.redo_s the mean
    of phases["redo_s"]; both silent for jobs that book no redo_s (a
    program without the re-sketch)."""
    import types
    from benchmark import harness

    def read(name, records, counters):
        return harness.load_metric(harness.BENCH, name)(
            types.SimpleNamespace(records=records, counters=counters))

    g, n = 6, 40_000
    for cap in (256, 0):
        sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=20,
                                              sketch_capacity=cap),
                                 device="cpu")
        before = observability.counters()
        res = DevicePipeline(sk).all_pairs(codes_source(g, n, seed=4), g, n)
        after = observability.counters()
        counters = {k: after[k] - before.get(k, 0) for k in after
                    if after[k] != before.get(k, 0)}
        records = [{"phases": dict(res.phases)}] * 2
        assert read("allpairs.sketch_redos", records, counters) == \
            counters.get(REDOS, 0) / 2
        assert (read("allpairs.sketch_redos", records, counters) > 0) == \
            (cap > 0)
        assert read("allpairs.redo_s", records, counters) == \
            res.phases["redo_s"]
    old = [{"phases": {"restart_s": 0.5}}]
    assert read("allpairs.sketch_redos", old, {}) is None
    assert read("allpairs.redo_s", old, {}) is None
