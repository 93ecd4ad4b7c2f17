"""The trace readers and the metric readers on runs whose answers are
known."""
import json
import pathlib

import numpy as np
import pytest

from benchmark import harness, trace

BENCH = pathlib.Path(harness.__file__).resolve().parent
K6 = "void sks::(anonymous namespace)::gram_mma_kernel<4>(int const*, int*)"
K10 = "void sks::merge_pair_kernel(long const*, long*)"
K7 = "void sks::(anonymous namespace)::slide_kernel<1, 2>(int const*)"


def synthetic() -> trace.Trace:
    """Window 0-1000 ns; device busy 0-150 and 300-400 (overlapping
    kernels merged), one kernel partly outside the window."""
    return trace.Trace(
        device=[(K6, 0, 100), (K10, 50, 150), ("Memcpy DtoH", 300, 400),
                (K7, 950, 1100), (K7, 2000, 2100)],
        host=[("bench::all_pairs", 0, 1000), ("aten::item", 160, 290),
              ("aten::copy_", 420, 600), ("aten::empty", 700, 720)],
        window=(0, 1000))


def test_busy_and_idle():
    t = synthetic()
    assert trace.busy_s(t) == pytest.approx(300e-9)
    assert trace.idle_pct(t) == pytest.approx(70.0)
    assert trace.idle_gaps(t) == [(150, 300), (400, 950)]


def test_kernel_sums_by_short_name():
    sums = trace.kernel_sums(synthetic())
    assert sums["gram_mma_kernel"] == [pytest.approx(100e-9), 1]
    assert sums["merge_pair_kernel"] == [pytest.approx(100e-9), 1]
    assert sums["slide_kernel"][1] == 1                 # one inside
    assert trace.device_seconds(synthetic(), ("nope",)) is None
    assert trace.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::"
        "native::OpaqueType<4u>, 3>(char*)") == "at::native::CatArrayBatchedCopy"
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"


def test_gaps_by_host_take_the_innermost_event():
    got = dict(trace.gaps_by_host(synthetic()))
    # gap 150-300: middle 225 in aten::item; 400-950: middle 675 in
    # bench::all_pairs only (aten::copy_ ended at 600)
    assert got == {"aten::item": pytest.approx(150e-9),
                   "bench::all_pairs": pytest.approx(550e-9)}
    bd = trace.breakdown(synthetic())
    assert bd["device_ops"][0][0] in ("gram_mma_kernel", "merge_pair_kernel",
                                      "slide_kernel", "Memcpy DtoH")
    assert len(bd["idle_gaps"]) == 2


def _run(records, tr=None, counters=None, kind="NVIDIA H100 80GB HBM3"):
    cell = harness.Cell("x", {}, {}, 1, [], [], BENCH)
    t0 = records[0]["t0"] if records else 0.0
    t1 = records[-1]["t1"] if records else 0.0
    return harness.Run(cell=cell, seed=1, setup_s=12.5, window=(t0, t1),
                       records=records, counters=counters or {}, trace=tr,
                       device_kind=kind)


def _read(name, run):
    return harness.load_metric(BENCH, name)(run)


def test_end_to_end_readers():
    recs = [{"t0": i * 0.05, "t1": (i + 1) * 0.05, "wall_s": 0.05 + i * 1e-3,
             "pairs": 100} for i in range(100)]
    run = _run(recs)
    assert _read("setup_s", run) == 12.5
    assert _read("sweep_config_ms", run) == pytest.approx(50.0)
    assert _read("sweep.config_p95_ms", run) == pytest.approx(144.0)
    assert _read("allpairs_pairs_per_s", run) == pytest.approx(2000.0)
    assert _read("sweep_config_ms", _run([])) is None


def test_program_readers():
    recs = [{"t0": 0, "t1": 1, "wall_s": 1, "restarts": r,
             "phases": {"allpairs_s": s},
             "stdout": f"Time taken for sketching = {ms} ms\n"
                       "Time taken for comparison = 1.5 ms\n"}
            for r, s, ms in ((1, 0.5, 40.0), (0, 0.7, 44.0))]
    run = _run(recs, counters={"upload_cache_hits": 3,
                               "upload_cache_misses": 1})
    assert _read("allpairs.restarts", run) == 0.5
    assert _read("allpairs.tile_sweep_s", run) == pytest.approx(0.6)
    assert _read("sweep.sketching_ms", run) == pytest.approx(42.0)
    assert _read("sweep.upload_hit_pct", run) == 75.0
    assert _read("sweep.upload_hit_pct", _run(recs)) is None


def test_trace_readers_are_silent_without_a_trace():
    recs = [{"t0": 0, "t1": 1, "wall_s": 1, "counts": np.ones(256)}]
    for name in ("sweep.device_idle_pct", "allpairs.device_idle_pct",
                 "allpairs.sketch_kernels_ms", "allpairs.k6_roofline_pct",
                 "allpairs.k10_roofline_pct"):
        assert _read(name, _run(recs)) is None


def _tile_bytes(counts, block=128):
    """K6's and K10's bytes by an explicit walk over the tiles."""
    n = [int(np.sum(counts[b:b + block])) for b in range(0, len(counts),
                                                         block)]
    k6 = k10 = 0
    for b1 in range(len(n)):
        for b2 in range(b1, len(n)):
            stream = n[b1] + (n[b2] if b2 != b1 else 0)
            k6 += 8 * stream + 128 * 128 * 4
            if b2 != b1:
                k10 += 8 * stream * 2
    return k6, k10


def test_roofline_readers():
    counts = np.random.default_rng(1).integers(20000, 30000, 300)
    k6_bytes, k10_bytes = _tile_bytes(counts)
    hbm = 3.35e12
    # K6 ran exactly its bound's time twice over: 50%; K10 4x: 25%
    k6_ns = int(round(2 * k6_bytes / hbm * 1e9))
    k10_ns = int(round(4 * k10_bytes / hbm * 1e9))
    tr = trace.Trace(device=[(K6, 0, k6_ns), (K10, k6_ns, k6_ns + k10_ns),
                             (K7, 0, 10)],
                     host=[], window=(0, 10 ** 12))
    recs = [{"t0": 0, "t1": 1, "wall_s": 1, "counts": counts}]
    assert _read("allpairs.k6_roofline_pct", _run(recs, tr)) == \
        pytest.approx(50.0, rel=1e-4)
    assert _read("allpairs.k10_roofline_pct", _run(recs, tr)) == \
        pytest.approx(25.0, rel=1e-4)
    assert _read("allpairs.sketch_kernels_ms", _run(recs, tr)) == \
        pytest.approx(1e-5)
    two = [dict(recs[0]), dict(recs[0])]            # two jobs, same time
    assert _read("allpairs.k6_roofline_pct", _run(two, tr)) == \
        pytest.approx(100.0, rel=1e-4)


def test_collection_bytes_at_the_cell_size():
    """10,240 genomes of ~25,000 keys: K6 ~166 GB, K10 ~323 GB."""
    counts = np.full(10240, 25000)
    k6 = harness.load_metric(BENCH, "allpairs.k6_roofline_pct").__globals__
    k10 = harness.load_metric(BENCH, "allpairs.k10_roofline_pct").__globals__
    assert k6["bytes_needed"](counts) == pytest.approx(164e9, rel=0.01)
    assert k10["bytes_needed"](counts) == pytest.approx(323.6e9, rel=0.01)


def test_every_metric_has_a_reader():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_metric(BENCH, m["name"]))
