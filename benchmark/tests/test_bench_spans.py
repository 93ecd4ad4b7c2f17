"""The readers of the program's spans and host-sync counter on traces and
records whose answers are known."""
import pytest

from benchmark import harness, spans, trace
from benchmark.tests.test_bench_trace import _run

BENCH = harness.BENCH
K7 = "void sks::(anonymous namespace)::slide_kernel<1, 2>(int const*)"
K6 = "void sks::(anonymous namespace)::gram_mma_kernel<4>(int const*, int*)"


def _read(name, run):
    return harness.load_metric(BENCH, name)(run)


def two_jobs() -> trace.Trace:
    """Window 0-2000 ns, two jobs.  Device busy 0-100, 300-400, 500-600,
    1000-1100, 1500-1600.  Gaps: 100-300 (middle 200, attempt 1), 400-500
    (450, straddles attempt 1's end at 420 and the sweep's start at 440:
    the sweep holds the middle), 600-1000 (800, attempt 2), 1100-1500
    (1300: in the job only, between attempt 2 and sweep 2), 1600-2000
    (1800, sweep 2)."""
    return trace.Trace(
        device=[(K7, 0, 100), (K7, 300, 400), (K6, 500, 600),
                (K7, 1000, 1100), (K6, 1500, 1600)],
        host=[("pipeline.job", 0, 700), ("pipeline.attempt", 0, 420),
              ("aten::to", 150, 260), ("allpairs.sweep", 440, 700),
              ("pipeline.job", 700, 2000), ("pipeline.attempt", 700, 1050),
              ("allpairs.sweep", 1400, 2000),
              ("allpairs.download", 1700, 1950)],
        window=(0, 2000))


def _recs(n=2, **kw):
    return [dict({"t0": i, "t1": i + 1, "wall_s": 1}, **kw)
            for i in range(n)]


def test_idle_inside_a_span_by_the_gaps_middle():
    tr = two_jobs()
    assert trace.idle_gaps(tr) == [(100, 300), (400, 500), (600, 1000),
                                   (1100, 1500), (1600, 2000)]
    assert spans.idle_inside(tr, "pipeline.attempt") == pytest.approx(
        (200 + 400) / 1e9)
    assert spans.idle_inside(tr, "allpairs.sweep") == pytest.approx(
        (100 + 400) / 1e9)
    assert spans.idle_inside(tr, "pipeline.job") == pytest.approx(
        1500 / 1e9)
    assert spans.idle_inside(tr, "pipeline.presort") is None


def test_idle_readers_a_job():
    run = _run(_recs(), two_jobs())
    assert _read("allpairs.sketch_idle_ms", run) == pytest.approx(3e-4)
    assert _read("allpairs.sweep_idle_ms", run) == pytest.approx(2.5e-4)


def test_idle_readers_are_silent_without_the_spans_or_a_trace():
    """The parent program has no spans: the trace then holds the
    benchmark's own events alone."""
    bare = trace.Trace(device=[(K7, 0, 100)],
                       host=[("bench::all_pairs", 0, 1000)],
                       window=(0, 1000))
    for name in ("allpairs.sketch_idle_ms", "allpairs.sweep_idle_ms"):
        assert _read(name, _run(_recs(), bare)) is None
        assert _read(name, _run(_recs())) is None
        assert _read(name, _run([], two_jobs())) is None


def test_restart_seconds_a_job():
    recs = _recs(phases={"restart_s": 0.4}) + _recs(1, phases={
        "restart_s": 0.0})
    assert _read("allpairs.restart_s", _run(recs)) == pytest.approx(0.8 / 3)
    assert _read("allpairs.restart_s", _run(_recs(phases={}))) is None
    assert _read("allpairs.restart_s", _run([])) is None


def test_host_syncs_a_job():
    run = _run(_recs(4), counters={"pipeline_host_syncs": 552,
                                   "upload_cache_hits": 3})
    assert _read("allpairs.host_syncs", run) == 138
    assert _read("allpairs.host_syncs", _run(_recs(4))) is None
    assert _read("allpairs.host_syncs",
                 _run([], counters={"pipeline_host_syncs": 5})) is None
