"""The harness on the CPU: cells found by name from files, whole runs at
small sizes, and the modules a run may not load."""
import ast
import hashlib
import json
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.tests.helpers import BENCH, ROOT, SWEEP_CELL, add_entries, \
    add_tiny_cells, copy_checkout


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = copy_checkout(tmp_path_factory.mktemp("checkout"))
    add_tiny_cells(root)
    return root


def run(root, cell, trace=False, seed=2 ** 31 + 77, seconds=0.3):
    return harness.run_cell(cell, seed, seconds, trace,
                            t_process=time.perf_counter(), device="cpu",
                            root=root, bench=root / "benchmark")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


@pytest.mark.parametrize("cell", ["pair_tiny.sweep62",
                                  "collection_tiny.related"])
@pytest.mark.parametrize("trace", [False, True])
def test_cells_run_and_check(tiny, cell, trace):
    result, checks = run(tiny, cell, trace)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1 and checks
    assert all(c.limit == 0 and c.value == 0 for c in checks)
    assert list(result)[-1] == "checks"
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    want = {m["name"] for m in (spec["per_layer"] if trace
                                else spec["end_to_end"])
            if cell in m.get("workloads", [cell])}
    got = set(result["metrics"])
    assert got <= want
    if not trace:
        assert got == want                     # host clock: all present
    else:
        assert "busy_s" in result["device"] and "breakdown" in result


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """The sweep cell at a small size, with a metric of its own: new
    configuration, traffic and metric files and new BENCHMARK.json entries;
    no file the benchmark has changes."""
    root = copy_checkout(tmp_path)
    before = _digests(root)
    (root / "benchmark/traffic/short3.json").write_text(json.dumps({
        "operation": "sweep", "loop": "closed", "check_configs": 3}))
    cfg = json.loads((root / "benchmark/configs/pair.json").read_text())
    cfg["genomes"]["length_nt"] = 2500
    (root / "benchmark/configs/pair_small.json").write_text(json.dumps(cfg))
    (root / "benchmark/metrics/sweep.experiments.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    add_entries(spec, SWEEP_CELL)
    spec["configs"].append({**spec["configs"][-1], "name": "pair_small",
                            "file": "benchmark/configs/pair_small.json"})
    spec["workloads"].append({"name": "pair_small.short3",
                              "config": "pair_small", "traffic": "short3",
                              "chips": 1, "why": "a throwaway cell"})
    spec["per_layer"].append({
        "name": "sweep.experiments", "unit": "experiments",
        "better": "higher", "source": "program_counter", "layer": "driver",
        "moves": "sweep_config_ms", "workloads": ["pair_small.short3"]})
    spec["end_to_end"][-1]["workloads"].append("pair_small.short3")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    result, _ = run(root, "pair_small.short3", trace=True)
    assert result["correct"]
    assert result["metrics"]["sweep.experiments"]["value"] == \
        result["attempted"]
    assert "sweep.sketching_ms" not in result["metrics"]
    result, _ = run(root, "pair_small.short3", trace=False)
    assert set(result["metrics"]) == {"sweep_config_ms", "setup_s"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference, benchmark.workers, "
            "benchmark.mt19937; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.strip().replace("'", '"')))
    assert not loaded & {"spaced_kmer_sketching_tpu_torch",
                         "spaced_kmer_sketching_tpu", "torch", "jax"}


def test_a_run_loads_no_forbidden_module(tiny):
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from benchmark import harness; import pathlib; "
            "r = pathlib.Path(%r); "
            "res, _ = harness.run_cell('pair_tiny.sweep62', 5, 0.2, True, "
            "t_process=time.perf_counter(), device='cpu', root=r, "
            "bench=r / 'benchmark'); "
            "print(res['correct'], harness.forbidden_modules())"
            % (str(ROOT), str(tiny)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "True []"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or \
        "jax" in sys.modules                      # the program's tests' JAX
    monkeypatch.setitem(sys.modules, "spaced_kmer_sketching_tpu_torch.x",
                        object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    clean = [m for m in harness.forbidden_modules()]
    monkeypatch.setitem(sys.modules, "spaced_kmer_sketching_tpu.ops",
                        object())
    assert "spaced_kmer_sketching_tpu" in harness.forbidden_modules()
    assert "spaced_kmer_sketching_tpu" not in clean or \
        "spaced_kmer_sketching_tpu" in sys.modules


def test_without_a_card_the_command_exits_with_no_result(tmp_path):
    copy_checkout(tmp_path)                 # BENCHMARK.json and paths only
    for cwd in (ROOT, tmp_path):
        res = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "collection10k.related", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert res.returncode != 0
        assert not res.stdout.strip()
