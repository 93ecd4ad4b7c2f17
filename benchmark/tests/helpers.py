"""A throwaway checkout of the benchmark for CPU tests: BENCHMARK.json and
the benchmark's files copied into a temporary directory, with cells added
by new files and new BENCHMARK.json entries only."""
import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: The sweep cell's entries, as a BENCHMARK.json that adds the cell would
#: hold them (its configuration, operation, traffic and metric files are
#: in the benchmark already).
SWEEP_CELL = {
    "configs": [{
        "name": "pair", "file": "benchmark/configs/pair.json",
        "source": "https://github.com/bensonlzl/spaced-kmer-sketching "
                  "src/kmer-sketching.cpp:214-240, main's 62 (window, k) "
                  "sweep; BASELINE config 1: two E. coli genomes",
        "reduced": [],
        "why": "the reference tool's own main: two FASTA genomes through "
               "all 62 (window, k) experiments"}],
    "workloads": [{
        "name": "pair.sweep62", "config": "pair", "traffic": "sweep62",
        "chips": 1,
        "why": "two 4.64 Mnt FASTAs, the 62-config sweep cycled by one "
               "closed-loop client"}],
    "end_to_end": [{
        "name": "sweep_config_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["pair.sweep62"]}],
    "per_layer": [
        {"name": "sweep.sketching_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "driver (driver.run_experiment)",
         "moves": "sweep_config_ms", "workloads": ["pair.sweep62"]},
        {"name": "sweep.config_p95_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "driver (driver.run_experiment)",
         "moves": "sweep_config_ms", "workloads": ["pair.sweep62"]},
        {"name": "sweep.upload_hit_pct", "unit": "%", "better": "higher",
         "source": "program_counter",
         "layer": "host pack + upload (models/fracminhash upload cache)",
         "moves": "sweep_config_ms", "workloads": ["pair.sweep62"]},
        {"name": "sweep.device_idle_pct", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "sweep_config_ms", "workloads": ["pair.sweep62"]}],
}

TINY = {
    "pair_tiny": ("pair", {"length_nt": 3000}),
    "collection_tiny": ("collection10k",
                        {"count": 256, "length_nt": 3000, "species": 40}),
}


def copy_checkout(dest: pathlib.Path) -> pathlib.Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


def add_entries(spec: dict, entries: dict) -> None:
    """Append `entries` (lists by BENCHMARK.json key) to spec's lists."""
    for key, items in entries.items():
        spec[key].extend(json.loads(json.dumps(items)))


def add_tiny_cells(root: pathlib.Path) -> None:
    """The sweep cell's entries, then new configuration files of the real
    ones at CPU sizes and a cell of each under the real traffic: added
    files, and entries appended to BENCHMARK.json's lists."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    add_entries(spec, SWEEP_CELL)
    for name, (base, genomes) in TINY.items():
        cfg = json.loads((root / "benchmark" / "configs" /
                          f"{base}.json").read_text())
        cfg["name"] = name
        cfg["genomes"].update(genomes)
        path = f"benchmark/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        entry = dict(next(c for c in spec["configs"] if c["name"] == base))
        entry.update(name=name, file=path)
        spec["configs"].append(entry)
        for w in [w for w in spec["workloads"] if w["config"] == base]:
            cell = dict(w, name=f"{name}.{w['traffic']}", config=name)
            spec["workloads"].append(cell)
            for m in spec["end_to_end"] + spec["per_layer"]:
                if w["name"] in m.get("workloads", ()):
                    m["workloads"].append(cell["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
