"""The port's sketch store (store.py) against the JAX package's.

The port runs on the CPU (the kernels' plain versions), the JAX package on
its CPU backend.  FASTAs are made from a seed with numpy.  Keys and counts
are integers, so every comparison is exact (tolerance 0).
"""
import json

import numpy as np

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher)
from spaced_kmer_sketching_tpu import store as jax_store

from spaced_kmer_sketching_tpu_torch import SketchStore
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.store import (_sketch_key,
                                                   completed_pairs_in_csv)

from test_driver import write_fasta
from oracle import random_genome

CFG = dict(window=12, k=8, scale=5)


def genomes(tmp_path, n=3, seed=2):
    rng = np.random.default_rng(seed)
    return [write_fasta(tmp_path / f"g{i}.fa", [random_genome(rng, 1200)])
            for i in range(n)]


def port_sketcher(**kw):
    return FracMinHashSketcher(SketchConfig(**{**CFG, **kw}), device="cpu")


def counting(sketcher):
    """Record every path the sketcher's sketch_files is asked for."""
    calls = []
    orig = sketcher.sketch_files
    sketcher.sketch_files = lambda paths, *a, **k: (calls.extend(paths),
                                                    orig(paths, *a, **k))[1]
    return calls


def test_store_roundtrip_and_resume(tmp_path):
    """tests/test_store.py's case on the port: first run sketches all,
    the second reads every sketch back equal, a new mask seed misses."""
    paths = genomes(tmp_path)
    sk = port_sketcher()
    store = SketchStore(str(tmp_path / "store"))
    calls = counting(sk)
    first = store.sketch_files_resumable(sk, paths)
    assert calls == paths                 # one sketch_files call for all
    assert all(s.count > 0 for s in first)
    calls.clear()
    second = SketchStore(str(tmp_path / "store")).sketch_files_resumable(
        sk, paths)
    assert calls == []
    for a, b in zip(first, second):
        assert a.count == b.count and a.name == b.name
        np.testing.assert_array_equal(a.keys, b.keys)
    sk2 = port_sketcher(mask_seed=7)
    calls2 = counting(sk2)
    third = store.sketch_files_resumable(sk2, paths)
    assert calls2 == paths and len(third) == 3
    index = json.loads((tmp_path / "store" / "index.json").read_text())
    assert len(index) == 6 and list(index) == sorted(index)


def test_sketch_file_is_sketch_files(tmp_path):
    paths = genomes(tmp_path, n=2)
    sk = port_sketcher()
    for p, want in zip(paths, sk.sketch_files(paths)):
        got = sk.sketch_file(p)
        assert got.name == p and got.count == want.count
        np.testing.assert_array_equal(got.keys, want.keys)


def test_completed_pairs(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("File 1,File 2,Estimated Value,Window Size,Mask\n"
                 "a,b,0.9,10,0000\n"
                 "b,a,0.8,10,0000\n"
                 "b,a,0.8,10,0000\n"       # duplicate row (same path twice)
                 "a,b,0.7,10,0011\n")      # same window, different mask
    done = completed_pairs_in_csv(str(p))
    assert done[("a", "b", "10", "0000")] == 1
    assert done[("b", "a", "10", "0000")] == 2        # multiplicity kept
    assert done[("a", "b", "10", "0011")] == 1        # mask disambiguates
    assert done[("a", "b", "12", "0000")] == 0
    assert done == jax_store.completed_pairs_in_csv(str(p))
    assert len(completed_pairs_in_csv(str(tmp_path / "missing.csv"))) == 0


def test_sketch_key_matches_jax(tmp_path):
    for args in [("a.fa", 12, 8, 0x1234, 5, 0, "modern"),
                 (str(tmp_path / "b.fa"), 40, 30, (1 << 80) - 7, 200, 3,
                  "legacy")]:
        assert _sketch_key(*args) == jax_store._sketch_key(*args)


def test_jax_store_is_read_by_the_port(tmp_path):
    paths = genomes(tmp_path, seed=5)
    root = str(tmp_path / "st")
    jsk = JaxSketcher(JaxConfig(**CFG))
    want = jax_store.SketchStore(root).sketch_files_resumable(jsk, paths)
    sk = port_sketcher()
    calls = counting(sk)
    got = SketchStore(root).sketch_files_resumable(sk, paths)
    assert calls == []
    for a, b in zip(got, want):
        assert a.count == b.count and a.name == b.name
        np.testing.assert_array_equal(a.keys, b.keys)
    fresh = sk.sketch_files(paths)
    for a, b in zip(fresh, want):
        np.testing.assert_array_equal(a.keys, b.keys)


def test_port_store_is_read_by_jax(tmp_path):
    paths = genomes(tmp_path, seed=6)
    root = str(tmp_path / "st")
    want = SketchStore(root).sketch_files_resumable(port_sketcher(), paths)
    jsk = JaxSketcher(JaxConfig(**CFG))
    calls = []
    orig = jsk.sketch_file
    jsk.sketch_file = lambda p, *a, **k: (calls.append(p), orig(p, *a, **k))[1]
    got = jax_store.SketchStore(root).sketch_files_resumable(jsk, paths)
    assert calls == []
    for a, b in zip(got, want):
        assert a.count == b.count and a.name == b.name
        np.testing.assert_array_equal(a.keys, b.keys)
