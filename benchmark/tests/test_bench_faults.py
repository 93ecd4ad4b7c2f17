"""The check has to fail: whole runs at CPU sizes with the timed path
broken underneath (the look for a card skipped), and each cell's control
at a size where it can show."""
import time

import numpy as np
import pytest

from benchmark import data, harness
from benchmark.tests.helpers import add_tiny_cells, copy_checkout
from spaced_kmer_sketching_tpu_torch import pipeline
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = copy_checkout(tmp_path_factory.mktemp("checkout"))
    add_tiny_cells(root)
    return root


def run(root, cell, control=False):
    return harness.run_cell(cell, 2 ** 31 + 99, 0.3, False,
                            t_process=time.perf_counter(), device="cpu",
                            control=control, root=root,
                            bench=root / "benchmark")[0]


def altered_intersection(orig):
    """An answer altered where it is produced: one pair's intersection."""
    def f(self, sketches):
        out = np.array(orig(self, sketches))
        out[0, 1] += 1
        return out
    return f


def half_batch_left_out(orig):
    """Half of the batch left out, its place taken by the rest."""
    def f(self, paths, *a, **kw):
        out = orig(self, paths, *a, **kw)
        half = len(out) // 2
        return out[:len(out) - half] + out[:half]
    return f


@pytest.mark.parametrize("fault,name", [
    (altered_intersection, "all_pairs_intersections"),
    (half_batch_left_out, "sketch_files")])
def test_sweep_faults_fail(tiny, monkeypatch, fault, name):
    monkeypatch.setattr(FracMinHashSketcher, name,
                        fault(getattr(FracMinHashSketcher, name)))
    result = run(tiny, "pair_tiny.sweep62")
    assert not result["correct"]
    assert result["checks"]["mismatches"]["parts"]["ani"] > 0


def altered_matrix_entry(orig):
    """An answer altered where it is produced: one entry of the matrix."""
    def f(*a, **kw):
        out = orig(*a, **kw)
        out[3, 200] += 1
        return out
    return f


def half_block_left_out(orig):
    """Half of every block's sketches left out of its presort."""
    def f(kb, **kw):
        kb = kb.clone()
        kb[kb.shape[0] // 2:] = -1
        return orig(kb, **kw)
    return f


@pytest.mark.parametrize("fault,name,part", [
    (altered_matrix_entry, "mesh_tile_sweep", "asym"),
    (half_block_left_out, "presort_block_packed", "diag")])
def test_collection_faults_fail(tiny, monkeypatch, fault, name, part):
    monkeypatch.setattr(pipeline, name, fault(getattr(pipeline, name)))
    result = run(tiny, "collection_tiny.related")
    assert not result["correct"]
    check = result["checks"]["mismatches"]
    assert check["value"] > check["limit"]
    assert check["parts"][part] > 0


def test_sweep_control_fails(tiny):
    result = run(tiny, "pair_tiny.sweep62", control=True)
    assert result["correct"]
    assert result["control"]["mismatches"]["parts"]["ani"] > 0


def test_collection_control_fails():
    """32-bit key fingerprints collide only at the cell's sketch sizes: the
    control's own comparison on 16 genomes of the cell's length (the
    program takes no part in it)."""
    cell = harness.load_cell("collection10k.related")
    op = harness.operation(cell, 2 ** 31 + 3, "cpu")
    spec = dict(cell.genomes, count=16, species=4)
    words, species_of = data.device_collection(spec, 2 ** 31 + 3,
                                               -(-op.n // 16), "cpu")
    op.sample = np.arange(16)
    op.sample_words = words.numpy()
    checks = op.control([])
    assert checks[0].name == "mismatches"
    assert checks[0].value > checks[0].limit
    assert checks[0].parts["sample"] == checks[0].value
