"""The port's probe engine (ops/intersect.py) and the sketcher's probe
entries against the JAX package's, exactly.

Sketches are sorted unique (cap, 4) u32 key arrays made with numpy from a
seed, all-ones padded past their counts; the port gets the same words as
int32 tensors on the CPU.  The cases hold counts of 0 and of cap, keys
whose every word has bit 31 set (the port compares int32 containers, so a
signed compare would be wrong there) and a real all-ones key, which only
the count guards tell from padding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher, Sketch as JaxSketch)
from spaced_kmer_sketching_tpu.ops import intersect as jax_intersect

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.ops import intersect

ALL_ONES = 0xFFFFFFFF


def make_sketches(seed, g, cap, *, high_bits=False, all_ones=False):
    """g sketches of capacity cap drawn from one pool of 2 cap keys (so
    they share keys), counts from 0 to cap with both ends present.
    high_bits sets bit 31 of every word; all_ones puts the all-ones key
    into the pool and into sketches 0 and 2."""
    rng = np.random.default_rng(seed)
    lo = 2 ** 31 if high_bits else 0
    pool = rng.integers(lo, 2 ** 32, (2 * cap, 4), dtype=np.uint64)
    if all_ones:
        pool[0] = ALL_ONES
    keys = np.full((g, cap, 4), ALL_ONES, np.uint32)
    counts = np.zeros(g, np.int32)
    wanted = rng.integers(0, cap + 1, g)
    wanted[:3] = (cap, 0, cap)
    for i, c in enumerate(wanted):
        sel = pool[rng.choice(pool.shape[0], int(c), replace=False)]
        if all_ones and i in (0, 2):
            sel[0] = ALL_ONES
        # unique rows in 128-bit order: word 3 most significant
        u = np.unique(sel[:, ::-1], axis=0)[:, ::-1].astype(np.uint32)
        keys[i, :u.shape[0]] = u
        counts[i] = u.shape[0]
    return keys, counts


def port(keys, counts):
    return torch.from_numpy(keys.view(np.int32)), torch.from_numpy(counts)


CASES = [
    pytest.param(dict(g=16, cap=128), id="cap128-g16"),
    pytest.param(dict(g=8, cap=1024, high_bits=True), id="cap1024-bit31"),
    pytest.param(dict(g=8, cap=256, high_bits=True, all_ones=True),
                 id="cap256-all-ones-key"),
]


@pytest.mark.parametrize("case", CASES)
def test_probe_matches_jax(case):
    keys, counts = make_sketches(7, **case)
    g = keys.shape[0]
    jk, jc = jnp.asarray(keys), jnp.asarray(counts)
    tk, tc = port(keys, counts)

    want = np.asarray(jax_intersect.all_pairs_matrix(jk, jc, row_tile=8))
    got = intersect.all_pairs_matrix(tk, tc, row_tile=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.diag(want), counts)

    half = g // 2
    want = np.asarray(jax_intersect.intersection_tile(
        jk[:half], jc[:half], jk[half:], jc[half:]))
    got = intersect.intersection_tile(tk[:half], tc[:half], tk[half:],
                                      tc[half:])
    np.testing.assert_array_equal(got.numpy(), want)

    perm = np.random.default_rng(1).permutation(g)
    want = np.asarray(jax_intersect.pair_intersection_batch(
        jk, jc, jk[perm], jc[perm]))
    got = intersect.pair_intersection_batch(tk, tc, tk[perm], tc[perm])
    np.testing.assert_array_equal(got.numpy(), want)
    if case.get("all_ones"):
        # the real all-ones key counts once in sketches 0 and 2, and
        # padding never matches: the empty sketch 1 meets nothing
        assert int(intersect.all_pairs_matrix(tk, tc)[1].sum()) == 0


def test_probe_shape_checks():
    keys, counts = make_sketches(3, 8, 128)
    tk, tc = port(keys, counts)
    with pytest.raises(ValueError, match="row_tile"):
        intersect.all_pairs_matrix(tk, tc, row_tile=3)
    with pytest.raises(ValueError, match="power of two"):
        intersect.intersection_tile(tk[:, :96], tc, tk[:, :96], tc)


def write_fasta(path, codes):
    path.write_text(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    return str(path)


@pytest.fixture
def three_sketches(tmp_path):
    """The port's sketches of three small FASTAs (a genome, a 3% mutated
    copy, an unrelated one) and a JAX sketcher holding the same keys."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, 6000)
    mut = base.copy()
    hit = rng.random(mut.size) < 0.03
    mut[hit] = rng.integers(0, 4, int(hit.sum()))
    paths = [write_fasta(tmp_path / f"g{i}.fa", c) for i, c in
             enumerate((base, mut, rng.integers(0, 4, 4000)))]
    sk = FracMinHashSketcher(SketchConfig(window=12, k=8, scale=4),
                             device="cpu")
    sketches = sk.sketch_files(paths)
    jsk = JaxSketcher(JaxConfig(window=12, k=8, scale=4))
    jax_sketches = [JaxSketch(keys=s.keys, count=s.count, window=s.window,
                              mask=jsk.mask) for s in sketches]
    return sk, sketches, jsk, jax_sketches


def test_sketcher_probe_entries_match_jax(three_sketches):
    sk, sketches, jsk, jax_sketches = three_sketches
    assert all(s.count > 0 for s in sketches)
    order = [2, 0, 1]
    got = sk.intersections(sketches, [sketches[i] for i in order])
    want = jsk.intersections(jax_sketches, [jax_sketches[i] for i in order])
    np.testing.assert_array_equal(got, want)
    assert got[1] > 0                    # the genome meets its mutated copy
    with pytest.raises(ValueError, match="Mismatched pair-list lengths"):
        sk.intersections(sketches, sketches[:2])

    probe = sk.all_pairs_intersections_probe(sketches, tile=2)
    np.testing.assert_array_equal(probe, sk.all_pairs_intersections(sketches))
    np.testing.assert_array_equal(
        probe, jsk.all_pairs_intersections_probe(jax_sketches, tile=2))
