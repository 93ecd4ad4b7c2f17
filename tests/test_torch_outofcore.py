"""The port's out-of-core all-pairs schedule against the in-core route,
the JAX package's per-tile gram schedule and native merges, on the CPU
(the kernels' plain versions).

Inputs are made with numpy from a seed; every value is an integer, so
every comparison is exact (tolerance 0).  The budgets are shrunk so that
300 genomes of capacity 128 (three blocks, a ragged tail of 44) take the
out-of-core schedule with both column-cache hits and re-presorts.
"""
import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu.parallel.allpairs import (
    blocked_all_pairs as jax_blocked_all_pairs)

from spaced_kmer_sketching_tpu_torch import observability
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models import fracminhash
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher, Sketch)
from spaced_kmer_sketching_tpu_torch.parallel import allpairs
from spaced_kmer_sketching_tpu_torch.store import SketchStore
from spaced_kmer_sketching_tpu_torch.utils import native

from test_torch_gram import blocked_inputs

KEY_BITS = 40
ONE_BLOCK = 2 * 128 * 128 * 4      # one presorted block: pw 2, cap 128


@pytest.fixture(scope="module")
def collection():
    rng = np.random.default_rng(77)
    keys, counts = blocked_inputs(rng, 300, 128, KEY_BITS)
    want = allpairs.blocked_all_pairs(keys, key_bits=KEY_BITS, device="cpu")
    return keys, counts, want


def out_of_core(keys, **kw):
    observability.reset_counters()
    got = allpairs.blocked_all_pairs(keys, key_bits=KEY_BITS, device="cpu",
                                     budget_bytes=1,
                                     col_cache_bytes=ONE_BLOCK, **kw)
    c = observability.counters()
    return got, c.get("blocked_presorts", 0), c.get("blocked_cache_hits", 0)


def test_out_of_core_equals_in_core_jax_and_native(collection, monkeypatch):
    keys, counts, want = collection
    got, presorts, hits = out_of_core(keys)
    # row 0 presorts blocks 0-2 and caches block 1 only; row 1 reads it
    # and caches block 2 in its room; row 2 reads block 2
    assert (presorts, hits) == (4, 2)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("SKS_BLOCKED_CACHE_BUDGET", "1")
    jax_got = jax_blocked_all_pairs(None, keys, counts, block=128,
                                    engine="gram", key_words=2,
                                    key_bits=KEY_BITS)
    np.testing.assert_array_equal(got, jax_got)
    assert native.available()
    u64 = [Sketch(keys=keys[i, :c], count=int(c), window=20,
                  mask=None).keys_u64() for i, c in enumerate(counts)]
    for i in range(len(counts)):
        assert got[i, i] == counts[i]
        for j in range(i + 1, len(counts), 7):
            assert got[i, j] == got[j, i] == native.intersect_sorted(
                u64[i], u64[j])


def test_out_of_core_from_host_array_tensor_and_no_cache(collection):
    keys, _, want = collection
    got, presorts, hits = out_of_core(keys[:, :, :2].copy())
    np.testing.assert_array_equal(got, want)
    got, _, _ = out_of_core(torch.from_numpy(keys.view(np.int32)))
    np.testing.assert_array_equal(got, want)
    observability.reset_counters()
    got = allpairs.blocked_all_pairs(keys, key_bits=KEY_BITS, device="cpu",
                                     budget_bytes=1, col_cache_bytes=0)
    assert observability.counters()["blocked_presorts"] == 3 + 3
    np.testing.assert_array_equal(got, want)


def test_out_of_core_through_a_store_provider(collection, tmp_path):
    """Blocks stacked on demand from sketches read out of a SketchStore."""
    keys, counts, want = collection
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cpu")
    store = SketchStore(str(tmp_path / "st"))
    names = [f"genome{i}" for i in range(len(counts))]
    for name, k, c in zip(names, keys, counts):
        store.put(name, Sketch(keys=k[:c].copy(), count=int(c), window=20,
                               mask=sk.mask, name=name))
    reads = []

    def provider(i0, i1):
        reads.append((i0, i1))
        part = [store.get(n) for n in names[i0:i1]]
        return (fracminhash._stack_host(part, 128, 2),
                np.array([s.count for s in part], np.int32))
    got, _, _ = out_of_core(provider, g=len(counts))
    np.testing.assert_array_equal(got, want)
    assert (256, 300) in reads and max(b - a for a, b in reads) == 128
    with pytest.raises(ValueError, match="g="):
        allpairs.blocked_all_pairs(provider, key_bits=KEY_BITS, device="cpu")


def test_sketcher_stacks_blocks_on_demand_past_the_budget(collection,
                                                          monkeypatch):
    """all_pairs_intersections past the budget hands the blocked schedule
    a provider and never stacks the whole slab; in core it never stacks it
    either: each sketch is packed bit-tight from its own keys."""
    keys, counts, want = collection
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cpu")
    sketches = [Sketch(keys=keys[i, :c].copy(), count=int(c), window=20,
                       mask=sk.mask) for i, c in enumerate(counts)]
    monkeypatch.setattr(fracminhash, "ONDEVICE_MAX_GENOMES", 100)
    monkeypatch.setattr(allpairs, "CACHE_BUDGET_BYTES", 1 << 19)
    stacked = []
    orig = sk.stack_sketches
    monkeypatch.setattr(sk, "stack_sketches",
                        lambda s: (stacked.append(len(s)), orig(s))[1])
    np.testing.assert_array_equal(sk.all_pairs_intersections(sketches), want)
    assert stacked == []
    monkeypatch.setattr(allpairs, "CACHE_BUDGET_BYTES", 8 << 30)
    observability.reset_counters()
    np.testing.assert_array_equal(sk.all_pairs_intersections(sketches), want)
    assert stacked == []
    # three tight blocks of 128 x 32 groups of 5 words, and their counts
    assert observability.counters()["blocked_h2d_bytes"] == \
        3 * 128 * (32 * 5 + 1) * 4


def test_default_budgets_are_read_at_the_call(collection, monkeypatch):
    """A direct call with no budget arguments reads CACHE_BUDGET_BYTES and
    COL_CACHE_BYTES as they stand, as the sketcher does."""
    keys, _, want = collection
    monkeypatch.setattr(allpairs, "CACHE_BUDGET_BYTES", 1)
    monkeypatch.setattr(allpairs, "COL_CACHE_BYTES", ONE_BLOCK)
    observability.reset_counters()
    got = allpairs.blocked_all_pairs(keys, key_bits=KEY_BITS, device="cpu")
    c = observability.counters()
    assert (c["blocked_presorts"], c["blocked_cache_hits"]) == (4, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("g,words,in_place", [(256, 2, True),
                                               (256, 4, False),
                                               (300, 2, False)])
def test_in_core_presorts_an_aligned_tensor_in_place(collection, monkeypatch,
                                                     g, words, in_place):
    """A tensor of whole blocks at the guard words is presorted as it is;
    a ragged tail or wider words are copied into a slab first."""
    keys, _, want = collection
    t = torch.from_numpy(np.ascontiguousarray(keys[:g, :, :words]
                                              ).view(np.int32))
    slabs = []
    orig = allpairs.presort_blocks_packed
    monkeypatch.setattr(allpairs, "presort_blocks_packed",
                        lambda slab, **kw: (slabs.append(slab),
                                            orig(slab, **kw))[1])
    got = allpairs.blocked_all_pairs(t, key_bits=KEY_BITS)
    assert len(slabs) == 1
    assert (slabs[0].data_ptr() == t.data_ptr()) == in_place
    np.testing.assert_array_equal(got, want[:g, :g])


def test_a_full_sketch_of_32768_keys_keeps_its_count():
    """At capacity 32,768 a full sketch keeps its count of 32,768 on the
    int32 matrix's diagonal."""
    rng = np.random.default_rng(3)
    sizes = [32768, 20000, 100]
    keys = np.full((3, 32768, 2), 0xFFFFFFFF, np.uint32)
    u64 = []
    for i, n in enumerate(sizes):
        v = np.sort(rng.choice(1 << 20, n, replace=False)).astype(np.uint64)
        keys[i, :n, 0] = v.astype(np.uint32)
        keys[i, :n, 1] = 0
        u64.append(np.stack([v, np.zeros_like(v)], 1))
    got, presorts, _ = out_of_core(keys)
    assert presorts == 1
    np.testing.assert_array_equal(np.diag(got), sizes)
    for i in range(3):
        for j in range(i + 1, 3):
            assert got[i, j] == got[j, i] == native.intersect_sorted(u64[i],
                                                                     u64[j])
