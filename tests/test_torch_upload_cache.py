"""The port's per-genome upload cache (models/fracminhash.py) against the
JAX sketcher.

A genome's upload (2-bit words and run ends) serves every (window, k)
config of a sweep: the cache is keyed by content, bucket width and device,
bounded by UPLOAD_CACHE_BYTES, and never written by the step.  The port
runs on the CPU (the kernels' plain versions); every comparison is exact.
"""
import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs as JaxPacked
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher)

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
from spaced_kmer_sketching_tpu_torch.models import fracminhash as fm
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.observability import counters
from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import pack2bit_rows

CPU = torch.device("cpu")
N = 16384
# (window, k): finish_words 1, 2, 3 and 4
SWEEP = ((14, 9), (24, 16), (40, 24), (60, 40))


@pytest.fixture(autouse=True)
def fresh_cache():
    fm.clear_upload_cache()
    yield
    fm.clear_upload_cache()


def genome(seed: int, runs: int = 12, lo: int = 5, hi: int = 900):
    """Codes and run lengths of a genome cut by N-runs, some runs shorter
    than the windows."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, runs).astype(np.int64)
    return PackedSeqs(rng.integers(0, 4, int(lens.sum())).astype(np.uint8),
                      lens)


def up(pk: PackedSeqs, n: int = N, device: torch.device = CPU):
    """One genome's upload through the cache."""
    return fm.upload_genomes([pk], n, device)[0]


def key(pk: PackedSeqs) -> tuple:
    return fm.upload_cache_keys([pk], N, CPU)[0]


def cache_counts() -> dict:
    c = counters()
    return {k: c.get(f"upload_cache_{k}", 0)
            for k in ("hits", "misses", "h2d_bytes")}


def delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in cache_counts().items()}


def host_planes(genomes, n):
    """The batch step's inputs built on the host with a loop over runs:
    the (G, n/16) code words and the (G, n) run-id plane."""
    codes = np.zeros((len(genomes), n), np.uint8)
    rid = np.full((len(genomes), n), -1, np.int32)
    for j, pk in enumerate(genomes):
        codes[j, :pk.codes.size] = pk.codes
        pos = 0
        for r, ln in enumerate(pk.run_lens):
            rid[j, pos:pos + int(ln)] = r
            pos += int(ln)
    return pack2bit_rows(codes).view(np.int32), rid


def test_upload_cache_identity_and_eviction(monkeypatch):
    """Equal content returns the same tensors; a flipped code, moved run
    boundaries, another bucket or another device a new entry; a budget of
    3.5 entries keeps the three newest (a hit refreshes an entry), one
    below an entry keeps the newest alone, and 0 caches nothing."""
    monkeypatch.setattr(fm, "UPLOAD_CACHE_BYTES", 1 << 30)
    monkeypatch.setattr(fm, "_DIGEST_PIECE", 1000)   # 5 pieces, 1 partial
    pk = genome(0, runs=1, lo=4096, hi=4097)
    a = up(pk)
    b = up(PackedSeqs(pk.codes.copy(), pk.run_lens.copy()))
    assert b is a and b.words is a.words and b.ends is a.ends
    for i in (7, 4095):
        flipped = pk.codes.copy()
        flipped[i] ^= 1
        c = up(PackedSeqs(flipped, pk.run_lens))
        assert c.words is not a.words
        assert not torch.equal(c.words, a.words)
    moved = up(PackedSeqs(pk.codes, np.array([2048, 2048])))
    assert moved.words is not a.words
    assert torch.equal(moved.words, a.words)
    assert moved.ends.tolist() == [2048, 4096] and a.ends.tolist() == [4096]
    assert up(pk, 2 * N).words.shape == (2 * N // 16,)
    assert up(pk, N, torch.device("cpu:0")) is not a
    assert len(fm._UPLOAD_CACHE) == 6

    fm.clear_upload_cache()
    monkeypatch.setattr(fm, "UPLOAD_CACHE_BYTES", int(a.nbytes * 3.5))
    gs = [PackedSeqs(np.full(4096, i % 4, np.uint8) ^ (np.arange(4096) == i),
                     np.array([4096])) for i in range(5)]
    ups = [up(g) for g in gs[:3]]
    assert up(gs[0]) is ups[0]     # refreshed
    for g in gs[3:]:
        up(g)
    held = [key(g) for g in (gs[0], gs[3], gs[4])]
    assert list(fm._UPLOAD_CACHE) == held
    assert fm._upload_cache_held == 3 * a.nbytes

    monkeypatch.setattr(fm, "UPLOAD_CACHE_BYTES", a.nbytes - 1)
    up(gs[1])
    assert list(fm._UPLOAD_CACHE) == [key(gs[1])]

    monkeypatch.setattr(fm, "UPLOAD_CACHE_BYTES", 0)
    before = cache_counts()
    e = up(gs[1])
    f = up(gs[1])
    assert e is not f and e.words is not f.words
    assert torch.equal(e.words, f.words)
    assert delta(before) == {"hits": 0, "misses": 2,
                             "h2d_bytes": 2 * a.nbytes}


def test_stacked_inputs_equal_host_planes():
    """The step's inputs stacked from the uploads are bit for bit the host
    planes, with zero-length runs first, inside and last, and new tensors
    that share no memory with the cache."""
    gs = [genome(1), genome(2, runs=3),
          PackedSeqs(genome(3, runs=4).codes[:1200],
                     np.array([0, 500, 0, 700, 0], np.int64))]
    ups = [up(g) for g in gs]
    packed, rid = fm._stack_uploads(ups, N)
    want_packed, want_rid = host_planes(gs, N)
    assert packed.dtype == rid.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    np.testing.assert_array_equal(rid.numpy(), want_rid)
    for u in ups:
        assert not packed.untyped_storage().data_ptr() == \
            u.words.untyped_storage().data_ptr()


def sweep(genomes):
    """The sketches of SWEEP's configs, one sketcher a config as the
    driver's sweep builds them, and each config's cache counter deltas."""
    out, deltas = [], []
    for window, k in SWEEP:
        before = cache_counts()
        sk = FracMinHashSketcher(SketchConfig(window=window, k=k, scale=8),
                                 device="cpu")
        out.append(sk.sketch_packed_batch(genomes))
        deltas.append(delta(before))
    return out, deltas


def test_mini_sweep_equals_jax_and_no_cache(monkeypatch):
    """Three genomes with N-runs over four configs (finish_words 1-4):
    configs 2-4 take every genome from the cache, and the sketches equal
    the sweep's with the cache disabled and the JAX sketcher's."""
    genomes = [genome(10), genome(11, runs=20), genome(12, runs=6)]
    cached, deltas = sweep(genomes)
    sent = sum(up(g).nbytes for g in genomes)
    assert deltas[0] == {"hits": 0, "misses": 3, "h2d_bytes": sent}
    assert deltas[1:] == [{"hits": 3, "misses": 0, "h2d_bytes": 0}] * 3
    assert len(fm._UPLOAD_CACHE) == 3

    monkeypatch.setattr(fm, "UPLOAD_CACHE_BYTES", 0)
    plain, deltas = sweep(genomes)
    assert deltas == [{"hits": 0, "misses": 3, "h2d_bytes": sent}] * 4
    jax_packed = [JaxPacked(g.codes, g.run_lens) for g in genomes]
    for (window, k), a, b in zip(SWEEP, cached, plain):
        want = JaxSketcher(JaxConfig(window=window, k=k, scale=8)) \
            .sketch_packed_batch(jax_packed)
        for x, y, z in zip(a, b, want):
            assert x.count == y.count == z.count > 0
            np.testing.assert_array_equal(x.keys, y.keys)
            np.testing.assert_array_equal(x.keys, z.keys)


def test_cached_uploads_unchanged_by_sketching_and_retry():
    """Two sketches from the cache, the second at a capacity that sends
    one genome through the overflow retry (index_select of the stacked
    inputs), leave the cached tensors bit for bit as packed."""
    rng = np.random.default_rng(23)
    genomes = [PackedSeqs(rng.integers(0, 4, 5000).astype(np.uint8),
                          np.array([2000, 3000])),
               PackedSeqs(rng.integers(0, 4, 600).astype(np.uint8),
                          np.array([600]))]
    cfg = dict(window=14, k=9, scale=4)
    first = FracMinHashSketcher(SketchConfig(**cfg), device="cpu") \
        .sketch_packed_batch(genomes)
    ups = [up(g) for g in genomes]
    snap = [(u.words.clone(), u.ends.clone()) for u in ups]
    retry = FracMinHashSketcher(SketchConfig(**cfg, sketch_capacity=256),
                                device="cpu")
    raws = retry._dispatch_sketch(genomes, N, 256)[0].raw_kept.numpy()
    assert raws[0] > 256 >= raws[1]          # only genome 0 overflows
    second = retry.sketch_packed_batch(genomes)
    assert second[0].count > 256
    for a, b in zip(first, second):
        assert a.count == b.count
        np.testing.assert_array_equal(a.keys, b.keys)
    for g, u, (w, e) in zip(genomes, ups, snap):
        assert up(g) is u
        assert torch.equal(u.words, w) and torch.equal(u.ends, e)
    np.testing.assert_array_equal(torch.stack([u.words for u in ups]).numpy(),
                                  host_planes(genomes, N)[0])
