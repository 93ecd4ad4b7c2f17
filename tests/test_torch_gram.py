"""The port's device all-pairs engine against the JAX package's, on the CPU.

Each module that holds a kernel (K5 merge_sorted_runs, K10
merge_pair_streams, K6 gram_tile_scan) is held, through its plain PyTorch
version, against the JAX function in Pallas interpret mode; the packing
glue, the whole Gram engine (gram_all_pairs_ondevice), the block-cache
schedule (blocked_all_pairs) and the sketcher's routing by genome count
against the JAX package and Python sets.  Inputs are made with numpy from
a seed.  Every value is an integer, so every comparison is exact
(tolerance 0).  These tests take ~65 s in one process.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher, Sketch as JaxSketch)
from spaced_kmer_sketching_tpu.ops import gram as jgram
from spaced_kmer_sketching_tpu.ops.pallas.gram_tiles import (
    gram_tile_scan_fused)
from spaced_kmer_sketching_tpu.ops.pallas.sort import (merge_pair_streams,
                                                       merge_sorted_runs)
from spaced_kmer_sketching_tpu.parallel.allpairs import (
    blocked_all_pairs as jax_blocked_all_pairs)

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models import fracminhash
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher, Sketch)
from spaced_kmer_sketching_tpu_torch.ops import gram
from spaced_kmer_sketching_tpu_torch.ops.cuda import build
from spaced_kmer_sketching_tpu_torch.ops.cuda.gram_tiles import (
    gram_tile_scan, gram_tile_scan_plain)
from spaced_kmer_sketching_tpu_torch.ops.cuda.sort import (
    merge_pair_streams_plain, merge_sorted_runs_plain)
from spaced_kmer_sketching_tpu_torch.parallel import allpairs

from test_gram_tiles_fused import _stream


def i32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def sketch_keys(rng, g, cap, key_bits, *, pool=400, per=150):
    """(g, cap, 4) uint32 sorted-unique sketches of key_bits-bit keys
    drawn from one shared pool (so runs are long), all-ones padded, and
    their Python key sets."""
    hi_bits = max(0, key_bits - 64)
    lo = rng.integers(0, 1 << min(key_bits, 63), pool, dtype=np.uint64)
    hi = rng.integers(0, 1 << min(hi_bits, 63), pool, dtype=np.uint64) \
        if hi_bits else np.zeros(pool, np.uint64)
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    sets = []
    for i in range(g):
        pick = np.unique(rng.choice(pool, min(per, cap), replace=False))
        order = np.lexsort((lo[pick], hi[pick]))
        l, h = lo[pick][order], hi[pick][order]
        c = l.size
        keys[i, :c, 0] = (l & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :c, 1] = (l >> np.uint64(32)).astype(np.uint32)
        keys[i, :c, 2] = (h & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :c, 3] = (h >> np.uint64(32)).astype(np.uint32)
        sets.append({(int(a), int(b)) for a, b in zip(l, h)})
    return keys, sets


def packed_runs(rng, nruns, run, key_bits, gidbits):
    """nruns ascending packed runs (one genome each) as JAX planes (a list
    of (rows, 128) uint32) and the port's stacked (pw, rows, 128) int32."""
    keys, _ = sketch_keys(rng, nruns, run, key_bits, pool=4 * run,
                          per=run - 17)
    kw = jgram._guard_words(key_bits)
    pw = jgram.pack_plan(key_bits, gidbits)
    gid = np.broadcast_to(np.arange(nruns, dtype=np.uint32)[:, None],
                          (nruns, run))
    planes = jgram._pack_gid_planes(jnp.asarray(keys[:, :, :kw]),
                                    jnp.asarray(gid), key_bits, gidbits, pw)
    jp = [p.reshape(nruns * run // 128, 128) for p in planes]
    return jp, i32(np.stack([np.asarray(p) for p in jp]))


@pytest.mark.parametrize("key_bits", [20, 32, 40, 64, 100, 128])
def test_pack_gid_planes_matches_jax(key_bits):
    """Including all-ones VALID key words at exact word multiples, which
    only the guard word tells from a sentinel."""
    rng = np.random.default_rng(key_bits)
    g, cap, gidbits = 6, 64, 5
    keys, _ = sketch_keys(rng, g, cap, key_bits, pool=200, per=40)
    kw = jgram._guard_words(key_bits)
    kw_in = (key_bits + 31) // 32
    if key_bits % 32 == 0 and key_bits < 128:
        keys[0, 0, :kw_in] = 0xFFFFFFFF       # valid: guard word is 0
        keys[0, 0, kw_in:] = 0
    pw = jgram.pack_plan(key_bits, gidbits)
    gid = rng.integers(0, 1 << gidbits, (g, cap)).astype(np.uint32)
    want = jgram._pack_gid_planes(jnp.asarray(keys[:, :, :kw]),
                                  jnp.asarray(gid), key_bits, gidbits, pw)
    got = gram._pack_gid_planes(i32(keys[:, :, :kw]), torch.from_numpy(
        gid.astype(np.int64)), key_bits, gidbits, pw)
    assert got.shape == (pw, g, cap) and got.dtype == torch.int32
    for q in range(pw):
        np.testing.assert_array_equal(u32(got[q]), np.asarray(want[q]))
    assert gram.pack_plan(key_bits, gidbits) == pw
    assert gram._guard_words(key_bits) == kw
    for window in (10, 16, 20, 31, 32, 48, 64):
        assert gram.key_words_for_window(window) == \
            jgram.key_words_for_window(window)


@pytest.mark.parametrize("key_bits,gidbits", [(40, 4), (128, 4)])
def test_merge_sorted_runs_plain_matches_pallas(key_bits, gidbits):
    """16 runs of 256 entries, pw 2 (40-bit keys) and pw 5 (128-bit)."""
    rng = np.random.default_rng(key_bits)
    jp, tp = packed_runs(rng, 16, 256, key_bits, gidbits)
    pw = len(jp)
    assert pw == (2 if key_bits == 40 else 5)
    want = merge_sorted_runs(jp, 2, interpret=True, nkeys=pw)
    got = merge_sorted_runs_plain(tp, 2)
    for q in range(pw):
        np.testing.assert_array_equal(u32(got[q]), np.asarray(want[q]))


@pytest.mark.parametrize("key_bits", [40, 128])
def test_merge_pair_streams_plain_matches_pallas(key_bits):
    rng = np.random.default_rng(3 + key_bits)
    ja, ta = packed_runs(rng, 1, 1024, key_bits, 8)
    jb, tb = packed_runs(rng, 1, 1024, key_bits, 8)
    pw = len(ja)
    want = merge_pair_streams(ja, jb, interpret=True, nkeys=pw)
    got = merge_pair_streams_plain(ta, tb)
    assert got.shape == (pw, 16, 128)
    for q in range(pw):
        np.testing.assert_array_equal(u32(got[q]), np.asarray(want[q]))


@pytest.mark.parametrize("seed,g,cap,key_bits,universe", [
    (0, 8, 256, 20, 128),
    (1, 16, 128, 16, 64),
    (2, 8, 256, 33, 1024),
    (3, 4, 512, 24, 16),
    (4, 8, 256, 60, 128),
])
def test_gram_tile_scan_plain_matches_jax(seed, g, cap, key_bits, universe):
    """The streams of tests/test_gram_tiles_fused.py (runs straddling
    chunk and grid-step boundaries), full and split at 128, against the
    fused Pallas kernel and the XLA chunk scan."""
    rng = np.random.default_rng(seed)
    gidbits = max(2, (g - 1).bit_length() + 1)
    sw, sets = _stream(rng, g, cap, key_bits, gidbits, universe)
    gp = 256
    xla = np.asarray(jgram._gram_chunks_packed(sw, gidbits, gp, 128,
                                               binner=8))
    fused = np.asarray(gram_tile_scan_fused(sw, gidbits, gp, sb=8,
                                            interpret=True))
    rect = np.asarray(gram_tile_scan_fused(sw, gidbits, gp, split=128,
                                           sb=8, interpret=True))
    port_sw = i32(np.stack([np.asarray(w) for w in sw]))
    got = gram_tile_scan_plain(port_sw, gidbits, gp)
    assert got.dtype == torch.int32 and got.shape == (gp, gp)
    np.testing.assert_array_equal(got.numpy(), fused.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), xla.astype(np.int64))
    got_rect = gram_tile_scan(port_sw.reshape(len(sw), -1, 128), gidbits,
                              gp, split=128)
    np.testing.assert_array_equal(got_rect.numpy(), rect.astype(np.int64))
    brute = np.array([[len(a & b) for b in sets] for a in sets])
    np.testing.assert_array_equal(got.numpy()[:g, :g], brute)


def test_gram_tile_scan_one_key_in_every_genome():
    """One key shared by 200 genomes: a run of 200 entries spanning
    several 128-entry chunks and both sides of the split."""
    g, gidbits, key_bits = 200, 8, 40
    pw = gram.pack_plan(key_bits, gidbits)
    keys = np.full((g, 128, 4), 0xFFFFFFFF, np.uint32)
    keys[:, :2, 0] = [[5, 9]]
    keys[:, :2, 1:] = 0
    keys[::3, 1] = 0xFFFFFFFF                 # key 9 in every third genome
    gid = torch.arange(g)[:, None].expand(g, 128)
    planes = gram._pack_gid_planes(i32(keys[:, :, :2]), gid, key_bits,
                                   gidbits, pw)
    sw = merge_sorted_runs_plain(planes.reshape(pw, g, 128), 1)
    got = gram_tile_scan(sw, gidbits, 256).numpy()
    has9 = (np.arange(g) % 3 != 0).astype(np.int64)
    want = 1 + np.outer(has9, has9)
    np.testing.assert_array_equal(got[:g, :g], want)
    assert got[g:].sum() == 0 and got[:, g:].sum() == 0
    np.testing.assert_array_equal(
        gram_tile_scan(sw, gidbits, 256, split=128).numpy(), got[:128, 128:])


def test_gram_pair_tiles_matches_jax():
    """Presorted block cache + macro-tiles (gram_pair_tile, incl. the
    diagonal tile and an empty sketch) against the JAX programs
    (gram_pair_tiles) in interpret mode."""
    rng = np.random.default_rng(71)
    blk, cap, nb, key_bits, gidbits = 128, 128, 2, 62, 8
    keys, _ = sketch_keys(rng, nb * blk, cap, key_bits, pool=300, per=60)
    keys[5] = 0xFFFFFFFF
    kw = jgram._guard_words(key_bits)
    pw = jgram.pack_plan(key_bits, gidbits)
    jcache = jnp.stack([
        jgram.presort_block_packed(jnp.asarray(keys[b * blk:(b + 1) * blk]),
                                   key_bits=key_bits, gidbits=gidbits, pw=pw,
                                   interpret=True) for b in range(nb)])
    tcache = gram.presort_blocks_packed(i32(keys[:, :, :kw]), block=blk,
                                        key_bits=key_bits, gidbits=gidbits,
                                        pw=pw)
    np.testing.assert_array_equal(u32(tcache), np.asarray(jcache))
    ii, jj = [0, 0, 1], [1, 0, 1]
    want = np.asarray(jgram.gram_pair_tiles(
        jcache, jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
        block=blk, gidbits=gidbits, interpret=True))
    got = torch.stack([gram.gram_pair_tile(tcache[i], tcache[j], block=blk,
                                           gidbits=gidbits)
                       for i, j in zip(ii, jj)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1, 5].sum() == 0 and got[1, :, 5].sum() == 0


@pytest.mark.parametrize("g,cap", [(9, 128), (12, 256)])
def test_gram_all_pairs_ondevice_matches_jax_and_sets(g, cap):
    """Including an empty sketch and an identical pair; 64-bit keys at a
    word multiple (the guard word decides sentinels)."""
    rng = np.random.default_rng(g)
    keys, sets = sketch_keys(rng, g, cap, 64, pool=300, per=cap // 2)
    keys[2] = 0xFFFFFFFF
    sets[2] = set()
    keys[g - 1] = keys[1]
    sets[g - 1] = sets[1]
    counts = np.array([len(s) for s in sets], np.int32)
    want = np.asarray(jgram.gram_all_pairs_ondevice(
        jnp.asarray(keys), jnp.asarray(counts), key_words=3, key_bits=64,
        interpret=True))
    got = gram.gram_all_pairs_ondevice(i32(keys), key_bits=64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    brute = np.array([[len(a & b) for b in sets] for a in sets])
    np.testing.assert_array_equal(got.numpy(), brute)
    assert got[2].sum() == 0 and got[g - 1, 1] == got[1, 1] == counts[1]


def blocked_inputs(rng, g, cap, key_bits):
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    pool = np.unique(rng.integers(0, 1 << key_bits, 4000).astype(np.uint64))
    for i in range(g):
        vals = np.unique(rng.choice(pool, 100))
        counts[i] = vals.size
        keys[i, :vals.size, 0] = (vals & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :vals.size, 1] = (vals >> np.uint64(32)).astype(np.uint32)
        keys[i, :vals.size, 2:] = 0
    return keys, counts


def test_blocked_all_pairs_matches_jax():
    """G = 300: three blocks, the last a ragged tail of 44."""
    rng = np.random.default_rng(77)
    g, cap, kb = 300, 128, 40
    keys, counts = blocked_inputs(rng, g, cap, kb)
    want = jax_blocked_all_pairs(None, keys, counts, block=128,
                                 engine="gram", key_words=2, key_bits=kb)
    got = allpairs.blocked_all_pairs(i32(keys), key_bits=kb)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got), counts)


def test_blocked_all_pairs_over_budget_raises(monkeypatch):
    """Past the device budget the schedule runs out of core and gives
    the in-core matrix (the name is kept from when this case raised)."""
    rng = np.random.default_rng(81)
    keys, counts = blocked_inputs(rng, 130, 128, 40)
    want = allpairs.blocked_all_pairs(i32(keys), key_bits=40)
    got = allpairs.blocked_all_pairs(i32(keys), key_bits=40,
                                     budget_bytes=1024)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got), counts)


def as_sketches(keys, counts, window, mask, cls):
    return [cls(keys=keys[i, :c].copy(), count=int(c), window=window,
                mask=mask) for i, c in enumerate(counts)]


def test_routing_by_genome_count(monkeypatch):
    """G <= 8 with the native library: host merge; up to 2048: the device
    Gram; above: the blocked schedule (block 128, key_bits 2 * window)."""
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cpu")
    calls = []

    def ondevice(keys, **kw):
        calls.append(("ondevice", keys.shape, kw))
        return torch.zeros((keys.shape[0],) * 2, dtype=torch.int32)

    def blocked(keys, **kw):
        # the host sketches: a provider of key words and a tight packer
        g = kw.pop("g")
        assert callable(kw.pop("pack")) and kw.pop("device") == sk.device
        calls.append(("blocked", keys(0, g)[0].shape, kw))
        return np.zeros((g, g), np.int32)

    monkeypatch.setattr(fracminhash, "gram_all_pairs_ondevice", ondevice)
    monkeypatch.setattr(fracminhash, "blocked_all_pairs", blocked)
    empty = Sketch(keys=np.empty((0, 4), np.uint32), count=0, window=20,
                   mask=sk.mask)
    for g in (8, 9, 2048, 2049):
        sk.all_pairs_intersections([empty] * g)
    assert calls == [
        ("ondevice", (9, 128, 2), {"key_bits": 40}),
        ("ondevice", (2048, 128, 2), {"key_bits": 40}),
        ("blocked", (2049, 128, 2), {"key_bits": 40})]


def test_blocked_route_matches_jax(monkeypatch):
    """The sketcher's blocked route, reached by lowering the genome
    threshold, equals the JAX sketcher's matrix."""
    rng = np.random.default_rng(5)
    keys, counts = blocked_inputs(rng, 140, 128, 40)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cpu")
    monkeypatch.setattr(fracminhash, "ONDEVICE_MAX_GENOMES", 100)
    got = sk.all_pairs_intersections(
        as_sketches(keys, counts, 20, sk.mask, Sketch))
    jsk = JaxSketcher(JaxConfig(window=20, k=16))
    want = jsk.all_pairs_intersections(
        as_sketches(keys, counts, 20, jsk.mask, JaxSketch))
    np.testing.assert_array_equal(got, want)


def test_without_native_small_g_takes_the_gram(monkeypatch):
    """With the native library missing the JAX sketcher sends G <= 8 to its
    Gram engine (models/fracminhash.py:656); so does the port, which
    raised before."""
    rng = np.random.default_rng(9)
    keys, counts = blocked_inputs(rng, 3, 128, 40)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cpu")
    jsk = JaxSketcher(JaxConfig(window=20, k=16))
    from spaced_kmer_sketching_tpu.models import fracminhash as jfm
    monkeypatch.setattr(fracminhash.native, "available", lambda: False)
    monkeypatch.setattr(jfm.native, "available", lambda: False)
    build.reset_launches()
    got = sk.all_pairs_intersections(
        as_sketches(keys, counts, 20, sk.mask, Sketch))
    want = jsk.all_pairs_intersections(
        as_sketches(keys, counts, 20, jsk.mask, JaxSketch))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got), counts)
    assert all(k.launches == 0 for k in build.KERNELS.values())
