"""The port's bit-tight slab transport (ops/gram.py, K12 in
ops/cuda/tight.py, the blocked schedule's tight route) against the JAX
package's, on the CPU.

The host packer on its native and numpy paths, the plain unpack, K12's
plain version and the tight presort are held to the JAX functions (the
presort in Pallas interpret mode); blocked_all_pairs by both transports
to each other, to JAX's block-cache schedule and to native merges, and
the sketcher's blocked route to the JAX sketcher.  Inputs are made with
numpy from a seed.  Every value is an integer, so every comparison is
exact (tolerance 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher, Sketch as JaxSketch)
from spaced_kmer_sketching_tpu.ops import gram as jgram
from spaced_kmer_sketching_tpu.parallel.allpairs import (
    blocked_all_pairs as jax_blocked_all_pairs)

from spaced_kmer_sketching_tpu_torch import observability
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models import fracminhash
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher, Sketch)
from spaced_kmer_sketching_tpu_torch.ops import gram
from spaced_kmer_sketching_tpu_torch.ops.cuda import build, tight
from spaced_kmer_sketching_tpu_torch.parallel import allpairs
from spaced_kmer_sketching_tpu_torch.utils import native

from test_torch_distributed import _Guard, _Lib
from test_torch_gram import blocked_inputs, i32, sketch_keys, u32

CAP = 64


def tight_inputs(rng, key_bits, g=5, cap=CAP):
    """(g, cap, 4) uint32 keys with bits above key_bits and past each
    count (the packers must drop both), and counts 0, ragged and cap."""
    keys = rng.integers(0, 1 << 32, (g, cap, 4), dtype=np.uint64).astype(
        np.uint32)
    counts = np.array([0, 37, cap, 1, cap - 1][:g], np.int32)
    return keys, counts


def clean_slab(rng, key_bits, g=6, cap=CAP):
    """Sketch-shaped keys: key_bits live bits, all-ones past each count
    (0, ragged and cap), zero words above the key's bits."""
    keys, counts = tight_inputs(rng, key_bits, g, cap)
    counts = np.array([0, 37, cap, 1, cap - 1, 12][:g], np.int32)
    v = keys[:, :, 0].astype(np.uint64) | (
        keys[:, :, 1].astype(np.uint64) << np.uint64(32))
    if key_bits < 64:
        v &= (np.uint64(1) << np.uint64(key_bits)) - np.uint64(1)
    keys[:, :, 0] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    keys[:, :, 1] = (v >> np.uint64(32)).astype(np.uint32)
    keys[:, :, 2:] = 0
    keys[np.arange(cap)[None, :] >= counts[:, None]] = 0xFFFFFFFF
    return keys, counts


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("key_bits", [16, 40, 63, 64])
def test_pack_keys_tight_matches_jax(use_native, key_bits):
    keys, counts = tight_inputs(np.random.default_rng(key_bits), key_bits)
    assert native.available()
    want = jgram.pack_keys_tight_np(keys, counts, key_bits,
                                    use_native=use_native)
    got = gram.pack_keys_tight_np(keys, counts, key_bits,
                                  use_native=use_native)
    assert got.dtype == np.uint32
    assert got.shape == (5, CAP // 4, gram.tight_words4(key_bits))
    np.testing.assert_array_equal(got, want)
    assert gram.tight_words4(key_bits) == jgram.tight_words4(key_bits)


@pytest.mark.parametrize("use_native", [True, False])
def test_one_sketch_packs_from_its_own_keys(use_native):
    """Each sketch packed into its row of a slab from its own (count, W)
    keys, as the sketcher packs them, == JAX's packing of the stacked
    slab."""
    key_bits = 40
    keys, counts = tight_inputs(np.random.default_rng(3), key_bits)
    want = jgram.pack_keys_tight_np(keys, counts, key_bits)
    out = np.zeros_like(want)
    for j, c in enumerate(counts):
        r = gram.pack_keys_tight_np(keys[j, :c][None], counts[j:j + 1],
                                    key_bits, use_native=use_native,
                                    out=out[j:j + 1])
        assert np.shares_memory(r, out)
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError):
        gram.pack_keys_tight_np(keys, counts, 70)


@pytest.mark.parametrize("key_bits", [40, 64])
@pytest.mark.parametrize("kw_out", [2, 3])
def test_unpack_keys_tight_matches_jax_and_round_trips(key_bits, kw_out):
    keys, counts = clean_slab(np.random.default_rng(kw_out), key_bits)
    packed = jgram.pack_keys_tight_np(keys, counts, key_bits)
    want = np.asarray(jgram.unpack_keys_tight(
        jnp.asarray(packed), jnp.asarray(counts), key_bits, kw_out))
    got = gram.unpack_keys_tight(i32(packed), torch.from_numpy(counts),
                                 key_bits, kw_out)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(u32(got), keys[:, :, :kw_out])


@pytest.mark.parametrize("key_bits", [16, 40, 64])
def test_k12_plain_matches_jax_unpack_and_pack(key_bits):
    """K12's plain version == JAX's _pack_gid_planes(unpack_keys_tight(...))
    with the row as gid, as its presort composes them."""
    gidbits = 8
    keys, counts = clean_slab(np.random.default_rng(key_bits), key_bits)
    packed = jgram.pack_keys_tight_np(keys, counts, key_bits)
    pw = jgram.pack_plan(key_bits, gidbits)
    g, cap = keys.shape[:2]
    full = jgram.unpack_keys_tight(jnp.asarray(packed), jnp.asarray(counts),
                                   key_bits, jgram._guard_words(key_bits))
    gid = jnp.broadcast_to(jnp.arange(g, dtype=jnp.uint32)[:, None],
                           (g, cap))
    want = np.stack([np.asarray(p).reshape(-1, 128) for p in
                     jgram._pack_gid_planes(full, gid, key_bits, gidbits,
                                            pw)])
    args = (i32(packed), torch.from_numpy(counts))
    kw = dict(key_bits=key_bits, gidbits=gidbits, pw=pw)
    got = tight.tight_gid_planes_plain(*args, **kw)
    np.testing.assert_array_equal(u32(got), want)
    # a CPU tensor takes the plain version and counts no launch
    build.reset_launches()
    np.testing.assert_array_equal(u32(tight.tight_gid_planes(*args, **kw)),
                                  want)
    assert build.KERNELS["K12"].launches == 0


@pytest.mark.parametrize("bad", [dict(pw=3), dict(key_bits=70, pw=3),
                                 dict(gidbits=2, pw=2)])
def test_k12_refuses_what_it_does_not_compute(bad):
    """pw other than the pack plan, keys over 64 bits, more rows than
    gids: a ValueError, not a wrong plane."""
    keys, counts = clean_slab(np.random.default_rng(0), 40)
    packed = gram.pack_keys_tight_np(keys, counts, 40)
    kw = {**dict(key_bits=40, gidbits=8, pw=2), **bad}
    with pytest.raises(ValueError):
        tight.tight_gid_planes(i32(packed), torch.from_numpy(counts), **kw)


def test_k12_wrapper_launches_under_the_tensors_device(monkeypatch):
    """On tensors that do not lie on the CPU the wrapper launches K12,
    only while their device is the current one, and counts the launch."""
    lib = _Lib()
    monkeypatch.setattr(build, "lib", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    saved = build.KERNELS["K12"].launches
    try:
        out = tight.tight_gid_planes(
            torch.empty((128, 32, 5), dtype=torch.int32, device="meta"),
            torch.empty(128, dtype=torch.int32, device="meta"),
            key_bits=40, gidbits=8, pw=2)
        assert build.KERNELS["K12"].launches == saved + 1
    finally:
        build.KERNELS["K12"].launches = saved
    assert out.shape == (2, 128, 128) and out.device.type == "meta"
    assert lib.calls == [("sks_tight_gid_planes", torch.device("meta"))]


def test_presort_blocks_tight_matches_jax():
    """Two blocks of 128 sketches of capacity 128 (an empty one, a full
    one): the tight presort == JAX's in interpret mode == the word
    presort of the unpacked slab."""
    rng = np.random.default_rng(11)
    blk, cap, key_bits, gidbits = 128, 128, 40, 8
    keys, counts = blocked_inputs(rng, 2 * blk, cap, key_bits)
    keys[7], counts[7] = 0xFFFFFFFF, 0
    keys[9, :, :2] = keys[9, 0, :2]           # a full sketch of one key ...
    vals = np.arange(cap, dtype=np.uint64) * np.uint64(977)
    keys[9, :, 0] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    keys[9, :, 1], counts[9] = 0, cap         # ... of cap distinct keys
    packed = jgram.pack_keys_tight_np(keys, counts, key_bits)
    pw = jgram.pack_plan(key_bits, gidbits)
    want = np.asarray(jgram.presort_blocks_tight(
        jnp.asarray(packed), jnp.asarray(counts), block=blk,
        key_bits=key_bits, gidbits=gidbits, pw=pw, interpret=True))
    got = gram.presort_blocks_tight(i32(packed), torch.from_numpy(counts),
                                    block=blk, key_bits=key_bits,
                                    gidbits=gidbits, pw=pw)
    np.testing.assert_array_equal(u32(got), want)
    words = gram.presort_blocks_packed(i32(keys[:, :, :2]), block=blk,
                                       key_bits=key_bits, gidbits=gidbits,
                                       pw=pw)
    np.testing.assert_array_equal(u32(got), u32(words))


# --- the blocked schedule's two transports -----------------------------------

TIGHT_BYTES = 3 * 128 * (32 * 5 + 1) * 4     # 3 blocks' tight words, counts
WORD_BYTES = 300 * 128 * 2 * 4               # 300 sketches' two key words


@pytest.fixture(scope="module")
def collection():
    keys, counts = blocked_inputs(np.random.default_rng(77), 300, 128, 40)
    want = jax_blocked_all_pairs(None, keys, counts, block=128,
                                 engine="gram", key_words=2, key_bits=40)
    return keys, counts, want


def run_blocked(keys, **kw):
    observability.reset_counters()
    got = allpairs.blocked_all_pairs(keys, key_bits=40, device="cpu", **kw)
    return got, observability.counters().get("blocked_h2d_bytes", 0)


@pytest.mark.parametrize("source", ["array", "array with counts",
                                    "provider"])
def test_blocked_all_pairs_transports_match_jax(collection, source):
    """G = 300 (a ragged tail of 44): the tight and word transports from a
    host array (counts from the padding, or given) and from a provider ==
    each other == JAX's block-cache schedule; the default is tight."""
    keys, counts, want = collection
    kw = {"array": {}, "array with counts": {"counts": counts},
          "provider": {"g": 300}}[source]
    src = (lambda i0, i1: (keys[i0:i1], counts[i0:i1])) \
        if source == "provider" else keys
    got = {t: run_blocked(src, transport=t, **kw)
           for t in (None, "tight", "words")}
    for t, (mat, _) in got.items():
        assert mat.dtype == np.int32
        np.testing.assert_array_equal(mat, want, err_msg=str(t))
    assert got[None][1] == got["tight"][1] == TIGHT_BYTES
    assert got["words"][1] == WORD_BYTES


def test_tight_transport_with_a_packer_and_a_mesh(collection):
    """A pack hook replaces the provider's keys; over a mesh of two
    distinct devices each gets the tight blocks (twice the bytes)."""
    from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
    keys, counts, want = collection

    def pack(i0, i1, out):
        gram.pack_keys_tight_np(keys[i0:i1], counts[i0:i1], 40, out=out)
        return counts[i0:i1]

    def provider(i0, i1):        # read for the capacity only
        assert i0 == 0
        return keys[i0:i1], counts[i0:i1]
    got, sent = run_blocked(provider, g=300, pack=pack)
    np.testing.assert_array_equal(got, want)
    assert sent == TIGHT_BYTES
    two = make_mesh(devices=["cpu", "cpu:0"])
    got, sent = run_blocked(keys, mesh=two)
    np.testing.assert_array_equal(got, want)
    assert sent == 2 * TIGHT_BYTES


def test_tensors_and_out_of_core_keep_the_word_transport(collection):
    """A tensor is on its device already and the out-of-core schedule
    uploads words: both refuse transport="tight" and give the matrix."""
    keys, _, want = collection
    t = i32(keys[:, :, :2])
    np.testing.assert_array_equal(run_blocked(t)[0], want)
    got, sent = run_blocked(keys, budget_bytes=1)
    np.testing.assert_array_equal(got, want)
    assert sent == WORD_BYTES                # the column cache holds all
    for src, kw in ((t, {}), (keys, {"budget_bytes": 1})):
        with pytest.raises(ValueError, match="tight"):
            run_blocked(src, transport="tight", **kw)
    with pytest.raises(ValueError, match="transport"):
        run_blocked(keys, transport="bits")


def test_key_bits_70_takes_words_where_the_reference_asserts():
    """Above 64 key bits the port uploads words and gives the native
    merges' matrix; JAX's block-cache schedule picks its tight layout
    there and its packer raises AssertionError (ops/gram.py:537)."""
    rng = np.random.default_rng(70)
    keys, sets = sketch_keys(rng, 130, 128, 70, pool=300, per=60)
    counts = np.array([len(s) for s in sets], np.int32)
    observability.reset_counters()
    got = allpairs.blocked_all_pairs(keys, key_bits=70, device="cpu")
    assert observability.counters()["blocked_h2d_bytes"] == 130 * 128 * 3 * 4
    u64 = [Sketch(keys=keys[i, :c], count=int(c), window=35,
                  mask=None).keys_u64() for i, c in enumerate(counts)]
    for i in range(len(counts)):
        assert got[i, i] == counts[i]
        for j in range(i + 1, len(counts)):
            assert got[i, j] == got[j, i] == native.intersect_sorted(
                u64[i], u64[j])
    with pytest.raises(ValueError, match="tight"):
        allpairs.blocked_all_pairs(keys, key_bits=70, device="cpu",
                                   transport="tight")
    with pytest.raises(AssertionError):
        jax_blocked_all_pairs(None, keys, counts, block=128, engine="gram",
                              key_bits=70)


@pytest.mark.parametrize("window,sent", [(20, 2 * 128 * (32 * 5 + 1) * 4),
                                         (40, 140 * 128 * 3 * 4)])
def test_sketcher_blocked_route_matches_jax(monkeypatch, window, sent):
    """The sketcher's G > 2048 route (threshold lowered): at window 20 each
    sketch packed bit-tight from its own keys, at window 40 (80-bit keys)
    blocks of key words; no full-width slab is stacked; == the JAX
    sketcher's matrix."""
    rng = np.random.default_rng(window)
    keys, _ = sketch_keys(rng, 140, 128, 2 * window, pool=300, per=60)
    counts = (keys != 0xFFFFFFFF).any(-1).sum(1)
    sk = FracMinHashSketcher(SketchConfig(window=window, k=16),
                             device="cpu")
    monkeypatch.setattr(fracminhash, "ONDEVICE_MAX_GENOMES", 100)
    monkeypatch.setattr(sk, "stack_sketches", None)
    observability.reset_counters()
    got = sk.all_pairs_intersections(
        [Sketch(keys=keys[i, :c].copy(), count=int(c), window=window,
                mask=sk.mask) for i, c in enumerate(counts)])
    assert observability.counters()["blocked_h2d_bytes"] == sent
    jsk = JaxSketcher(JaxConfig(window=window, k=16))
    want = jsk.all_pairs_intersections(
        [JaxSketch(keys=keys[i, :c].copy(), count=int(c), window=window,
                   mask=jsk.mask) for i, c in enumerate(counts)])
    np.testing.assert_array_equal(got, want)
