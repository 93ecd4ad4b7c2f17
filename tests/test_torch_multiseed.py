"""Multi-seed sketching (BASELINE config 3), the single-genome step and the
kernels they add (K1's seed-batch mode, K11, K8, K9) against the JAX package.

On the CPU every port wrapper runs its kernel's plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do, or its plain jnp path where that is what the JAX CPU backend
takes.  Inputs are made from a seed with numpy and fed to both.  Every
comparison is exact (tolerance 0): the values are integer keys and counts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs as JaxPacked
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher)
from spaced_kmer_sketching_tpu.ops import sketch as jax_sketch
from spaced_kmer_sketching_tpu.ops import u64ops as jax_u64ops
from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
from spaced_kmer_sketching_tpu.ops.pallas.extract import (
    extract_compact_windows_prepacked, extract_filter_windows_batched,
    pack_genomes_np)
from spaced_kmer_sketching_tpu.ops.pallas.sort import (sort_runs_128,
                                                       sort_truncate_128)
from spaced_kmer_sketching_tpu.utils import boosthash
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.ops import sketch as t_sketch
from spaced_kmer_sketching_tpu_torch.ops import u64ops
from spaced_kmer_sketching_tpu_torch.ops.cuda import extract, sort
from spaced_kmer_sketching_tpu_torch.utils.masks import (
    spaced_seed_mask as t_seed_mask)

from oracle import oracle_sketch

SENT = 0xFFFFFFFF


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def seeds_of(window, k, count, variant="modern"):
    """count masks (mask seeds 0..count-1), their salts and the JAX
    arguments: (S, 4) mask words and (S, 2) [hi, lo] salt pairs."""
    masks = [spaced_seed_mask(window, k, s) for s in range(count)]
    salts = [boosthash.fmh_salt(m.lo, m.hi, window, 1, variant)
             for m in masks]
    mw = np.stack([m.words_u32 for m in masks])
    sp = np.stack([jax_u64ops.salt_pair(x) for x in salts])
    return masks, salts, mw, sp


def genome(seed, n, lens):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    return codes, run_ids_from_lens(lens, n)


def test_salt_from_pair_inverts_salt_pair():
    for salt in (0, 1, 0xDEADBEEF, 0x8000000000000001, (1 << 64) - 1):
        assert u64ops.salt_from_pair(u64ops.salt_pair(salt)) == salt


def test_k1_seed_mode_matches_jax_and_bounds_source():
    """K1's seed-batch mode (plain) against the JAX prepacked kernel with
    batch=S on shared planes (tests/test_pallas_extract.py's shape), and
    K7's seed-batch mode (run bounds) against the run-id plane source."""
    window, k, scale, s, n, k_slots = 20, 16, 20, 3, 70000, 64
    _, salts, mw, sp = seeds_of(window, k, s)
    codes, rid = genome(11, n, [n // 2, n - n // 2])
    qc, qr, rid2 = pack_genomes_np(codes[None], rid[None])
    jw, jrc, _ = extract_compact_windows_prepacked(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(rid2), jnp.asarray(mw),
        nw=n - window + 1, window=window, salt=jnp.asarray(sp), scale=scale,
        variant="modern", k_slots=k_slots, batch=s, interpret=True)
    args = dict(window=window, nw=n - window + 1, scale=scale,
                variant="modern", k_slots=k_slots, out_words=4)
    packed = extract.pack_codes(torch.from_numpy(codes[None]))
    planes, rowcnt = extract.extract_compact(
        packed, torch.from_numpy(rid[None]), mw, salts, **args)
    assert planes.shape[1] == rowcnt.shape[0] == s
    np.testing.assert_array_equal(rowcnt.numpy(), np.asarray(jrc))
    for q in range(4):
        np.testing.assert_array_equal(u32(planes[q]), np.asarray(jw[q]))
    # every seed row equals a single-seed launch with that seed
    one = extract.extract_compact(packed, torch.from_numpy(rid[None]),
                                  mw[1], salts[1], **args)
    assert torch.equal(planes[:, 1:2], one[0])

    body = extract.packed_body(n)
    p = torch.from_numpy(extract.pack2bit(codes, body // 16).view(np.int32))
    bounds = torch.tensor([[n // 2, body]], dtype=torch.int32)
    raw = extract.extract_compact_raw(
        p[None], bounds, torch.zeros(1, dtype=torch.int32),
        torch.tensor([n], dtype=torch.int32), mw, salts, **args)
    assert torch.equal(raw[0], planes) and torch.equal(raw[1], rowcnt)
    with pytest.raises(ValueError, match="one genome row"):
        extract.extract_compact(packed.expand(2, -1).contiguous(),
                                torch.from_numpy(np.stack([rid, rid])), mw,
                                salts, **args)


@pytest.mark.parametrize("window,k,scale,n", [(20, 16, 20, 6000),
                                              (31, 17, 5, 4096)])
def test_k11_matches_jax_at_every_window(window, k, scale, n):
    """K11 (plain) against the JAX extract_filter_windows_batched in
    interpret mode (tests/test_pallas_extract.py's shapes, two genomes):
    the keep flags and the canonical keys at EVERY window, valid or not."""
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, (2, n)).astype(np.uint32)
    rid = np.stack([run_ids_from_lens([n // 3, n - n // 3], n),
                    run_ids_from_lens([n // 2, 7, n // 4], n)])
    jc, jk = extract_filter_windows_batched(
        jnp.asarray(codes), jnp.asarray(rid), jnp.asarray(mask.words_u32),
        window=window, salt=salt, scale=scale, variant="modern",
        interpret=True)
    canon, keep = extract.extract_filter(
        torch.from_numpy(codes.astype(np.int64)), torch.from_numpy(rid),
        mask.words_u32, salt, window=window, scale=scale, variant="modern")
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    assert keep.sum() > 0 and (~keep).sum() > 0
    for q in range(4):
        np.testing.assert_array_equal(u32(canon[q]), np.asarray(jc[q]))


@pytest.mark.parametrize("kw,g,runs,run_rows", [(4, 1, 64, 4),
                                                (2, 1, 8, 32),
                                                (2, 2, 3, 16)])
def test_k8_matches_jax(kw, g, runs, run_rows):
    """K8 (plain) against sort_runs_128 in interpret mode on each row:
    tests/test_pallas_sort.py's shapes (256 rows, runs of 4 and 32 rows)
    and two rows of three runs (odd runs descending; the JAX kernel's
    one-run-per-step fallback)."""
    rng = np.random.default_rng(runs * run_rows)
    m = runs * run_rows * 128
    keys = rng.integers(0, 2 ** 32, size=(kw, g, m), dtype=np.uint64) \
        .astype(np.uint32)
    keys[..., ::5] = keys[..., 1:2]                   # duplicates
    got = u32(sort.sort_runs(torch.from_numpy(keys.view(np.int32)),
                             run_rows * 128))
    for r in range(g):
        want = sort_runs_128([jnp.asarray(keys[q, r].reshape(-1, 128))
                              for q in range(kw)], run_rows, interpret=True)
        for q in range(kw):
            np.testing.assert_array_equal(got[q, r],
                                          np.asarray(want[q]).reshape(-1))


@pytest.mark.parametrize("kw,g,t,capacity,valid", [(2, 1, 4, 8192, 1500),
                                                   (2, 2, 2, 512, 200)])
def test_k9_matches_jax(kw, g, t, capacity, valid):
    """K9 (plain) against sort_truncate_128 in interpret mode on each row:
    sparse valid keys among sentinels (tests/test_pallas_sort.py's shape,
    and two rows of two tiles)."""
    rng = np.random.default_rng(capacity)
    m = t * sort.TILE
    keys = np.full((kw, g, m), SENT, np.uint32)
    for r in range(g):
        pos = rng.choice(m, size=valid, replace=False)
        keys[:, r, pos] = rng.integers(0, 2 ** 31, size=(kw, valid))
    got = u32(sort.sort_truncate(torch.from_numpy(keys.view(np.int32)),
                                 capacity))
    for r in range(g):
        want = np.asarray(sort_truncate_128(jnp.asarray(keys[:, r].T),
                                            capacity, interpret=True))
        np.testing.assert_array_equal(got[:, r].T, want)


def assert_batch(got, want):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.raw_kept.numpy(),
                                  np.asarray(want.raw_kept))
    np.testing.assert_array_equal(u32(got.keys), np.asarray(want.keys))


@pytest.mark.parametrize("cap,route", [(8192, "tree"), (1024, "runs"),
                                       (256, "sort")])
def test_multiseed_step_matches_jax(cap, route):
    """sketch_batch_packed in seed-batch mode and sketch_from_codes_
    multiseed against the JAX sketch_batch_packed(batch=S) in interpret
    mode (keys, count, raw_kept) at three finish routes (the two smaller
    capacities overflow); where nothing overflows, the JAX CPU
    sketch_from_codes_multiseed (a vmap of sketch_core) gives the same
    keys and counts."""
    window, k, scale, s, n = 20, 16, 20, 2, 70000
    _, salts, mw, sp = seeds_of(window, k, s)
    codes, rid = genome(cap, n, [30000, 5, n - 30005])
    nw = n - window + 1
    k_slots = t_sketch._k_slots_for(nw, scale, cap)
    m = extract.out_rows(nw) * k_slots
    assert t_sketch.finish_route(m, nw, k_slots, cap, scale, s) == route
    qc, qr, rid2 = pack_genomes_np(codes[None], rid[None])
    want = jax_sketch.sketch_batch_packed(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(rid2), jnp.asarray(mw),
        n=n, window=window, salt=jnp.asarray(sp), scale=scale,
        variant="modern", capacity=cap, batch=s, interpret=True)
    got = t_sketch.sketch_from_codes_multiseed(
        torch.from_numpy(codes), torch.from_numpy(rid), mw, sp, window=window,
        scale=scale, variant="modern", capacity=cap)
    assert_batch(got, want)
    step = t_sketch.sketch_batch_packed(
        extract.pack_codes(torch.from_numpy(codes[None])),
        torch.from_numpy(rid[None]), mw, salts, window=window, scale=scale,
        variant="modern", capacity=cap)
    assert_batch(step, want)
    if int(got.raw_kept.max()) > cap:
        return
    cpu = jax_sketch.sketch_from_codes_multiseed(
        jnp.asarray(codes.astype(np.uint32)), jnp.asarray(rid),
        jnp.asarray(mw), jnp.asarray(sp), window=window, scale=scale,
        variant="modern", capacity=cap)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(cpu.count))
    for i in range(s):
        c = int(cpu.count[i])
        np.testing.assert_array_equal(u32(got.keys[i, :c]),
                                      np.asarray(cpu.keys[i, :c]))


@pytest.mark.parametrize("cap,overflow", [(4096, False), (512, True)])
def test_sketch_core_matches_jax(cap, overflow):
    """sketch_core / sketch_from_codes (K11, the chunked top-k, K4, K3)
    against the JAX sketch_from_codes: two chunks of 35,000 windows; at
    capacity 512 each chunk's share of 256 overflows and raw_kept says
    so, exactly as in JAX."""
    window, k, scale, n = 20, 16, 50, 70000
    mask = spaced_seed_mask(window, k, 3)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "legacy")
    codes, rid = genome(5, n, [40000, n - 40000])
    args = dict(window=window, salt=salt, scale=scale, variant="legacy",
                capacity=cap)
    want = jax_sketch.sketch_from_codes(
        jnp.asarray(codes.astype(np.uint32)), jnp.asarray(rid),
        jnp.asarray(mask.words_u32), **args)
    got = t_sketch.sketch_from_codes(torch.from_numpy(codes),
                                     torch.from_numpy(rid), mask.words_u32,
                                     **args)
    assert got.keys.shape == (cap, 4) and got.count.dim() == 0
    assert_batch(got, want)
    assert (int(got.raw_kept) > cap) == overflow
    core = t_sketch.sketch_core(torch.from_numpy(codes),
                                torch.from_numpy(rid), mask.words_u32, **args)
    assert torch.equal(core.keys, got.keys)


def test_sketch_batch_matches_jax_sketch_batch_packed():
    """sketch_batch (device pack, K1, the finish) on two genomes against
    the JAX prepacked step with the same static window."""
    window, k, scale, cap, n = 16, 12, 20, 1024, 40000
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (2, n)).astype(np.uint8)
    rid = np.stack([run_ids_from_lens([n], n),
                    run_ids_from_lens([9000, 9000], n)])
    qc, qr, r = pack_genomes_np(codes, rid)
    want = jax_sketch.sketch_batch_packed(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(r),
        jnp.asarray(mask.words_u32), n=n, window=window, salt=salt,
        scale=scale, variant="modern", capacity=cap, interpret=True)
    got = t_sketch.sketch_batch(torch.from_numpy(codes),
                                torch.from_numpy(rid), mask.words_u32,
                                window=window, salt=salt, scale=scale,
                                variant="modern", capacity=cap)
    assert_batch(got, want)


def split_runs(codes, lens):
    runs, pos = [], 0
    for ln in lens:
        runs.append([int(c) for c in codes[pos:pos + int(ln)]])
        pos += int(ln)
    return runs


def keys_as_ints(sketch):
    return {int(a) | int(b) << 32 | int(c) << 64 | int(d) << 96
            for a, b, c, d in sketch.keys.astype(object)}


def test_sketcher_multiseed_matches_jax_and_oracle():
    """sketch_packed_multiseed (tests/test_sketch.py's case): explicit
    seeds against the JAX sketcher's multiseed and the oracle, the default
    seeds 0..7 with an overflow retry (capacity 256), a mask of another
    window refused, and one empty sketch per seed for an empty genome."""
    cfg = dict(window=14, k=9, scale=5)
    rng = np.random.default_rng(41)
    codes = rng.integers(0, 4, 30000).astype(np.uint8)
    lens = np.array([12000, 18000], np.int64)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    got = port.sketch_packed_multiseed(PackedSeqs(codes, lens),
                                       seeds=range(3))
    want = JaxSketcher(JaxConfig(**cfg)).sketch_packed_multiseed(
        JaxPacked(codes, lens), seeds=range(3))
    assert len(got) == 3
    for seed, a, b in zip(range(3), got, want):
        mask = spaced_seed_mask(14, 9, seed)
        assert a.mask == t_seed_mask(14, 9, seed)
        assert (a.mask.lo, a.mask.hi) == (b.mask.lo, b.mask.hi)
        assert a.count == b.count > 1000
        np.testing.assert_array_equal(a.keys, b.keys)
        salt = boosthash.fmh_salt(mask.lo, mask.hi, 14, 1, "modern")
        assert keys_as_ints(a) == oracle_sketch(split_runs(codes, lens),
                                                mask.value, 14, salt, 5)

    small = FracMinHashSketcher(SketchConfig(**cfg, sketch_capacity=256),
                                device="cpu")
    default = small.sketch_packed_multiseed(PackedSeqs(codes, lens))
    masks = [t_seed_mask(14, 9, s) for s in range(8)]
    assert [s.mask for s in default] == masks
    again = port.sketch_packed_multiseed(PackedSeqs(codes, lens),
                                         masks=masks[5:])
    for a, b in zip(default[5:], again):
        assert a.count == b.count > 256
        np.testing.assert_array_equal(a.keys, b.keys)

    with pytest.raises(ValueError, match="window"):
        port.sketch_packed_multiseed(PackedSeqs(codes, lens),
                                     masks=[t_seed_mask(20, 9, 0)])
    empty = port.sketch_packed_multiseed(
        PackedSeqs(np.empty(0, np.uint8), np.empty(0, np.int64)),
        seeds=range(2))
    assert [s.count for s in empty] == [0, 0]
    assert [s.keys.shape for s in empty] == [(0, 4), (0, 4)]
