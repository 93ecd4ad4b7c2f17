"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip without one.  They import neither jax nor the JAX package, so they run
on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Every comparison is bit-exact: the values are integer keys and counts.
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher, Sketch)
from spaced_kmer_sketching_tpu_torch.ops import gram
from spaced_kmer_sketching_tpu_torch.ops.cuda import build
from spaced_kmer_sketching_tpu_torch.ops.cuda import (compact, extract,
                                                      gram_tiles, sort, tight)
from spaced_kmer_sketching_tpu_torch.ops import u64ops
from spaced_kmer_sketching_tpu_torch.ops.sketch import (
    _k_slots_for, finish_words, sketch_batch_packed_dyn)
from spaced_kmer_sketching_tpu_torch.utils import boosthash, native
from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def genome_batch(rng, g, n, runs):
    codes = rng.integers(0, 4, (g, n)).astype(np.uint8)
    rid = np.full((g, n), -1, np.int32)
    pos = 0
    for r, ln in enumerate(runs):
        rid[:, pos:pos + ln] = r
        pos += ln
    return codes, rid


def hard_plane(rng, g, n):
    """(G, n) int32 run ids no sorted-bounds form gives: runs of 1-300
    positions whose ids repeat out of order, -1 holes inside the genome,
    single-position runs, and a -1 tail past a random end."""
    rid = np.empty((g, n), np.int32)
    for gi in range(g):
        pos = 0
        while pos < n:
            ln = int(rng.integers(1, 300)) if rng.random() > 0.1 else 1
            rid[gi, pos:pos + ln] = int(rng.integers(-1, 6))
            pos += ln
        rid[gi, n - int(rng.integers(0, 2000)):] = -1
    return rid


def k1_inputs(rng, dev, g, plane, window):
    """Codes packed on the device and a run-id plane: three runs and a -1
    tail over 2^18 codes, or (plane "hard") hard_plane over 2^18 - 93
    codes, so the plane ends inside a 128-window row."""
    if plane == "runs":
        codes, rid = genome_batch(rng, g, 262144, [100000, 40, 100000])
    else:
        n = 262144 - 93
        codes = rng.integers(0, 4, (g, n)).astype(np.uint8)
        rid = hard_plane(rng, g, n)
    p = extract.pack_codes(torch.from_numpy(codes).to(dev))
    return codes, rid, p, torch.from_numpy(rid).to(dev)


@pytest.mark.parametrize("plane", ["runs", "hard"])
@pytest.mark.parametrize("variant", ["modern", "legacy"])
@pytest.mark.parametrize("window,k", [(1, 1), (10, 10), (20, 16), (31, 20),
                                      (33, 25), (50, 40), (64, 40)])
def test_k1_matches_plain(dev, window, k, variant, plane):
    """K1 against its plain version on three runs and on non-monotone
    planes with -1 holes that end mid-row (nw not a multiple of 32)."""
    rng = np.random.default_rng(window)
    g = 2
    _, rid, p, r = k1_inputs(rng, dev, g, plane, window)
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    kw = finish_words(window)
    nw = rid.shape[1] - (16 * (kw - 1) + 1) + 1
    scale = 2 if window == 1 else 20
    args = dict(window=window, nw=nw, scale=scale, variant=variant,
                k_slots=_k_slots_for(nw, scale, 4096), out_words=kw)
    build.reset_launches()
    got = extract.extract_compact(p, r, mask.words_u32, salt, **args)
    assert build.KERNELS["K1"].launches == 1
    want = extract.extract_compact_plain(p, r, mask.words_u32, salt, **args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("kw", [1, 2, 4])
def test_k2_k3_match_plain(dev, kw):
    x = torch.full((kw, 2, 64, 128), -1, dtype=torch.int32, device=dev)
    hit = torch.rand(2, 64, 128, device=dev) < 0.2
    x[:, hit] = torch.randint(0, 2 ** 31 - 1, (kw, int(hit.sum())),
                              dtype=torch.int32, device=dev)
    for k_out in (8, 64):
        got = compact.compact_rows(x, k_out, with_counts=True)
        want = compact.compact_rows_plain(x, k_out, with_counts=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat = x.reshape(kw, 2, 8192)
    assert torch.equal(compact.compact_global(flat),
                       compact.compact_global_plain(flat))


def holed_rows(gen, kw, g, n, frac, dev):
    """(kw, g, n) int32 keys with a `frac` share of all-ones holes; row 0
    all valid, the last row (g > 1) all holes, and in row 0 one word of
    every fifth key all-ones (still valid when kw > 1)."""
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, g, n), generator=gen,
                      dtype=torch.int32, device=dev)
    hole = torch.rand((g, n), generator=gen, device=dev) < frac
    hole[0] = False
    if g > 1:
        hole[-1] = True
    x[:, hole] = -1
    x[kw - 1, 0, ::5] = -1
    return x


@pytest.mark.parametrize("kw,g,n", [
    (1, 1, 1), (2, 1, 2049), (3, 2, 131072), (4, 128, 4097),
    (1, 1, 1 << 22), (2, 3, (1 << 21) + 5), (2, 128, 65536), (4, 7, 100)])
def test_k3_hard_inputs_match_plain(dev, kw, g, n):
    """K3 over G 1-128 and n 1 to 2^22, n not a multiple of its 2,048-slot
    tiles, rows of more than 1,024 tiles (two rounds of the offset scan),
    all-valid and all-sentinel rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + g)
    x = holed_rows(gen, kw, g, n, 0.4, dev)
    build.reset_launches()
    got = compact.compact_global(x)
    want = compact.compact_global_plain(x)
    torch.cuda.synchronize()
    assert build.KERNELS["K3"].launches == 1
    assert torch.equal(got, want)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(kw=st.integers(1, 4), g=st.integers(1, 6), n=st.integers(1, 300000),
       frac=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 31 - 1))
def test_k3_property(dev, kw, g, n, frac, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = holed_rows(gen, kw, g, n, frac, dev)
    got = compact.compact_global(x)
    torch.cuda.synchronize()
    assert torch.equal(got, compact.compact_global_plain(x))


@pytest.mark.parametrize("kw", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1024, 2048, 8192, 16384, 65536, 1 << 20])
def test_k4_matches_plain(dev, n, kw):
    """Register tiles (one launch for n up to the tile), K5's levels above
    it; rows with duplicates and a sentinel tail, all sentinels, and all
    equal."""
    z = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, 4, n), dtype=torch.int32,
                      device=dev)
    z[:, :, ::3] = z[:, :, 1:2]
    z[:, :, -100:] = -1
    z[:, 2] = -1
    z[:, 3] = z[:, 3, :1]
    assert torch.equal(sort.sort_rows(z), sort.sort_rows_plain(z))


def test_sketch_step_counts_every_kernel(dev):
    """The dyn sketch step on the GPU launches K1-K4 (tree finish shape)
    and gives the plain versions' result."""
    step_kernels = [build.KERNELS[k] for k in ("K1", "K2", "K3", "K4")]
    rng = np.random.default_rng(3)
    g, n, window = 2, 65536, 20
    codes, rid = genome_batch(rng, g, n, [20000, 30000, 15000])
    mask = spaced_seed_mask(window, 16, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    p = torch.from_numpy(extract.pack2bit_rows(codes).view(np.int32))
    r = torch.from_numpy(rid)
    args = dict(n=n, kw=2, scale=50, variant="modern", capacity=4096)
    want = sketch_batch_packed_dyn(p, r, mask.words_u32, salt, window, **args)
    build.reset_launches()
    got = sketch_batch_packed_dyn(p.to(dev), r.to(dev), mask.words_u32, salt,
                                  window, **args)
    assert all(k.launches > 0 for k in step_kernels)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def packed_runs(dev, g, cap, key_bits, gidbits, pool, per, seed, every=0):
    """(pw, g*cap/128, 128) packed planes of g ascending genome runs whose
    keys come from one shared pool (long equal-key runs); the `every`
    smallest pool keys are in every genome."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kw = gram._guard_words(key_bits)
    vals = torch.randint(0, 1 << min(key_bits, 62), (pool,), generator=gen,
                         device=dev).unique()
    pick = torch.rand((g, vals.numel()), generator=gen, device=dev) \
        < per / vals.numel()
    pick[:, :every] = True
    idx = torch.where(pick, torch.arange(vals.numel(), device=dev),
                      vals.numel()).sort(1).values[:, :cap]
    if idx.shape[1] < cap:       # a pool smaller than the sketches
        idx = torch.cat([idx, torch.full((g, cap - idx.shape[1]),
                                         vals.numel(), device=dev)], 1)
    ext = torch.cat([vals, torch.full((1,), -1, device=dev)])[idx]
    words = [ext & 0xFFFFFFFF, (ext >> 32) & 0xFFFFFFFF] + \
        [torch.zeros_like(ext)] * 2
    keys = torch.stack([torch.where(idx == vals.numel(), -1,
                                    u64ops.as_i32(w)) for w in words[:kw]], -1)
    gid = torch.arange(g, device=dev)[:, None].expand(g, cap)
    planes = gram._pack_gid_planes(keys, gid, key_bits, gidbits,
                                   gram.pack_plan(key_bits, gidbits))
    return planes.reshape(planes.shape[0], -1, 128)


def gram_splits(gp):
    return sorted({s for s in (128, gp // 2 // 128 * 128, gp - 128)
                   if 0 < s < gp})


@pytest.mark.parametrize("g,cap,key_bits,every", [
    (128, 1024, 40, 0), (16, 8192, 40, 0), (128, 1024, 128, 0),
    (2048, 256, 40, 0),
    (128, 1024, 16, 1),      # pw 1, a key in every genome
    (256, 512, 40, 2),       # pw 2
    (640, 256, 60, 1),       # pw 3
    (1024, 512, 90, 0),      # pw 4
    (2048, 256, 40, 1),      # a run of 2,048 entries across chunk edges
    (4096, 256, 40, 1),      # runs of 4,096: a whole chunk
    (4608, 128, 40, 2)])     # runs of 4,608, open across a chunk edge
def test_k5_k6_match_plain(dev, g, cap, key_bits, every):
    gidbits = max(1, (g - 1).bit_length())
    runs = packed_runs(dev, g, cap, key_bits, gidbits, 3 * cap, cap // 2, g,
                       every=every)
    merged = sort.merge_sorted_runs_plain(runs, cap // 128)
    if g & (g - 1) == 0:         # K5 merges a power-of-two count of runs
        assert torch.equal(sort.merge_sorted_runs(runs, cap // 128), merged)
    gp = max(128, g)
    build.reset_launches()
    got = gram_tiles.gram_tile_scan(merged, gidbits, gp)
    want = gram_tiles.gram_tile_scan_plain(merged, gidbits, gp)
    torch.cuda.synchronize()
    assert build.KERNELS["K6"].launches == 1
    assert torch.equal(got, want)
    assert int(got[:g, :g].min()) >= every
    for split in gram_splits(gp):
        assert torch.equal(
            gram_tiles.gram_tile_scan(merged, gidbits, gp, split=split),
            gram_tiles.gram_tile_scan_plain(merged, gidbits, gp,
                                            split=split))


@pytest.mark.parametrize("seg", [0, 1, 333, 4097, 1 << 20])
def test_k6_any_segment_matches_plain(dev, seg):
    """K6's C entry at its own sizing (0) and at segment lengths it never
    picks: a block a run start, segments that cut runs and chunks
    anywhere, one block; the kept runs it counts are the plain count's,
    and a null counter is allowed."""
    from chip_smoke import k6_kept_runs
    g, cap, gidbits = 256, 256, 8
    merged = sort.merge_sorted_runs_plain(
        packed_runs(dev, g, cap, 40, gidbits, 600, 120, seg, every=1),
        cap // 128)
    pw = merged.shape[0]
    flat = merged.reshape(pw, -1)
    for split in (None, 128):
        want = gram_tiles.gram_tile_scan_plain(merged, gidbits, 256,
                                               split=split)
        for counted in (True, False):
            out = torch.zeros_like(want)
            kept = torch.zeros(1, dtype=torch.int64, device=dev)
            err = build.lib().sks_gram_tiles(
                flat.data_ptr(), pw, flat.shape[1], gidbits, 256,
                split or 0, seg, out.data_ptr(),
                kept.data_ptr() if counted else None, build.stream_ptr(dev))
            torch.cuda.synchronize()
            assert err == 0 and torch.equal(out, want)
            assert int(kept) == (k6_kept_runs(flat, gidbits, 256, split)
                                 if counted else 0)


@pytest.mark.parametrize("pw", [1, 5])
def test_k6_empty_and_sentinel_streams(dev, pw):
    empty = torch.empty((pw, 0), dtype=torch.int32, device=dev)
    assert torch.equal(gram_tiles.gram_tile_scan(empty, 8, 256),
                       torch.zeros((256, 256), dtype=torch.int32,
                                   device=dev))
    sent = torch.full((pw, 40, 128), -1, dtype=torch.int32, device=dev)
    for split in (None, 128):
        build.reset_launches()
        gram_tiles.take_kept_runs(dev)
        got = gram_tiles.gram_tile_scan(sent, 8, 256, split=split)
        torch.cuda.synchronize()
        assert build.KERNELS["K6"].launches == 1
        assert gram_tiles.take_kept_runs(dev) == 0
        assert got.shape == (256 if split is None else 128,
                             256 - (split or 0))
        assert int(got.abs().sum()) == 0
    got = gram_tiles.gram_tile_scan(sent, 12, 4096)
    torch.cuda.synchronize()
    assert got.shape == (4096, 4096) and int(got.abs().sum()) == 0


def run_stream(dev, runs, key_bits, gidbits):
    """A sorted packed stream whose run i holds the gids runs[i] (one
    key each, ascending), as K6 reads it."""
    kw = gram._guard_words(key_bits)
    key = np.concatenate([np.full(len(r), i + 1) for i, r in enumerate(runs)])
    gid = np.concatenate([np.sort(np.asarray(r)) for r in runs])
    keys = torch.zeros((1, key.size, kw), dtype=torch.int32)
    keys[0, :, 0] = torch.from_numpy(key.astype(np.int32))
    planes = gram._pack_gid_planes(
        keys.to(dev), torch.from_numpy(gid)[None].to(dev), key_bits, gidbits,
        gram.pack_plan(key_bits, gidbits))
    return planes.reshape(planes.shape[0], -1)


def k6_counted(dev, sw, gidbits, gp, split, seg):
    """K6's C entry at segment length seg (0: its own sizing) with a kept
    run counter: (the Gram, the kept runs it counted)."""
    flat = sw.reshape(sw.shape[0], -1)
    out = torch.zeros((split or gp, gp - (split or 0)), dtype=torch.int32,
                      device=dev)
    kept = torch.zeros(1, dtype=torch.int64, device=dev)
    err = build.lib().sks_gram_tiles(
        flat.data_ptr(), flat.shape[0], flat.shape[1], gidbits, gp,
        split or 0, seg, out.data_ptr(), kept.data_ptr(),
        build.stream_ptr(dev))
    torch.cuda.synchronize()
    assert err == 0
    return out, int(kept)


@pytest.mark.parametrize("key_bits", [16, 40, 60, 90, 128])   # pw 1-5
@pytest.mark.parametrize("size", [64, 32, 48, 80, 6])
def test_k6_kept_run_batches(dev, size, key_bits):
    """Runs of `size` entries, half row and half column gids, so each is
    kept: at 4,096-entry segments a chunk holds exactly one batch of 64
    kept runs (size 64) or exactly 128 (size 32); runs of 48 and 80 cross
    batch and chunk edges and stay open into the next chunk; runs of 6
    between dropped row-only runs give ~500 kept runs a chunk.  Full and
    split mode, own sizing and segments that cut runs anywhere: equal to
    the plain version, and the kept runs counted are the plain count."""
    from chip_smoke import k6_kept_runs
    rng = np.random.default_rng(size * 1000 + key_bits)
    runs, both = [], 3 * 4096 // size + 5
    for i in range(both):
        half = size // 2
        runs.append(np.concatenate([
            rng.choice(128, half, replace=False),
            128 + rng.choice(128, size - half, replace=False)]))
        if size == 6 and i % 3 == 0:
            runs.append(rng.choice(128, 4, replace=False))
    sw = run_stream(dev, runs, key_bits, 8)
    for split in (128, None):
        want = gram_tiles.gram_tile_scan_plain(sw, 8, 256, split=split)
        want_kept = k6_kept_runs(sw, 8, 256, split)
        assert split is None or want_kept == both
        for seg in (0, 4096, 333, 4097):
            got, kept = k6_counted(dev, sw, 8, 256, split, seg)
            assert torch.equal(got, want) and kept == want_kept


@pytest.mark.parametrize("key_bits", [16, 40, 60, 90, 128])   # pw 1-5
def test_k6_related_macro_tiles(dev, key_bits):
    """Macro-tiles built like the all-pairs cell's: two presorted blocks of
    128 genomes whose species follow a Zipf law (~20-30 species shared, so
    hundreds of kept runs a chunk), merged by K10 with the column gids +
    128, and one block merged with itself (a diagonal macro-tile); split
    K6 through the wrapper equals the plain version, and the wrapper's
    counter (gram_kept_runs' source) the plain count of kept runs."""
    from chip_smoke import clade_keys, k6_kept_runs, packed_runs, zipf_clades
    gen = torch.Generator(device=dev)
    gen.manual_seed(key_bits)
    cap, gidbits = 2048, 8
    clade = torch.from_numpy(zipf_clades(key_bits, 256)).to(dev)
    keys = clade_keys(gen, dev, 256, cap, 2000, 1700, 0, key_bits,
                      clade=clade)
    pa = sort.merge_sorted_runs(packed_runs(keys[:128], key_bits, gidbits),
                                cap // 128)
    pb = sort.merge_sorted_runs(packed_runs(keys[128:], key_bits, gidbits),
                                cap // 128)
    for a, b in ((pa, pb), (pa, pa)):
        merged = sort.merge_pair_streams(a, b, b_gid_offset=128)
        want = gram_tiles.gram_tile_scan_plain(merged, gidbits, 256,
                                               split=128)
        want_kept = k6_kept_runs(merged, gidbits, 256, 128)
        assert want_kept > 2000
        gram_tiles.take_kept_runs(dev)
        build.reset_launches()
        got = gram_tiles.gram_tile_scan(merged, gidbits, 256, split=128)
        assert gram_tiles.take_kept_runs(dev) == want_kept
        assert build.KERNELS["K6"].launches == 1
        assert torch.equal(got, want)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(g=st.integers(2, 3000), per=st.integers(1, 250),
       spread=st.integers(1, 16), every=st.integers(0, 3),
       key_bits=st.sampled_from([16, 40, 60, 90, 128]), split=st.booleans(),
       seed=st.integers(0, 2 ** 31 - 1))
def test_k6_property(dev, g, per, spread, every, key_bits, split, seed):
    """Over genome count, sketch size, key sharing (the pool is `spread`
    times the sketch size), keys in every genome, pw 1-5, full and split
    mode: K6 equals its plain version."""
    cap, gidbits = 256, max(1, (g - 1).bit_length())
    gp = max(128, -(-g // 128) * 128)
    runs = packed_runs(dev, g, cap, key_bits, gidbits, spread * per + every,
                       per, seed, every=every)
    merged = sort.merge_sorted_runs_plain(runs, cap // 128)
    cut = gram_splits(gp)[0] if split and gp > 128 else None
    got = gram_tiles.gram_tile_scan(merged, gidbits, gp, split=cut)
    torch.cuda.synchronize()
    assert torch.equal(got, gram_tiles.gram_tile_scan_plain(
        merged, gidbits, gp, split=cut))


@pytest.mark.parametrize("rows,key_bits", [(1, 40), (64, 40), (256, 128)])
def test_k10_matches_plain(dev, rows, key_bits):
    cap = rows * 128
    a = sort.merge_sorted_runs_plain(
        packed_runs(dev, 2, cap // 2, key_bits, 8, cap, cap // 3, rows), 1)
    b = sort.merge_sorted_runs_plain(
        packed_runs(dev, 2, cap // 2, key_bits, 8, cap, cap // 3, rows + 1),
        1)
    assert torch.equal(sort.merge_pair_streams(a, b),
                       sort.merge_pair_streams_plain(a, b))


SENT = 0xFFFFFFFF
KINDS = ["below", "above", "interleaved", "sentinel", "half_sentinel",
         "dups"]


def hard_runs(rng, pw, nruns, run, kind="each", *, pool=None, sent=0.0):
    """(pw, nruns * run) int32: nruns ascending runs of `run` entries of
    pw-word keys (word pw-1's top bit clear, so a K10 offset of <= 255
    neither carries nor reaches it; sentinels all-ones).  kind: "below"
    (each run entirely below the next), "above" (entirely above it),
    "interleaved" (run r holds the sorted keys r, r + nruns, ...),
    "sentinel" (every entry), "half_sentinel" (the second half of every
    run), "dups" (5 distinct keys), else runs drawn independently; pool
    draws from that many distinct keys, sent is a sentinel share."""
    n = nruns * run
    hi = np.full(pw, (1 << 32) - 256, np.int64)
    hi[-1] = (1 << 31) - 256
    pool = 5 if kind == "dups" else pool or 4 * n
    keys = rng.integers(0, hi, (pool, pw))[rng.integers(0, pool, n)]
    keys[rng.random(n) < (1.0 if kind == "sentinel" else sent)] = SENT
    keys = keys[np.lexsort(keys.T)]
    if kind == "below":
        runs = keys.reshape(nruns, run, pw)
    elif kind == "above":
        runs = keys.reshape(nruns, run, pw)[::-1]
    elif kind == "interleaved":
        runs = keys.reshape(run, nruns, pw).transpose(1, 0, 2)
    else:
        runs = keys[rng.permutation(n)].reshape(nruns, run, pw)
        runs = np.stack([r[np.lexsort(r.T)] for r in runs])
    runs = np.ascontiguousarray(runs)
    if kind == "half_sentinel":
        runs[:, run // 2:] = SENT
    flat = runs.reshape(n, pw).T.astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(flat).view(np.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pw", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("rows,run_rows", [(2, 1), (64, 16), (256, 1)])
def test_k5_hard_inputs_match_plain(dev, rows, run_rows, pw, kind):
    """K5's shared-memory levels (runs below 2,048 entries), its global
    levels, and both in one call, on streams whose split points fall
    inside equal or sentinel runs."""
    rng = np.random.default_rng(rows * 10 + pw)
    x = hard_runs(rng, pw, rows // run_rows, run_rows * 128, kind)
    x = x.reshape(pw, rows, 128).to(dev)
    build.reset_launches()
    got = sort.merge_sorted_runs(x, run_rows)
    want = sort.merge_sorted_runs_plain(x, run_rows)
    torch.cuda.synchronize()
    assert build.KERNELS["K5"].launches == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 128])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pw", [1, 3, 5])
@pytest.mark.parametrize("rows", [1, 16, 64])
def test_k10_hard_inputs_match_plain(dev, rows, pw, kind, offset):
    """K10 on two streams built as runs 0 and 1 of hard_runs, B's valid
    gids shifted by 0 or a block of 128."""
    rng = np.random.default_rng(rows * 10 + pw)
    x = hard_runs(rng, pw, 2, rows * 128, kind).reshape(pw, 2 * rows, 128)
    a, b = x[:, :rows].contiguous().to(dev), x[:, rows:].contiguous().to(dev)
    build.reset_launches()
    got = sort.merge_pair_streams(a, b, b_gid_offset=offset)
    want = sort.merge_pair_streams_plain(a, b, b_gid_offset=offset)
    torch.cuda.synchronize()
    assert build.KERNELS["K10"].launches == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["each", "dups", "half_sentinel"])
@pytest.mark.parametrize("kw,g,n,run", [(1, 3, 8192, 128), (2, 2, 8192, 4096),
                                        (3, 4, 512, 128), (4, 2, 65536, 1024),
                                        (2, 5, 256, 1), (2, 1, 4096, 8)])
def test_k5_segmented_row_merges_match_plain(dev, kw, g, n, run, kind):
    """merge_row_runs (K5 with one segment a row, seg < n): pairs never
    cross a row."""
    rng = np.random.default_rng(n + run)
    x = hard_runs(rng, kw, g * n // run, run, kind).reshape(kw, g, n).to(dev)
    got = sort.merge_row_runs(x, run)
    torch.cuda.synchronize()
    assert torch.equal(got, sort.sort_rows_plain(x))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(log_runs=st.integers(1, 6), log_run=st.integers(0, 13),
       pw=st.integers(1, 5), dup=st.floats(0.0, 1.0),
       sent=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 31 - 1))
def test_k5_k10_property(dev, log_runs, log_run, pw, dup, sent, seed):
    """Over run count, run length, pw, duplicate rate and sentinel share:
    K5 (merge_sorted_runs for runs of whole 128-entry rows, else
    merge_row_runs with pw <= 4) and K10 on the first two runs equal their
    plain versions."""
    rng = np.random.default_rng(seed)
    nruns, run = 1 << log_runs, 1 << log_run
    if run < 128:
        pw = min(pw, 4)
    pool = max(1, int((1.0 - dup) * nruns * run)) + 1
    x = hard_runs(rng, pw, nruns, run, pool=pool, sent=sent).to(dev)
    if run < 128:
        got = sort.merge_row_runs(x[:, None], run)[:, 0]
    else:
        x = x.reshape(pw, -1, 128)
        got = sort.merge_sorted_runs(x, run // 128)
        half = run // 128
        a, b = x[:, :half].contiguous(), x[:, half:2 * half].contiguous()
        assert torch.equal(sort.merge_pair_streams(a, b, b_gid_offset=128),
                           sort.merge_pair_streams_plain(a, b,
                                                         b_gid_offset=128))
    want = sort.sort_rows_plain(x.reshape(pw, 1, -1)).reshape(x.shape)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_routed_all_pairs_match_native_merge(dev):
    """The sketcher's device routes (Gram at G = 20, blocked past the
    threshold) against the native host merge."""
    from spaced_kmer_sketching_tpu_torch.models import fracminhash
    rng = np.random.default_rng(4)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cuda")
    pool = np.unique(rng.integers(0, 1 << 40, 6000).astype(np.uint64))
    sketches = []
    for _ in range(150):
        v = np.unique(rng.choice(pool, 1500))
        keys = np.zeros((v.size, 4), np.uint32)
        keys[:, 0] = (v & 0xFFFFFFFF).astype(np.uint32)
        keys[:, 1] = (v >> np.uint64(32)).astype(np.uint32)
        sketches.append(Sketch(keys=keys, count=v.size, window=20,
                               mask=sk.mask))
    u64 = [s.keys_u64() for s in sketches]

    def check(out, idx):
        for a in idx:
            for b in idx:
                want = sketches[a].count if a == b else \
                    native.intersect_sorted(u64[a], u64[b])
                assert out[a, b] == want

    build.reset_launches()
    check(sk.all_pairs_intersections(sketches[:20]), range(20))
    assert build.KERNELS["K5"].launches and build.KERNELS["K6"].launches
    old = fracminhash.ONDEVICE_MAX_GENOMES
    fracminhash.ONDEVICE_MAX_GENOMES = 100
    try:
        out = sk.all_pairs_intersections(sketches)
    finally:
        fracminhash.ONDEVICE_MAX_GENOMES = old
    assert build.KERNELS["K10"].launches
    check(out, list(range(0, 150, 7)) + [127, 128, 149])


@pytest.mark.parametrize("cap,count", [(128, 100), (32768, 25000)])
def test_out_of_core_matches_in_core(dev, cap, count):
    """The out-of-core schedule (budgets shrunk: column-cache hits and
    re-presorts both happen) against the in-core route on the card, 300
    genomes in 3 blocks with a ragged tail of 44; at capacity 32,768 one
    sketch holds exactly 32,768 keys."""
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs
    rng = np.random.default_rng(cap)
    g = 300
    pool = np.cumsum(rng.integers(1, 1 << 20, 2 * count)).astype(np.uint64)
    keys = np.full((g, cap, 2), 0xFFFFFFFF, np.uint32)
    sizes = []
    for i in range(g):
        v = pool[:cap] if i == 7 and cap == 32768 else np.unique(
            rng.choice(pool, count))[:cap]
        keys[i, :v.size, 0] = (v & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :v.size, 1] = (v >> np.uint64(32)).astype(np.uint32)
        sizes.append(v.size)
    want = allpairs.blocked_all_pairs(keys, key_bits=40, device=dev)
    observability.reset_counters()
    build.reset_launches()
    got = allpairs.blocked_all_pairs(keys, key_bits=40, device=dev,
                                     budget_bytes=1,
                                     col_cache_bytes=2 * 128 * cap * 4)
    stats = observability.counters()
    assert (stats["blocked_presorts"], stats["blocked_cache_hits"]) == (4, 2)
    assert build.KERNELS["K10"].launches == build.KERNELS["K6"].launches == 6
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got), sizes)
    if cap == 32768:
        assert got[7, 7] == 32768


def test_sketcher_out_of_core_provider_on_card(dev, monkeypatch):
    """The sketcher's route past the budget, a provider that stacks each
    block from the host sketches, launches K5, K10 and K6 on the card and
    gives the direct call's matrix: 300 genomes in 3 blocks with a ragged
    tail of 44, the budget constants lowered so that column-cache hits and
    re-presorts both happen."""
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.models import fracminhash
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs
    rng = np.random.default_rng(12)
    g, cap = 300, 128
    pool = np.cumsum(rng.integers(1, 1 << 20, 200)).astype(np.uint64)
    keys = np.full((g, cap, 2), 0xFFFFFFFF, np.uint32)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cuda")
    sketches = []
    for i in range(g):
        v = np.unique(rng.choice(pool, 100))
        words = np.zeros((v.size, 4), np.uint32)
        words[:, 0] = (v & 0xFFFFFFFF).astype(np.uint32)
        words[:, 1] = (v >> np.uint64(32)).astype(np.uint32)
        keys[i, :v.size] = words[:, :2]
        sketches.append(Sketch(keys=words, count=v.size, window=20,
                               mask=sk.mask))
    want = allpairs.blocked_all_pairs(keys, key_bits=40, device=dev)
    monkeypatch.setattr(fracminhash, "ONDEVICE_MAX_GENOMES", 100)
    monkeypatch.setattr(allpairs, "CACHE_BUDGET_BYTES", 1)
    monkeypatch.setattr(allpairs, "COL_CACHE_BYTES", 2 * 128 * cap * 4)
    observability.reset_counters()
    build.reset_launches()
    got = sk.all_pairs_intersections(sketches)
    stats = observability.counters()
    assert (stats["blocked_presorts"], stats["blocked_cache_hits"]) == (4, 2)
    assert build.KERNELS["K5"].launches > 0
    assert build.KERNELS["K10"].launches == build.KERNELS["K6"].launches == 6
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got),
                                  [s.count for s in sketches])


def test_batch_sweep_on_card(dev):
    """Three genomes with N-runs in three buckets over four configs
    (finish_words 1-4) on the card: every sketch equals the CPU's and the
    native scalar pipeline's, and each genome's upload lies on the card,
    its run-id plane stacked there equal to the host's."""
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
    from spaced_kmer_sketching_tpu_torch.models import fracminhash as fm
    rng = np.random.default_rng(15)
    genomes = []
    for total, runs in ((30000, 12), (50000, 3), (100000, 40)):
        cuts = np.sort(rng.choice(np.arange(1, total), runs - 1, False))
        lens = np.diff(np.concatenate([[0], cuts, [total]])).astype(np.int64)
        genomes.append(PackedSeqs(
            rng.integers(0, 4, total).astype(np.uint8), lens))
    for window, k in ((14, 9), (24, 16), (40, 24), (60, 40)):
        cfg = SketchConfig(window=window, k=k, scale=8)
        sk = FracMinHashSketcher(cfg, device=dev)
        got = sk.sketch_packed_batch(genomes)
        cpu = FracMinHashSketcher(cfg, device="cpu") \
            .sketch_packed_batch(genomes)
        for pk, s, c in zip(genomes, got, cpu):
            want = native.sketch_codes(
                pk.codes, pk.run_lens, sk.mask.lo, sk.mask.hi, window,
                sk.salt, 8, False)
            assert s.count == c.count > 0
            np.testing.assert_array_equal(s.keys, c.keys)
            np.testing.assert_array_equal(s.keys_u64(), want)
    for pk, n in zip(genomes, (32768, 65536, 131072)):
        (e,) = fm.upload_genomes([pk], n, dev)
        assert e.words.device.type == e.ends.device.type == dev.type
        np.testing.assert_array_equal(
            e.words.cpu().numpy().view(np.uint32),
            extract.pack2bit(pk.codes, n // 16))
        rid = np.full(n, -1, np.int32)
        rid[:pk.codes.size] = np.repeat(np.arange(pk.run_lens.size),
                                        pk.run_lens)
        np.testing.assert_array_equal(
            fm._stack_uploads([e], n)[1][0].cpu().numpy(), rid)


def raw_batch(rng, g, n, k, real, rid0, short, edges=False):
    """K7 inputs: packed bodies of random codes, `real` sorted run starts
    per genome (the rest padded with the body length; with `edges`, on
    multiples of 32 and of 31, a K7 thread's first and last windows), rid0,
    and code counts `short` below n."""
    body = extract.packed_body(n)
    p = rng.integers(-2 ** 31, 2 ** 31, (g, body // 16), dtype=np.int64)
    bounds = np.full((g, k), body, np.int32)
    for i in range(g):
        if edges:
            at = np.unique(np.concatenate([np.arange(1, real) * 32 * 7,
                                           np.arange(1, real) * 31 * 5]))
            bounds[i, :real] = at[:real]
        else:
            bounds[i, :real] = np.sort(rng.choice(n - max(short, 0), real,
                                                  replace=False))
    return (torch.from_numpy(p.astype(np.int32)), torch.from_numpy(bounds),
            torch.full((g,), rid0, dtype=torch.int32),
            torch.full((g,), n - short, dtype=torch.int32))


@pytest.mark.parametrize(
    "g,n,k,real,rid0,short,window,variant,scale,edges", [
        (1, 1 << 25, 64, 5, 7, 1000, 20, "modern", 200, False),  # a segment
        (32, 1 << 21, 8, 3, 0, 1000, 20, "legacy", 200, False),  # a dispatch
        (4, 1 << 20, 512, 512, 2, 1000, 33, "modern", 200, False),  # any K
        (2, 1 << 16, 8, 8, 0, -3000, 64, "modern", 200, False),  # vlen past
        (2, 1 << 16, 16, 16, -1, 100, 1, "modern", 1, True),   # every kept
        (2, 1 << 17, 12, 12, 0, 500, 16, "legacy", 7, True),
        (3, 1 << 16, 8, 8, -1, 50, 17, "modern", 7, True),
        (2, 1 << 18, 32, 32, 1, 300, 32, "modern", 1, False),
        (2, 1 << 16, 0, 0, 0, 0, 64, "legacy", 1, False),      # K = 0
        (2, 1 << 22, 40, 40, -1, 300, 32, "modern", 2 ** 31 - 1, True)])
def test_k7_matches_plain(dev, g, n, k, real, rid0, short, window, variant,
                          scale, edges):
    rng = np.random.default_rng(n + k)
    p, b, r0, vl = (x.to(dev) for x in raw_batch(rng, g, n, k, real, rid0,
                                                 short, edges))
    mask = spaced_seed_mask(window, min(16, window), 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    nw = n - window + 1
    # scale 1 keeps every valid window: 8 slots make every row overflow
    args = dict(window=window, nw=nw, scale=scale, variant=variant,
                k_slots=8 if scale == 1 else _k_slots_for(nw, scale, 65536),
                out_words=finish_words(window))
    build.reset_launches()
    got = extract.extract_compact_raw(p, b, r0, vl, mask.words_u32, salt,
                                      **args)
    want = extract.extract_compact_raw_plain(p, b, r0, vl, mask.words_u32,
                                             salt, **args)
    torch.cuda.synchronize()
    assert build.KERNELS["K7"].launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if scale < 2 ** 20:               # 2^31 - 1 keeps next to nothing
        assert int(got[1].sum()) > 0


def test_k7_seed_mode_at_config3_shape(dev):
    """K7's seed-batch mode as sketch_packed_multiseed sends it (8 seeds
    over one compact upload of 2^23 codes in two records) against its
    plain version."""
    rng = np.random.default_rng(23)
    n, length, window = 1 << 23, 5_000_000, 20
    body = extract.packed_body(n)
    codes = rng.integers(0, 4, length).astype(np.uint8)
    p = torch.from_numpy(extract.pack2bit(codes, body // 16).view(np.int32)
                         [None]).to(dev)
    bounds = torch.tensor([[length // 2, body]], dtype=torch.int32,
                          device=dev)
    rid0 = torch.zeros(1, dtype=torch.int32, device=dev)
    vlen = torch.full((1,), length, dtype=torch.int32, device=dev)
    masks = [spaced_seed_mask(window, 16, s) for s in range(8)]
    salts = [boosthash.fmh_salt(m.lo, m.hi, window, 1, "modern")
             for m in masks]
    mw = np.stack([m.words_u32 for m in masks])
    nw = n - window + 1
    args = dict(window=window, nw=nw, scale=200, variant="modern",
                k_slots=_k_slots_for(nw, 200, 65536), out_words=2)
    build.reset_launches()
    got = extract.extract_compact_raw(p, bounds, rid0, vlen, mw, salts,
                                      **args)
    want = extract.extract_compact_raw_plain(p, bounds, rid0, vlen, mw,
                                             salts, **args)
    torch.cuda.synchronize()
    assert build.KERNELS["K7"].launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0


def write_genome(path, rng, length, gaps):
    """A FASTA of one record with N-gaps of the given lengths."""
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    for ln in gaps:
        s = int(rng.integers(0, length - ln))
        text[s:s + ln] = ord("N")
    lines = [text[i:i + 80].tobytes() for i in range(0, length, 80)]
    path.write_bytes(b">g\n" + b"\n".join(lines) + b"\n")
    return str(path)


def native_sketch(sk, pk):
    cfg = sk.config
    return native.sketch_codes(pk.codes, pk.run_lens, sk.mask.lo, sk.mask.hi,
                               cfg.window, sk.salt, cfg.scale,
                               cfg.hash_variant == "legacy")


def test_streaming_on_the_gpu_matches_native(dev, tmp_path):
    """sketch_file_streaming on the card (K7 per segment, K4 merge) equals
    the native scalar pipeline on the whole file."""
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    rng = np.random.default_rng(8)
    path = write_genome(tmp_path / "chr.fa", rng, 300_000,
                        [5000, 17, 40_000])
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=50),
                             device="cuda")
    build.reset_launches()
    got = sk.sketch_file_streaming(path, segment_nt=1 << 16)
    assert build.KERNELS["K7"].launches >= 4
    assert build.KERNELS["K4"].launches > 0
    np.testing.assert_array_equal(got.keys_u64(),
                                  native_sketch(sk, read_fasta(path)))


def test_pipeline_on_the_gpu_matches_native(dev, tmp_path):
    """all_pairs_from_files on the card (K7, K5, K10, K6) against native
    sketches and merges; device_source gives a symmetric matrix with the
    counts on its diagonal."""
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    from spaced_kmer_sketching_tpu_torch.pipeline import (
        DevicePipeline, all_pairs_from_files, device_source)
    rng = np.random.default_rng(9)
    paths = [write_genome(tmp_path / f"g{i}.fa", rng, 150_000 + 1000 * i,
                          [300])
             for i in range(130)]
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=50),
                             device="cuda")
    build.reset_launches()
    res = all_pairs_from_files(sk, paths, verify_ids=[0, 129])
    for key in ("K7", "K5", "K10", "K6"):
        assert build.KERNELS[key].launches > 0, key
    u64 = [native_sketch(sk, read_fasta(p)) for p in paths]
    np.testing.assert_array_equal(res.counts, [u.shape[0] for u in u64])
    for i in (0, 129):
        np.testing.assert_array_equal(res.sample_keys[i], u64[i])
    for a, b in [(0, 1), (5, 128), (127, 129), (64, 64)]:
        want = u64[a].shape[0] if a == b else native.intersect_sorted(
            u64[a], u64[b])
        assert res.inter[a, b] == res.inter[b, a] == want
    out = DevicePipeline(sk, dispatch=64).all_pairs(
        device_source(200, 100_000, seed=1), 200, 100_000)
    np.testing.assert_array_equal(out.inter, out.inter.T)
    np.testing.assert_array_equal(np.diag(out.inter), out.counts)


def test_pipeline_host_syncs_on_the_gpu(dev):
    """pipeline_host_syncs on the card: a block read each, a re-sketch's
    read each (none unless a genome overflows), the assembled cache's
    synchronize, one sampled genome's keys, the download and K6's count
    of the runs it multiplied (gram_kept_runs, booked once a job), in one
    attempt (no whole-run restart); the per-dispatch spans open no range
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.pipeline import (DevicePipeline,
                                                          device_source)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=50),
                             device="cuda")
    pipe = DevicePipeline(sk, dispatch=64)
    before = observability.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pipe.all_pairs(device_source(200, 100_000, seed=1), 200,
                             100_000, verify_ids=[3])
    after = observability.counters()
    syncs = after["pipeline_host_syncs"] - before.get("pipeline_host_syncs",
                                                      0)
    redos = after.get("pipeline_sketch_redos", 0) - before.get(
        "pipeline_sketch_redos", 0)
    names = [e.name for e in prof.events()]
    reads = names.count("pipeline.block_read")
    assert reads == 2                            # 200 genomes: 2 blocks
    assert names.count("pipeline.attempt") == 1 and pipe.restarts == 0
    assert names.count("pipeline.assemble") == 1
    assert "pipeline.dispatch" not in names
    assert ("pipeline.redo" in names) == (redos > 0)
    assert syncs == reads + redos + 4
    assert after.get("gram_kept_runs", 0) > before.get("gram_kept_runs", 0)
    assert out.phases["restart_s"] == 0.0
    assert (out.phases["redo_s"] > 0) == (redos > 0)


def test_pipeline_resketch_on_the_gpu_matches_native(dev):
    """One genome of 260 carries 280 codes of a period-7 unit whose one
    kept window fills ~18 of a row's 16 slots (scale 200): on the card that
    genome alone is sketched again (one re-sketch dispatch), and its
    sampled keys, the counts and the sampled pairs equal native sketches
    and merges."""
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
    from spaced_kmer_sketching_tpu_torch.pipeline import DevicePipeline
    g, n, planted = 260, 20_000, 150
    unit = np.array([3, 2, 0, 1, 3, 2, 0], np.uint8)

    def src(s0, s1):
        out = []
        for i in range(s0, s1):
            codes = np.random.default_rng(1000 + i).integers(
                0, 4, n).astype(np.uint8)
            if i == planted:
                codes[5000:5280] = np.resize(unit, 280)
            out.append(PackedSeqs(codes=codes,
                                  run_lens=np.array([n], np.int64)))
        return out
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=200),
                             device="cuda")
    ids = [3, planted, 259]
    before = observability.counters().get("pipeline_sketch_redos", 0)
    res = DevicePipeline(sk, dispatch=32).all_pairs(src, g, n,
                                                    verify_ids=ids)
    assert observability.counters()["pipeline_sketch_redos"] - before == 1
    u64 = [native_sketch(sk, src(i, i + 1)[0]) for i in range(g)]
    np.testing.assert_array_equal(res.counts, [u.shape[0] for u in u64])
    for i in ids:
        np.testing.assert_array_equal(res.sample_keys[i], u64[i])
        for j in ids:
            want = u64[i].shape[0] if i == j else native.intersect_sorted(
                u64[i], u64[j])
            assert res.inter[i, j] == res.inter[j, i] == want
    np.testing.assert_array_equal(np.diag(res.inter), res.counts)


@pytest.mark.parametrize("window,k,plane", [(20, 16, "runs"),
                                            (1, 1, "runs"), (64, 40, "runs"),
                                            (20, 16, "hard"),
                                            (64, 40, "hard")])
def test_k1_k7_seed_mode_match_plain_and_single_launches(dev, window, k,
                                                        plane):
    """K1's seed-batch mode (8 seeds over one genome) against its plain
    version and against 8 single-seed K1 launches, on three runs and on a
    non-monotone plane with -1 holes; K7's seed-batch mode over the runs'
    bounds against its plain version and K1's counts."""
    rng = np.random.default_rng(12)
    if plane == "runs":
        n = 262144
        codes, rid = genome_batch(rng, 1, n, [100000, 40, 150000])
    else:
        n = 262144 - 93
        codes = rng.integers(0, 4, (1, n)).astype(np.uint8)
        rid = hard_plane(rng, 1, n)
    masks = [spaced_seed_mask(window, k, s) for s in range(8)]
    salts = [boosthash.fmh_salt(m.lo, m.hi, window, 1, "modern")
             for m in masks]
    mw = np.stack([m.words_u32 for m in masks])
    p = extract.pack_codes(torch.from_numpy(codes).to(dev))
    r = torch.from_numpy(rid).to(dev)
    nw = n - window + 1
    scale = 2 if window == 1 else 50
    args = dict(window=window, nw=nw, scale=scale, variant="modern",
                k_slots=_k_slots_for(nw, scale, 8192),
                out_words=finish_words(window))
    build.reset_launches()
    got = extract.extract_compact(p, r, mw, salts, **args)
    assert build.KERNELS["K1"].launches == 1
    want = extract.extract_compact_plain(p, r, mw, salts, **args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0
    for i in range(8):
        one = extract.extract_compact(p, r, mw[i], salts[i], **args)
        assert torch.equal(got[0][:, i:i + 1], one[0])
        assert torch.equal(got[1][i:i + 1], one[1])
    if plane != "runs":
        return
    body = extract.packed_body(n)
    pb = torch.from_numpy(extract.pack2bit(codes[0], body // 16)
                          .view(np.int32)[None]).to(dev)
    bounds = torch.tensor([[100000, 100040, body]], dtype=torch.int32,
                          device=dev)
    rid0 = torch.zeros(1, dtype=torch.int32, device=dev)
    vlen = torch.tensor([250040], dtype=torch.int32, device=dev)
    raw = extract.extract_compact_raw(pb, bounds, rid0, vlen, mw, salts,
                                      **args)
    raw_plain = extract.extract_compact_raw_plain(pb, bounds, rid0, vlen, mw,
                                                  salts, **args)
    torch.cuda.synchronize()
    assert torch.equal(raw[0], raw_plain[0]) and torch.equal(raw[1],
                                                             raw_plain[1])
    assert torch.equal(raw[1], got[1])


@pytest.mark.parametrize("window,k,variant,g,plane", [
    (20, 16, "modern", 2, "runs"), (33, 25, "legacy", 2, "runs"),
    (64, 40, "modern", 2, "runs"), (1, 1, "modern", 3, "hard"),
    (20, 16, "modern", 5, "hard"), (33, 25, "legacy", 3, "hard"),
    (64, 40, "modern", 5, "hard")])
def test_k11_matches_plain(dev, window, k, variant, g, plane):
    """K11 against its plain version at every window, valid or not, on
    three runs and on non-monotone planes with -1 holes whose nw is odd
    at G = 3 and 5, so plane rows and keep rows start at every offset
    from 16-byte alignment."""
    rng = np.random.default_rng(window)
    if plane == "runs":
        codes, rid = genome_batch(rng, g, 262144, [100000, 40, 100000])
    else:
        n = 262144 - 93 + (window + 1) % 2        # nw odd
        codes = rng.integers(0, 4, (g, n)).astype(np.uint8)
        rid = hard_plane(rng, g, n)
        assert (n - window + 1) % 2 == 1
    mask = spaced_seed_mask(window, k, 1)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    c = torch.from_numpy(codes).to(dev)
    r = torch.from_numpy(rid).to(dev)
    args = dict(window=window, scale=2 if window == 1 else 20,
                variant=variant)
    build.reset_launches()
    got = extract.extract_filter(c, r, mask.words_u32, salt, **args)
    want = extract.extract_filter_plain(c, r, mask.words_u32, salt, **args)
    torch.cuda.synchronize()
    assert build.KERNELS["K11"].launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("kw,g,runs,run", [(2, 8, 2, 2048), (2, 1, 8, 32768),
                                           (4, 3, 3, 1024), (1, 2, 4, 128)])
def test_k8_matches_plain(dev, kw, g, runs, run):
    z = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, g, runs * run),
                      dtype=torch.int32, device=dev)
    z[:, :, ::3] = z[:, :, 1:2]
    z[:, :, -(run // 3):] = -1
    assert torch.equal(sort.sort_runs(z, run), sort.sort_runs_plain(z, run))


@pytest.mark.parametrize("kw,g,t,cap", [(2, 1, 4, 2048), (2, 2, 16, 8192),
                                        (4, 1, 2, 256), (2, 3, 4, 512),
                                        (1, 2, 2, 65536)])
def test_k9_matches_plain(dev, kw, g, t, cap):
    z = torch.full((kw, g, t * sort.TILE), -1, dtype=torch.int32, device=dev)
    hit = torch.rand(g, t * sort.TILE, device=dev) < cap / (3 * t * sort.TILE)
    z[:, hit] = torch.randint(0, 2 ** 31 - 1, (kw, int(hit.sum())),
                              dtype=torch.int32, device=dev)
    assert torch.equal(sort.sort_truncate(z, cap),
                       sort.sort_truncate_plain(z, cap))


def k8_input(dev, kw, g, runs, run, kind, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, g, runs * run),
                      dtype=torch.int32, device=dev, generator=gen)
    if kind == "duplicates":
        z &= 3                            # a four-letter alphabet: ties
    elif kind == "sentinel runs":
        z.view(kw, g, runs, run)[:, :, 1::2] = -1
        z.view(kw, g, runs, run)[:, :, 0, run // 3:] = -1
    return z


@pytest.mark.parametrize("kind", ["random", "duplicates", "sentinel runs"])
@pytest.mark.parametrize("runs", [1, 3, 4])
@pytest.mark.parametrize("run", [128, 256, 512, 1024, 2048, 4096, 8192,
                                 16384, 32768])
def test_k8_runs_tile_and_level_stores_match_plain(dev, run, runs, kind):
    """K8 at runs of 128 to 32,768 (the tile's reversed store up to 4,096,
    the last level's above), odd and even run counts a row, rows of
    sentinel runs and heavy duplicates; kw 1-4 by run."""
    kw = 1 + run.bit_length() % 4
    z = k8_input(dev, kw, 2, runs, run, kind, run + runs)
    assert torch.equal(sort.sort_runs(z, run), sort.sort_runs_plain(z, run))


@pytest.mark.parametrize("g,runs,run,most", [(8, 2, 2048, 1),
                                             (1, 8, 32768, 4)])
def test_k8_device_launches(dev, g, runs, run, most):
    """One launch at _finish_runs' shape (8 rows of 2 runs of 2,048), at
    most 4 at 8 runs of 32,768."""
    from chip_smoke import device_launches
    z = k8_input(dev, 2, g, runs, run, "random", 3)
    n = device_launches(lambda: sort.sort_runs(z, run))
    assert n is not None and 1 <= n <= most


def k9_input(dev, kw, g, t, cap, kind, seed):
    """(kw, g, t * 32,768) planes: "exact" every tile holds exactly its cut
    of valid keys, "ties" the same keys in every tile of a row, "full" no
    sentinel, "over" tiles with more valid keys than their cut."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cut, m = cap // t, t * sort.TILE
    z = torch.full((kw, g, m), -1, dtype=torch.int32, device=dev)
    keys = torch.randint(0, 2 ** 31 - 1, (kw, g, m), dtype=torch.int32,
                         device=dev, generator=gen)
    if kind == "full":
        return keys
    tiles = z.view(kw, g, t, sort.TILE)
    order = torch.rand((g, t, sort.TILE), device=dev,
                       generator=gen).argsort(-1)
    count = min(2 * cut, sort.TILE) if kind == "over" else cut
    pos = order[..., :count]
    if kind == "ties":
        pos = pos[:, :1].expand(g, t, count)
        keys.view(kw, g, t, sort.TILE)[:] = keys.view(
            kw, g, t, sort.TILE)[:, :, :1].clone()
    src = keys.view(kw, g, t, sort.TILE).gather(
        -1, pos[None].expand(kw, g, t, count))
    tiles.scatter_(-1, pos[None].expand(kw, g, t, count), src)
    return z


@pytest.mark.parametrize("kind", ["exact", "ties", "full", "over"])
@pytest.mark.parametrize("kw,g,t,cap", [(2, 1, 4, 2048), (1, 2, 2, 65536),
                                        (4, 1, 2, 256), (2, 2, 4, 512),
                                        (3, 1, 2, 8192), (2, 1, 16, 8192),
                                        (1, 1, 2, 4096), (2, 1, 8, 32768)])
def test_k9_cut_shapes_match_plain(dev, kw, g, t, cap, kind):
    """K9 with tiles holding exactly their cut of valid keys, the same
    keys in every tile (ties across tiles), no sentinels, and more valid
    keys than the cut; cut 128 to 32,768 (no cut at 65,536 over t = 2)."""
    z = k9_input(dev, kw, g, t, cap, kind, t * cap + kw)
    assert torch.equal(sort.sort_truncate(z, cap),
                       sort.sort_truncate_plain(z, cap))


@pytest.mark.parametrize("t,cap,most", [(4, 2048, 3), (16, 8192, 3)])
def test_k9_device_launches(dev, t, cap, most):
    """At most 3 launches at the tiled finish's shapes."""
    from chip_smoke import device_launches
    z = k9_input(dev, 2, 1, t, cap, "exact", 5)
    n = device_launches(lambda: sort.sort_truncate(z, cap))
    assert n is not None and 1 <= n <= most


@pytest.mark.parametrize("n,cap,scale,route,kernel", [
    (65536, 512, 100, "runs", "K8"), (1 << 19, 512, 100, "tiled", "K9")])
def test_fallback_finishes_on_the_gpu(dev, n, cap, scale, route, kernel):
    """The dyn step at shapes that take the JAX `_finish_runs` (K8, K5)
    and the tiled `_finish_candidates` (K9) gives the plain versions'
    result and launches the kernel."""
    from spaced_kmer_sketching_tpu_torch.ops import sketch as sk
    rng = np.random.default_rng(n)
    codes, rid = genome_batch(rng, 2, n, [32000, 15000])
    mask = spaced_seed_mask(20, 16, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, 20, 1, "modern")
    p = torch.from_numpy(extract.pack2bit_rows(codes).view(np.int32))
    r = torch.from_numpy(rid)
    nw = n - 16
    k_slots = _k_slots_for(nw, scale, cap)
    assert sk.finish_route(extract.out_rows(nw) * k_slots, nw, k_slots, cap,
                           scale, 2) == route
    args = dict(n=n, kw=2, scale=scale, variant="modern", capacity=cap)
    want = sketch_batch_packed_dyn(p, r, mask.words_u32, salt, 20, **args)
    build.reset_launches()
    got = sketch_batch_packed_dyn(p.to(dev), r.to(dev), mask.words_u32, salt,
                                  20, **args)
    assert build.KERNELS[kernel].launches == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_multiseed_and_single_genome_on_the_gpu_match_native(dev):
    """sketch_packed_multiseed on the card (one K7 launch for 8 seeds)
    and sketch_from_codes (K11, K4) against the native scalar pipeline."""
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
    from spaced_kmer_sketching_tpu_torch.ops.sketch import sketch_from_codes
    rng = np.random.default_rng(13)
    lens = np.array([150000, 30, 80000], np.int64)
    pk = PackedSeqs(rng.integers(0, 4, int(lens.sum())).astype(np.uint8),
                    lens)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=50),
                             device="cuda")
    build.reset_launches()
    out = sk.sketch_packed_multiseed(pk)
    assert build.KERNELS["K7"].launches == 1 and len(out) == 8
    for seed, s in enumerate(out):
        one = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=50,
                                               mask_seed=seed), device="cpu")
        assert s.mask == one.mask
        np.testing.assert_array_equal(s.keys_u64(), native_sketch(one, pk))
    rid = np.repeat(np.arange(3, dtype=np.int32), lens)
    cfg = sk.config
    got = sketch_from_codes(
        torch.from_numpy(pk.codes).to(dev), torch.from_numpy(rid).to(dev),
        sk.mask.words_u32, window=20, salt=sk.salt, scale=cfg.scale,
        variant="modern", capacity=cfg.capacity_for(pk.codes.size))
    assert build.KERNELS["K11"].launches == 1
    c = int(got.count)
    keys = got.keys[:c].cpu().numpy().view(np.uint32).astype(np.uint64)
    u64 = np.stack([keys[:, 0] | keys[:, 1] << np.uint64(32),
                    keys[:, 2] | keys[:, 3] << np.uint64(32)], axis=1)
    np.testing.assert_array_equal(u64, native_sketch(sk, pk))


def test_intersection_tile_on_the_gpu_equals_cpu(dev):
    """The probe (ops/intersect.py) on the card against its CPU result, on
    sketches whose key words all have bit 31 set, a real all-ones key and
    counts of 0 and of cap."""
    from spaced_kmer_sketching_tpu_torch.ops.intersect import (
        all_pairs_matrix, intersection_tile)
    rng = np.random.default_rng(21)
    g, cap = 8, 1024
    pool = rng.integers(2 ** 31, 2 ** 32, (3 * cap, 4), dtype=np.uint64)
    pool[0] = 0xFFFFFFFF
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.array([cap, 0, 1, 500, cap - 1, 17, cap, 300], np.int32)
    for i, c in enumerate(counts):
        sel = pool[rng.choice(pool.shape[0], int(c), replace=False)]
        if i in (0, 6):
            sel[0] = 0xFFFFFFFF          # a real all-ones key
        u = np.unique(sel[:, ::-1], axis=0)[:, ::-1].astype(np.uint32)
        keys[i, :u.shape[0]] = u
        counts[i] = u.shape[0]
    k = torch.from_numpy(keys.view(np.int32))
    c = torch.from_numpy(counts)
    want = intersection_tile(k, c, k, c)
    got = intersection_tile(k.to(dev), c.to(dev), k.to(dev), c.to(dev))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(all_pairs_matrix(k.to(dev), c.to(dev)).cpu(), want)
    assert int(want[0, 6]) > 0 and int(want[1].sum()) == 0


def test_bench_sketch_mode_is_verified(dev, capsys):
    """The bench's sketch mode in-process at 2^20 nt: every genome's keys
    and the intersection tile equal the native pipeline, on the gpu."""
    import json
    from spaced_kmer_sketching_tpu_torch import bench
    rc = bench.main(["--mode", "sketch", "--nt", "1048576", "--iters", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["verified"] is True
    assert line["platform"] == "gpu" and line["launches"]["K1"] > 0


# --- the multi-GPU layer on one card: meshes whose slots are all cuda:0 -----

def card_mesh(shape):
    from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(shape, ["cuda:0"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_mesh_ring_on_one_card_matches_single_device(dev, shape):
    """The full-plane and compact rings (K11 a chunk, the merge: K4, K3)
    over a mesh of cuda:0 == sketch_core on the whole sequence on the card
    and the plain ring on the CPU: keys, count and raw_kept; a run start
    on a chunk edge and a short valid length."""
    from spaced_kmer_sketching_tpu_torch.ops.sketch import sketch_core
    from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
    from spaced_kmer_sketching_tpu_torch.parallel.sequence import (
        sequence_parallel_sketch_compact_fn, sequence_parallel_sketch_fn)
    rng = np.random.default_rng(21)
    n, window = 1 << 20, 20
    mask = spaced_seed_mask(window, 16, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    args = dict(window=window, salt=salt, scale=50, variant="modern",
                capacity=1 << 15)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    starts, vlen = [n // 4, 3 * n // 4 + 7], n - 5000
    bounds = np.full(8, n, np.int32)
    bounds[:2] = starts
    rid = np.full(n, -1, np.int32)
    rid[:vlen] = np.searchsorted(bounds, np.arange(vlen), side="right")
    build.reset_launches()
    got = sequence_parallel_sketch_fn(card_mesh(shape), **args)(
        codes, rid, mask.words_u32)
    assert build.KERNELS["K11"].launches == shape[0] * shape[1]
    whole = sketch_core(torch.from_numpy(codes).to(dev),
                        torch.from_numpy(rid).to(dev), mask.words_u32, **args)
    plain = sequence_parallel_sketch_fn(make_mesh(shape, ["cpu"] * (
        shape[0] * shape[1])), **args)(codes, rid, mask.words_u32)
    p = native.pack2bit(codes, n // 16).view(np.int32)
    compact = sequence_parallel_sketch_compact_fn(card_mesh(shape), **args)(
        p, bounds, np.zeros(1, np.int32), np.array([vlen], np.int32),
        mask.words_u32)
    assert int(got.raw_kept) <= args["capacity"] and int(got.count) > 0
    for other in (whole, plain, compact):
        assert torch.equal(got.keys.cpu(), other.keys.cpu())
        assert int(got.count) == int(other.count)
    for other in (plain, compact):
        assert int(got.raw_kept) == int(other.raw_kept)


def test_mesh_sketcher_on_one_card_matches_single_device(dev, tmp_path):
    """MeshSketcher over a 2 x 2 mesh of cuda:0: sketch_files (the sharded
    K1 batch), sketch_packed past seq_par_threshold (the ring, K11) and
    all_pairs_intersections (mesh_all_pairs_packed over 3 blocks) == the
    single-device sketcher and the native pipeline."""
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    from spaced_kmer_sketching_tpu_torch.parallel.sketcher import (
        MeshSketcher)
    rng = np.random.default_rng(22)
    paths = [write_genome(tmp_path / f"g{i}.fa", rng, 20_000 + 3_000 * i,
                          [500]) for i in range(6)]
    cfg = SketchConfig(window=20, k=16, scale=20)
    mesh_sk = MeshSketcher(cfg, card_mesh((2, 2)), seq_par_threshold=30_000)
    single = FracMinHashSketcher(cfg, device="cuda")
    build.reset_launches()
    got = mesh_sk.sketch_files(paths)
    assert build.KERNELS["K1"].launches > 0
    assert build.KERNELS["K11"].launches == 0
    ring = [mesh_sk.sketch_packed(read_fasta(p), name=p) for p in paths]
    assert build.KERNELS["K11"].launches > 0
    for p, s, r, w in zip(paths, got, ring, single.sketch_files(paths)):
        for x in (s, r):
            assert x.count == w.count and np.array_equal(x.keys, w.keys)
        np.testing.assert_array_equal(s.keys_u64(),
                                      native_sketch(single, read_fasta(p)))
    many = [got[i % 6] for i in range(300)]
    np.testing.assert_array_equal(mesh_sk.all_pairs_intersections(many),
                                  single.all_pairs_intersections(many))


def test_mesh_pipeline_on_one_card_matches_device_pipeline(dev):
    """MeshDevicePipeline over a 2 x 2 mesh of cuda:0 (dispatches of 512,
    one block a slot, the last slots ragged) == DevicePipeline over the
    same 512-genome batches: counts, matrix, sample keys."""
    from spaced_kmer_sketching_tpu_torch.pipeline import (
        DevicePipeline, MeshDevicePipeline, device_source)
    g, n = 700, 100_000
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=50),
                             device="cuda")
    pipe = MeshDevicePipeline(sk, card_mesh((2, 2)))
    build.reset_launches()
    res = pipe.all_pairs(device_source(g, n, seed=5), g, n,
                         verify_ids=[0, 511, 699])
    for key in ("K7", "K5", "K10", "K6"):
        assert build.KERNELS[key].launches > 0, key
    want = DevicePipeline(sk, dispatch=512).all_pairs(
        device_source(g, n, seed=5), g, n, verify_ids=[0, 511, 699])
    np.testing.assert_array_equal(res.counts, want.counts)
    np.testing.assert_array_equal(res.inter, want.inter)
    for i in (0, 511, 699):
        np.testing.assert_array_equal(res.sample_keys[i],
                                      want.sample_keys[i])


# --- K12: a bit-tight block into K5's packed planes --------------------------

def k12_case(dev, rng, key_bits, gidbits, rows, cap, counts):
    """K12 on the card against its plain version on the same tight block
    of random words (bits above key_bits and past the counts included)."""
    keys = rng.integers(0, 1 << 32, (rows, cap, 2), dtype=np.uint64).astype(
        np.uint32)
    counts = np.asarray(counts, np.int32)
    packed = gram.pack_keys_tight_np(keys, counts, key_bits)
    t = torch.from_numpy(packed.view(np.int32)).to(dev)
    c = torch.from_numpy(counts).to(dev)
    kw = dict(key_bits=key_bits, gidbits=gidbits,
              pw=gram.pack_plan(key_bits, gidbits))
    build.reset_launches()
    got = tight.tight_gid_planes(t, c, **kw)
    torch.cuda.synchronize()
    assert build.KERNELS["K12"].launches == 1
    assert torch.equal(got, tight.tight_gid_planes_plain(t, c, **kw))
    return got


@pytest.mark.parametrize("fill", ["empty", "ragged", "full"])
@pytest.mark.parametrize("key_bits", [16, 40, 64])
def test_k12_matches_plain(dev, key_bits, fill):
    """128 rows of capacity 1,024, counts 0, ragged or full."""
    rng = np.random.default_rng(key_bits)
    rows, cap = 128, 1024
    counts = {"empty": np.zeros(rows), "full": np.full(rows, cap),
              "ragged": rng.integers(0, cap + 1, rows)}[fill]
    got = k12_case(dev, rng, key_bits, 8, rows, cap, counts)
    valid = (got[-1] >= 0).sum().item()
    assert valid == int(np.sum(counts))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(key_bits=st.integers(1, 64), rows=st.integers(1, 200),
       extra_gid=st.integers(0, 8), cap=st.sampled_from([128, 256, 512]),
       seed=st.integers(0, 2 ** 31))
def test_k12_property(dev, key_bits, rows, extra_gid, cap, seed):
    """Any key width to 64 bits, gid field and row count; counts from
    below 0 to past the capacity."""
    rng = np.random.default_rng(seed)
    gidbits = min(31, max(1, (rows - 1).bit_length()) + extra_gid)
    k12_case(dev, rng, key_bits, gidbits, rows, cap,
             rng.integers(-3, cap + 4, rows))


def test_blocked_transports_match_on_card(dev):
    """blocked_all_pairs on 300 host sketches of capacity 1,024: the tight
    transport (K12 once a block) and the word transport (no K12) give one
    matrix."""
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs
    rng = np.random.default_rng(13)
    g, cap = 300, 1024
    pool = np.cumsum(rng.integers(1, 1 << 20, 4000)).astype(np.uint64)
    keys = np.full((g, cap, 2), 0xFFFFFFFF, np.uint32)
    for i in range(g):
        v = np.unique(rng.choice(pool, 900))
        keys[i, :v.size, 0] = (v & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :v.size, 1] = (v >> np.uint64(32)).astype(np.uint32)
    got = {}
    for transport, k12 in (("tight", 3), ("words", 0)):
        build.reset_launches()
        got[transport] = allpairs.blocked_all_pairs(
            keys, key_bits=40, device=dev, transport=transport)
        assert build.KERNELS["K12"].launches == k12
    np.testing.assert_array_equal(got["tight"], got["words"])
    assert np.all(np.diag(got["tight"]) > 0)
