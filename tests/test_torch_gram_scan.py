"""Models of the decompositions of K6 (the Gram scan) and K3
(compact_global), held on the CPU to the plain versions and to the JAX
kernels in interpret mode.

The CUDA kernels cannot run here, so each test re-traces one kernel's
decomposition in numpy, at sizes small enough that every edge is crossed:
K6's segments owning the runs that start in them, back-to-back chunks
whose last run stays open into the next (runs longer than a chunk), the
reads past a segment that only finish its open run, chunks of
single-entry runs cut short, the keep filter, the kept runs numbered by
an entry scan of their first entries, each batch of columns written from
its own contiguous range of entries into K-major multi-hots and an exact
integer A B^T, the diagonal as a count, segments sized over the valid
entries that two rounds of probes find; K3's tile counts, their offsets scanned in rounds,
the ranked scatter of each tile and the sentinel tail.  The models live here, not in the package: they are
what the kernels compute, written once more.  Every value is an integer,
so every comparison is exact (tolerance 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops.pallas.compact import (
    compact_global as jax_compact_global)
from spaced_kmer_sketching_tpu.ops.pallas.gram_tiles import (
    gram_tile_scan_fused)

from spaced_kmer_sketching_tpu_torch.ops.cuda import compact, gram_tiles
from spaced_kmer_sketching_tpu_torch.ops.gram import pack_plan

SENT = 0xFFFFFFFF
M32 = (1 << 32) - 1
GT = 128


def i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


# --- K6 ---------------------------------------------------------------------

def packed_stream(rng, g, key_bits, gidbits, *, universe, per, every=0,
                  pad=64):
    """(pw, n) uint32 ascending packed stream of g genomes' keys (each
    draws `per` of a `universe` of distinct keys; `every` more keys are
    held by every genome), then `pad` all-ones sentinels; and the key
    sets."""
    pw = pack_plan(key_bits, gidbits)
    uni = set()
    while len(uni) < universe + every:
        uni.add(int.from_bytes(rng.bytes(16), "little") % (1 << key_bits))
    uni = sorted(uni)
    rng.shuffle(uni)
    shared, pool = uni[:every], uni[every:]
    sets = []
    for _ in range(g):
        pick = rng.choice(len(pool), min(per, len(pool)), replace=False)
        sets.append(set(shared) | {pool[i] for i in pick})
    vals = sorted((k << gidbits) | gid for gid, s in enumerate(sets)
                  for k in s)
    words = [[(v >> (32 * q)) & M32 for q in range(pw)] for v in vals]
    words += [[M32] * pw] * pad
    return np.array(words, np.uint64).T.astype(np.uint32), sets


def own_segment(valid, blocks, chunk, slack=64, threads=256):
    """K6's own segment length for a grid `blocks` wide: two rounds of a
    probe a thread bound the first sentinel (valid entries are a prefix)
    from above, and whole chunks less `slack` entries cover that many
    entries over the blocks.  Returns (segment, the bound)."""
    n = valid.size
    lo, hi = 0, n
    for _ in range(2):
        if lo >= hi:
            break
        step = -(-(hi - lo) // threads)
        k = sum(1 for t in range(threads)
                if lo + t * step < hi and valid[lo + t * step])
        hi, lo = ((min(hi, lo + k * step), lo + (k - 1) * step + 1) if k
                  else (lo, lo))
    per = chunk - slack
    return (-(-hi // (per * blocks)) if hi > 0 else 1) * per, hi


def k6_model(sw, gidbits, gp, split=None, *, seg, chunk, kb, blocks=0):
    """K6's decomposition (csrc/gram_tiles.cu) over a (pw, n) stream;
    seg 0 sizes the segments as the kernel does for a grid `blocks`
    wide."""
    pw, n = sw.shape
    gmask = (1 << gidbits) - 1
    valid = (sw[pw - 1] >> 31) == 0
    key = sw.copy()
    key[0] &= ~np.uint32(gmask)
    gid = (sw[0] & gmask).astype(np.int64)
    start = np.ones(n, bool)
    start[1:] = (key[:, 1:] != key[:, :-1]).any(0)
    sym = split is None
    rows, c0 = (gp, 0) if sym else (split, split)
    out = np.zeros((rows, gp - c0), np.int64)
    if seg == 0:
        seg, _ = own_segment(valid, blocks, chunk)
        assert seg * blocks >= valid.sum()
    for tr in range(rows // GT):
        for tc in range((gp - c0) // GT):
            if sym and tr > tc:
                continue
            diag = sym and tr == tc
            r0, cg0 = tr * GT, c0 + tc * GT
            for s0 in range(0, n, seg):
                acc = k6_segment(valid, start, gid, s0, min(s0 + seg, n),
                                 r0, cg0, diag, chunk, kb, gp)
                out[r0:r0 + GT, cg0 - c0:cg0 - c0 + GT] += acc
                if sym and not diag:
                    out[cg0:cg0 + GT, r0:r0 + GT] += acc.T
    return out


def k6_segment(valid, start, gid, s0, s1, r0, cg0, diag, chunk, kb, gp):
    """One block: the (128, 128) sums of the runs starting in [s0, s1)."""
    n = valid.size
    acc = np.zeros((GT, GT), np.int64)
    dcount = np.zeros(GT, np.int64)
    open_in = np.zeros((2, GT), bool)    # the open run's row, column gids
    carry_in = (False, False)            # and its flags
    nopen = 0
    p = s0
    more = p < s1 and valid[p]
    while more:
        ln = min(n - p, chunk if p < s1 else min(gp, chunk))
        nxt = p + ln
        st = start[p:nxt]
        next_valid = nxt < n and valid[nxt]
        cont = next_valid and not start[nxt]
        r = np.cumsum(st) - 1 + nopen
        last = int(r[-1])
        lim = max(0, min(s1 - p, ln))
        own = nopen + (int(r[lim - 1]) + 1 - nopen if lim else 0)
        carry = cont and 0 <= last < own
        done = last if carry else own
        more = next_valid and (carry or nxt < s1)
        use = (r >= 0) & (r < own) & valid[p:nxt]
        g = gid[p:nxt]
        in_r = (g >= r0) & (g < r0 + GT)
        in_c = (g >= cg0) & (g < cg0 + GT) & (not diag)
        if not ((use & ~st).any() or carry):     # owned runs of one entry
            if diag:
                np.add.at(dcount, g[use & in_r] - r0, 1)
            p = nxt
            continue
        has_r = np.zeros(own, bool)
        has_c = np.zeros(own, bool)
        if nopen:
            has_r[0], has_c[0] = carry_in
        open_out = (open_in if carry and nopen and last == 0
                    else np.zeros((2, GT), bool))
        for e in np.flatnonzero(use):
            if diag:
                if in_r[e]:
                    dcount[g[e] - r0] += 1
                    if not st[e] and r0 <= gid[p + e - 1] < r0 + GT:
                        has_r[r[e]] = True
            else:
                has_r[r[e]] |= in_r[e]
                has_c[r[e]] |= in_c[e]
            if carry and r[e] == last:
                if in_r[e]:
                    open_out[0, g[e] - r0] = True
                if in_c[e]:
                    open_out[1, g[e] - cg0] = True
        keep = has_r & (has_c | diag)
        keep[done:] = False
        # columns: an entry scan of the kept runs' first entries (the run
        # carried in, if kept, is column 0); each batch's kept runs are the
        # entries from its first column's first entry to the next batch's
        kept0 = bool(nopen and keep[0])
        k = np.zeros(ln, bool)
        k[use] = keep[r[use]]
        first = k & st
        col = np.cumsum(first) - 1 + kept0
        batches = -(-(int(first.sum()) + kept0) // kb)
        bstart = [0] * batches + [ln]
        for e in np.flatnonzero(k & (st | (np.arange(ln) == 0))):
            if col[e] % kb == 0:
                bstart[col[e] // kb] = e
        for bi in range(batches):
            a = np.zeros((GT, kb), np.int8)
            b = np.zeros((GT, kb), np.int8)
            for e in range(bstart[bi], bstart[bi + 1]):
                if not k[e]:
                    continue
                c = col[e] - bi * kb
                assert 0 <= c < kb                 # one batch's range
                if in_r[e]:
                    a[g[e] - r0, c] = 1
                if in_c[e]:
                    b[g[e] - cg0, c] = 1
            if kept0 and bi == 0:                  # the run carried in
                a[open_in[0], 0] = 1
                b[open_in[1], 0] = 1
            acc += a.astype(np.int32) @ (a if diag else b).astype(np.int32).T
        if carry:
            carry_in = (has_r[last], has_c[last])
        open_in = open_out
        nopen = int(carry)
        p = nxt
    if diag:
        acc[np.arange(GT), np.arange(GT)] = dcount
    return acc


def brute(sets, gp):
    out = np.zeros((gp, gp), np.int64)
    for a, sa in enumerate(sets):
        for b, sb in enumerate(sets):
            out[a, b] = len(sa & sb)
    return out


K6_CASES = [  # (seed, g, key_bits, gidbits, universe, per, every, gp)
    (0, 100, 20, 7, 40, 12, 2, 128),      # pw 1, keys in every genome
    (1, 200, 40, 8, 90, 20, 1, 256),      # pw 2, runs of 200 across edges
    (2, 150, 128, 8, 60, 6, 0, 256),      # pw 5, short runs
    (3, 256, 24, 8, 300, 3, 1, 256),      # mostly single-entry runs
    (4, 64, 40, 6, 100000, 20, 0, 128),   # chunks of single-entry runs
    (5, 300, 40, 9, 30, 4, 2, 384),       # runs of 300, past 2 chunks
]


@pytest.mark.parametrize("seed,g,key_bits,gidbits,universe,per,every,gp",
                         K6_CASES)
def test_k6_model_matches_plain(seed, g, key_bits, gidbits, universe, per,
                                every, gp):
    """Full mode and split 128 at segments of 64 and 997 entries, chunks
    of 2 * gp and of 48 entries (runs open across several chunks) and
    32- and 128-column batches: equal to the plain version, and full mode
    to brute-force set intersections."""
    rng = np.random.default_rng(seed)
    sw, sets = packed_stream(rng, g, key_bits, gidbits, universe=universe,
                             per=per, every=every)
    assert sw.shape[0] == pack_plan(key_bits, gidbits)
    t = i32(sw)
    full = gram_tiles.gram_tile_scan_plain(t, gidbits, gp).numpy()
    want = brute(sets, gp)
    np.testing.assert_array_equal(full, want)
    for seg, chunk, kb in ((64, 2 * gp, 32), (997, 48, 128)):
        np.testing.assert_array_equal(
            k6_model(sw, gidbits, gp, seg=seg, chunk=chunk, kb=kb), want)
    if gp > GT:
        rect = gram_tiles.gram_tile_scan_plain(t, gidbits, gp, split=GT)
        np.testing.assert_array_equal(rect.numpy(), want[:GT, GT:])
        np.testing.assert_array_equal(
            k6_model(sw, gidbits, gp, GT, seg=77, chunk=40, kb=32),
            want[:GT, GT:])


@pytest.mark.parametrize("split", [None, GT])
def test_k6_model_matches_jax(split):
    """One pw 2 stream, runs across every edge, against the fused Pallas
    kernel in interpret mode (n padded to whole 1,024-entry steps)."""
    rng = np.random.default_rng(11)
    gidbits, gp = 8, 256
    sw, sets = packed_stream(rng, 180, 40, gidbits, universe=40, per=10,
                             every=1, pad=0)
    n = -(-sw.shape[1] // 1024) * 1024
    sw = np.concatenate([sw, np.full((sw.shape[0], n - sw.shape[1]), SENT,
                                     np.uint32)], 1)
    want = np.asarray(gram_tile_scan_fused([jnp.asarray(w) for w in sw],
                                           gidbits, gp, split=split, sb=8,
                                           interpret=True)).astype(np.int64)
    got = k6_model(sw, gidbits, gp, split, seg=500, chunk=2 * gp, kb=64)
    np.testing.assert_array_equal(got, want)
    full = brute(sets, gp)
    np.testing.assert_array_equal(got, full if split is None
                                  else full[:GT, GT:])


def test_k6_model_split_on_a_diagonal_macro_tile():
    """Split mode over the merged stream of one block with itself, its
    column gids + 128 (gram_pair_tile of a block with itself): (a, a + 128) is a's
    sketch size."""
    rng = np.random.default_rng(5)
    gidbits, blk = 8, 128
    half, sets = packed_stream(rng, blk, 40, gidbits, universe=50, per=15,
                               pad=0)
    vals = [sum(int(w) << (32 * q) for q, w in enumerate(col))
            for col in half.T]
    both = sorted(vals + [v + blk for v in vals])
    pw = half.shape[0]
    sw = np.array([[(v >> (32 * q)) & M32 for q in range(pw)] for v in both]
                  + [[M32] * pw] * 10, np.uint64).T.astype(np.uint32)
    want = brute(sets, blk)
    assert np.array_equal(np.diag(want), [len(s) for s in sets])
    got = k6_model(sw, gidbits, 2 * blk, blk, seg=128, chunk=512, kb=32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gram_tiles.gram_tile_scan_plain(
        i32(sw), gidbits, 2 * blk, split=blk).numpy(), want)


def test_k6_model_all_sentinel_stream():
    sw = np.full((2, 3000), SENT, np.uint32)
    for split in (None, GT):
        rows = 256 if split is None else GT
        want = np.zeros((rows, 256 - (split or 0)), np.int64)
        np.testing.assert_array_equal(
            k6_model(sw, 8, 256, split, seg=700, chunk=512, kb=32), want)
        np.testing.assert_array_equal(gram_tiles.gram_tile_scan_plain(
            i32(sw), 8, 256, split=split).numpy(), want)


@pytest.mark.parametrize("chunk,seg", [(16, 100), (128, 4096)])
def test_k6_model_runs_longer_than_chunks(chunk, seg):
    """A key in every one of 260 genomes (runs of 260 entries) and gp 384
    at chunks of 16 and of 128 entries: each such run stays open across
    chunk edges, and past a segment's end a block reads on only to finish
    it; full and split mode equal brute force and the JAX kernel."""
    rng = np.random.default_rng(chunk)
    gidbits, gp = 9, 384
    sw, sets = packed_stream(rng, 260, 40, gidbits, universe=25, per=3,
                             every=3, pad=0)
    n = -(-sw.shape[1] // 1024) * 1024
    sw = np.concatenate([sw, np.full((sw.shape[0], n - sw.shape[1]), SENT,
                                     np.uint32)], 1)
    want = brute(sets, gp)
    assert want[:260, :260].min() >= 3
    np.testing.assert_array_equal(
        k6_model(sw, gidbits, gp, seg=seg, chunk=chunk, kb=64), want)
    rect = np.asarray(gram_tile_scan_fused([jnp.asarray(w) for w in sw],
                                           gidbits, gp, split=256, sb=8,
                                           interpret=True)).astype(np.int64)
    np.testing.assert_array_equal(rect, want[:256, 256:])
    np.testing.assert_array_equal(
        k6_model(sw, gidbits, gp, 256, seg=seg, chunk=chunk, kb=64), rect)


@pytest.mark.parametrize("g,pad,blocks", [
    (200, 64, 264), (200, 30000, 264), (256, 9000, 5), (100, 0, 2)])
def test_k6_model_own_segments(g, pad, blocks):
    """Segments sized by the kernel (seg 0) over the valid entries that two
    rounds of probes bound from above, whatever sentinel tail the stream
    has: the bound is within n / 2^16 of the valid count, the segments
    cover every valid entry, and full and split mode equal brute force."""
    rng = np.random.default_rng(g + pad)
    gidbits, gp = 8, 256
    sw, sets = packed_stream(rng, g, 40, gidbits, universe=60, per=20,
                             every=1, pad=pad)
    valid = (sw[-1] >> 31) == 0
    nv, n = int(valid.sum()), sw.shape[1]
    for chunk in (512, 4096):
        seg, hi = own_segment(valid, blocks, chunk)
        assert nv <= hi <= nv + n // 256 ** 2 + 1
        assert seg % (chunk - 64) == 0 and seg * blocks >= nv
    want = brute(sets, gp)
    np.testing.assert_array_equal(
        k6_model(sw, gidbits, gp, seg=0, chunk=512, kb=64, blocks=blocks),
        want)
    np.testing.assert_array_equal(
        k6_model(sw, gidbits, gp, GT, seg=0, chunk=256, kb=32,
                 blocks=blocks), want[:GT, GT:])


def brute_kept_runs(sets, gp, split=None):
    """Runs (keys) that can add to a 128 x 128 output tile, summed over the
    tiles: a genome of the key in the tile's row range and one in its
    column range, or two in range on a diagonal tile of full mode."""
    holders = {}
    for gid, keys in enumerate(sets):
        for key in keys:
            holders.setdefault(key, []).append(gid)
    rows, c0 = (gp, 0) if split is None else (split, split)
    kept = 0
    for gids in holders.values():
        tiles = np.bincount(np.asarray(gids) // GT, minlength=gp // GT)
        for tr in range(rows // GT):
            for tc in range(c0 // GT, gp // GT):
                if split is None and tr > tc:
                    continue
                if split is None and tr == tc:
                    kept += tiles[tr] >= 2
                else:
                    kept += tiles[tr] > 0 and tiles[tc] > 0
    return int(kept)


@pytest.mark.parametrize("seed,g,key_bits,gidbits,universe,per,every,gp",
                         K6_CASES)
def test_k6_kept_runs_count(seed, g, key_bits, gidbits, universe, per, every,
                            gp):
    """chip_smoke.py's count of the runs K6 keeps (which K6's own counter,
    gram_kept_runs, is held to on the card) equals a brute-force count
    from the genomes' key sets, in full mode and split mode."""
    from chip_smoke import k6_kept_runs
    rng = np.random.default_rng(seed)
    sw, sets = packed_stream(rng, g, key_bits, gidbits, universe=universe,
                             per=per, every=every)
    t = i32(sw)
    assert k6_kept_runs(t, gidbits, gp) == brute_kept_runs(sets, gp)
    if gp > GT:
        assert k6_kept_runs(t, gidbits, gp, GT) == brute_kept_runs(
            sets, gp, GT)


# --- K3 ---------------------------------------------------------------------

def k3_model(planes, tile, per_round=1024):
    """K3's decomposition (csrc/compact.cu) over (kw, G, n) uint32: tile
    counts, each row's exclusive offsets scanned `per_round` tiles at a
    time, the ranked scatter of each tile, the sentinels past the row's
    total.  Every output slot must be written once."""
    kw, g, n = planes.shape
    poison = np.uint32(0x5A5A5A5A)
    out = np.full(planes.shape, poison, np.uint32)
    valid = (planes != SENT).any(0)
    tiles = -(-n // tile)
    counts = np.array([[valid[r, t * tile:(t + 1) * tile].sum()
                        for t in range(tiles)] for r in range(g)])
    for r in range(g):
        offsets, base = np.zeros(tiles, np.int64), 0
        for q0 in range(0, tiles, per_round):
            c = counts[r, q0:q0 + per_round]
            offsets[q0:q0 + per_round] = base + np.cumsum(c) - c
            base += int(c.sum())
        total = base
        for t in range(tiles):
            t0, t1 = t * tile, min(n, (t + 1) * tile)
            slots = np.flatnonzero(valid[r, t0:t1])
            dst = offsets[t] + np.arange(slots.size)
            assert (out[:, r, dst] == poison).all()
            out[:, r, dst] = planes[:, r, t0 + slots]
            tail = np.arange(max(total, t0), t1)
            assert (out[:, r, tail] == poison).all()
            out[:, r, tail] = SENT
    assert not (out == poison).any()
    return out


def holed(rng, kw, g, n, frac):
    """(kw, g, n) keys with a `frac` share of all-ones holes; row 0 all
    valid, the last row all holes when g > 2."""
    x = rng.integers(0, 2 ** 32, (kw, g, n), dtype=np.uint64).astype(
        np.uint32)
    hole = rng.random((g, n)) < frac
    hole[0] = False
    if g > 2:
        hole[-1] = True
    x[:, hole] = SENT
    x[kw - 1, 1 % g, ::7] = SENT      # one word all-ones (valid if kw > 1)
    return x


@pytest.mark.parametrize("kw,g,n,tile,per_round", [
    (1, 1, 1, 8, 4),
    (2, 3, 1000, 64, 4),             # n not a multiple of the tile
    (3, 1, 4099, 256, 1024),
    (4, 4, 333, 32, 2),
])
def test_k3_model_matches_plain(kw, g, n, tile, per_round):
    rng = np.random.default_rng(n + kw)
    x = holed(rng, kw, g, n, 0.4)
    want = compact.compact_global_plain(i32(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(k3_model(x, tile, per_round), want)


@pytest.mark.parametrize("kw", [1, 4])
def test_k3_model_matches_jax(kw):
    """3 rows of 4,096 slots against the Pallas kernel in interpret mode:
    at the kernel's 2,048-slot tiles and at 768-slot tiles, which leave a
    partial last tile."""
    rng = np.random.default_rng(17 + kw)
    g, n = 3, 4096
    x = holed(rng, kw, g, n, 0.3)
    want = jax_compact_global([jnp.asarray(w) for w in x], interpret=True)
    for got in (k3_model(x, 2048), k3_model(x, 768, 2)):
        for q in range(kw):
            np.testing.assert_array_equal(got[q], np.asarray(want[q]))


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_k3_model_offsets_over_many_rounds(frac):
    """Rows of 1,500 tiles of 4 slots, their offsets scanned in rounds of
    1,024 tiles as the offset kernel does (a round carries its sum into
    the next): all-valid, half-holed and all-sentinel rows."""
    rng = np.random.default_rng(int(frac * 10))
    x = rng.integers(0, 2 ** 32, (2, 2, 6000), dtype=np.uint64).astype(
        np.uint32)
    x[:, rng.random((2, 6000)) < frac] = SENT
    want = compact.compact_global_plain(i32(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(k3_model(x, 4), want)
