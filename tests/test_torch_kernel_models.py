"""Models of the decompositions of K1, K7 and K11 (the sliding extracts)
and K4 (the register tile sort), held on the CPU to the port's plain
versions.

The CUDA kernels cannot run here, so each test re-traces one kernel's
decomposition in numpy, as csrc/extract.cu and csrc/sort.cu compute it:

* K1, K7 and K11: the FracMinHash filter's remainder as a multiply-high
  by the reciprocal that ops/cuda/extract.fmh_divisor computes, a shift,
  a multiply and a subtract; a thread's 32 (K11: 8) windows, its two
  strands built once and slid one code a window (the forward strand from
  a stream of the codes at t + w, the complement's source from the codes
  at t + 64); K7's one upper-bound search of the run starts a thread and
  its walk forward; K1's and K11's run-id plane staged a warp at a time
  in a shared-memory slab (its banks, and the values it returns); each
  128-window row's four kept masks scanned into slots, the kept keys
  rebuilt into them, the sentinel fill and the row count; K11's keys
  staged a warp at a time and written with the lanes on consecutive
  windows, its keep bytes from the lanes' kept masks.
* K4: the tile by kw, each thread's E keys sorted by an unrolled bitonic
  network, the block's merge-path levels (each thread's diagonal found by
  a binary search, then E outputs merged in turn), and K5's levels above
  the tile.
* K8 and K9 on the same machinery, 8 keys a thread: K8's tiles whose
  levels stop at the run and whose store mirrors odd runs, and K5's levels
  above 4,096 whose last staged store writes odd runs reversed; K9's tiles
  that move their valid keys to the front and sort only the power of two
  that holds them, by levels that keep only a pair's first cut outputs,
  packed (a thread past them skips), each tile's first cut entries written
  packed, the tile's pieces merged to its cut, then a row's cuts.

The models live here, not in the package: they are what the kernels
compute, written once more.  Every value is an integer, so every
comparison is exact (tolerance 0).
"""
from bisect import bisect_right

import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu_torch.ops import u64ops
from spaced_kmer_sketching_tpu_torch.ops.cuda import extract, sort
from spaced_kmer_sketching_tpu_torch.ops.extract import extract_windows
from spaced_kmer_sketching_tpu_torch.utils import boosthash
from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

U64 = np.uint64
M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
SENT = 0xFFFFFFFF
C = 32                 # K1 and K7: windows a thread
EMIT_C = 8             # K11: windows a thread
ROW_THREADS = 4        # K1 and K7: threads a 128-window row
FAR = 1 << 30


def u(x: int) -> np.uint64:
    return np.uint64(x)


# --- K7 (a): the filter's remainder without division -------------------------

def mulhi64(a: int, h: np.ndarray) -> np.ndarray:
    """The high 64 bits of a * h, on 32-bit limbs (what __umul64hi gives)."""
    a_lo, a_hi = u(a & M32), u(a >> 32)
    h_lo, h_hi = h & u(M32), h >> u(32)
    ll, lh, hl, hh = h_lo * a_lo, h_lo * a_hi, h_hi * a_lo, h_hi * a_hi
    mid = (ll >> u(32)) + (lh & u(M32)) + (hl & u(M32))
    return hh + (lh >> u(32)) + (hl >> u(32)) + (mid >> u(32))


def model_mod(h: np.ndarray, scale: int) -> np.ndarray:
    """h % scale as fmh_keep computes it (uint64 arithmetic wraps)."""
    magic, l = extract.fmh_divisor(scale)
    t = mulhi64(magic, h)
    q = (t + ((h - t) >> u(min(l, 1)))) >> u(max(l - 1, 0))
    with np.errstate(over="ignore"):
        return h - q * u(scale)


SCALES = [1, 2, 3, 7, 200, 1000, 2 ** 16 + 1, 2 ** 31 - 1, 2 ** 30, 4096,
          2 ** 31 - 2, 641]


@pytest.mark.parametrize("scale", SCALES)
def test_remainder_model_matches_modulo(scale):
    rng = np.random.default_rng(scale)
    edges = [0, 1, 2, 3, M64, M64 - 1, 1 << 63, (1 << 63) - 1, (1 << 63) + 1,
             1 << 32, (1 << 32) - 1, (1 << 32) + 1, M64 // scale * scale]
    multiples = [k * scale for k in (1, 2, 3, 1 << 20, M64 // scale,
                                     int(rng.integers(1, 1 << 62)) * 5
                                     % (M64 // scale) + 1)]
    near = [m + dx for m in multiples + edges for dx in (-1, 0, 1)
            if 0 <= m + dx <= M64]
    h = np.concatenate([np.array(near, dtype=U64),
                        rng.integers(0, M64, 4000, dtype=U64, endpoint=True)])
    np.testing.assert_array_equal(model_mod(h, scale), h % u(scale))


def test_remainder_model_at_random_scales():
    rng = np.random.default_rng(7)
    h = rng.integers(0, M64, 2000, dtype=U64, endpoint=True)
    for scale in rng.integers(1, 2 ** 31, 40):
        np.testing.assert_array_equal(model_mod(h, int(scale)),
                                      h % u(int(scale)))


def test_fmh_divisor_rejects_out_of_range_scales():
    for bad in (0, -1, 2 ** 31):
        with pytest.raises(ValueError):
            extract.fmh_divisor(bad)


@pytest.mark.parametrize("variant", ["modern", "legacy"])
def test_filter_model_matches_the_plain_keep(variant):
    """The keep decision of the shared filter helper (K1, K7 and K11) on
    random keys equals the plain version's u64ops.fmh_keep."""
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2 ** 32, (4, 5000), dtype=np.int64)
    lo = (w[0].astype(U64) | (w[1].astype(U64) << u(32)))
    hi = (w[2].astype(U64) | (w[3].astype(U64) << u(32)))
    salt = int(rng.integers(0, M64, dtype=U64, endpoint=True))
    hashed = boosthash.hash_bitset128(lo, hi, variant) ^ u(salt)
    for scale in (1, 2, 7, 200, 2 ** 31 - 1):
        got = model_mod(hashed, scale) == 0
        want = u64ops.fmh_keep(*torch.from_numpy(w), salt=salt, scale=scale,
                               variant=variant).numpy()
        np.testing.assert_array_equal(got, want)


# --- K7 (b): the strands, built once and slid --------------------------------

def rev2(x: np.ndarray) -> np.ndarray:
    """Reverse the 32 2-bit groups of x: __brevll, then swap bit pairs."""
    x = x.copy()
    for s, m in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                 (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                 (16, 0x0000FFFF0000FFFF)):
        x = ((x >> u(s)) & u(m)) | ((x & u(m)) << u(s))
    x = (x >> u(32)) | (x << u(32))
    m = u(0x5555555555555555)
    return ((x >> u(1)) & m) | ((x & m) << u(1))


def shl(x, s):
    """x << s for 0 <= s < 64, elementwise (s an array or an int)."""
    return x << np.asarray(s, dtype=U64)


def shr(x, s):
    return x >> np.asarray(s, dtype=U64)


class Words:
    """A genome's packed words, read as the kernel reads them (zero past
    the last word)."""

    def __init__(self, words: np.ndarray):
        self.p = words.size
        self.w = np.concatenate([words.astype(U64), np.zeros(16, U64)])

    def __call__(self, i):
        i = np.asarray(i, dtype=np.int64)
        return self.w[np.minimum(i, self.p)]


def strands_at(words: Words, t: np.ndarray, window: int):
    """strands_at: s from five words at t (funnel-shifted by 2 (t & 15)
    bits), f its nucleotide reverse shifted down by 128 - 2w."""
    a, o = t >> 4, (2 * (t & 15)).astype(U64)
    v = [words(a + i) for i in range(5)]
    w0, w1, w2 = v[0] | (v[1] << u(32)), v[2] | (v[3] << u(32)), v[4]
    on = o != 0
    inv = np.where(on, u(64) - o, u(0))
    s_lo = np.where(on, shr(w0, o) | shl(w1, inv), w0)
    s_hi = np.where(on, shr(w1, o) | shl(w2, inv), w1)
    f_lo, f_hi = rev2(s_hi), rev2(s_lo)
    s = 128 - 2 * window
    if s >= 64:
        f_lo, f_hi = shr(f_hi, s - 64), np.zeros_like(f_hi)
    elif s > 0:
        f_lo, f_hi = shr(f_lo, s) | shl(f_hi, 64 - s), shr(f_hi, s)
    return [f_lo, f_hi, s_lo, s_hi]


def slide(st, cf, cs):
    f_lo, f_hi, s_lo, s_hi = st
    return [(f_lo << u(2)) | cf, (f_hi << u(2)) | (f_lo >> u(62)),
            (s_lo >> u(2)) | (s_hi << u(62)), (s_hi >> u(2)) | (cs << u(62))]


def strand_key(st, mask_lo: int, mask_hi: int):
    f_lo, f_hi = st[0] & u(mask_lo), st[1] & u(mask_hi)
    rc_lo, rc_hi = ~st[2] & u(mask_lo), ~st[3] & u(mask_hi)
    fwd = (f_hi < rc_hi) | ((f_hi == rc_hi) & (f_lo < rc_lo))
    return np.where(fwd, f_lo, rc_lo), np.where(fwd, f_hi, rc_hi)


def codes_from(words: Words, pos: np.ndarray) -> np.ndarray:
    """The 32 codes from position pos as one 64-bit stream: pos's word and
    the two after it, funnel-shifted by 2 (pos & 15) bits (guarded at 0)."""
    b, o = pos >> 4, (2 * (pos & 15)).astype(U64)
    x = words(b) | (words(b + 1) << u(32))
    on = o != 0
    return np.where(on, shr(x, o) | shl(words(b + 2),
                                         np.where(on, u(64) - o, u(0))), x)


def thread_keys(words: Words, t0: np.ndarray, window: int, mask, c=C):
    """Each thread's c canonical keys (threads, c) as slide_windows
    computes them: strands at t0, then one slide a window, the codes
    taken from the two streams (t0 + 64 .., t0 + w ..)."""
    next_s = codes_from(words, t0 + 64)
    next_f = codes_from(words, t0 + window)
    st = strands_at(words, t0, window)
    lo = np.zeros((t0.size, c), U64)
    hi = np.zeros_like(lo)
    for i in range(c):
        lo[:, i], hi[:, i] = strand_key(st, mask.lo, mask.hi)
        st = slide(st, next_f & u(3), next_s & u(3))
        next_f, next_s = next_f >> u(2), next_s >> u(2)
    return lo, hi


def direct_keys(codes: np.ndarray, span: int, window: int, mask):
    """The plain version's direct key build (ops/extract.extract_windows)
    at windows 0 .. span - 1, codes past the array as 0."""
    c = np.zeros(span + window - 1, np.int64)
    c[:min(codes.size, c.size)] = codes[:c.size]
    rid = np.zeros_like(c)
    canon, _ = extract_windows(torch.from_numpy(c), torch.from_numpy(rid),
                               window, mask.words_u32)
    w = [x.numpy().astype(U64) for x in canon]
    return w[0] | (w[1] << u(32)), w[2] | (w[3] << u(32))


WINDOWS = [(1, 1), (2, 2), (15, 9), (16, 16), (17, 12), (31, 20), (32, 32),
           (33, 25), (63, 40), (64, 64), (64, 30)]


@pytest.mark.parametrize("window,k", WINDOWS)
def test_sliding_strands_match_the_direct_build(window, k):
    """Every window of every thread (32 windows a thread, as K1 and K7
    take them, and 8, as K11 does), from the thread's first window slid
    one code at a time, and the rebuild of a kept key at any window, equal
    the direct key build; the last words run past the packed body."""
    rng = np.random.default_rng(window * 100 + k)
    n = 16 * 37 + 5                       # 38 words, the last one partial
    codes = rng.integers(0, 4, n).astype(np.uint8)
    packed = extract.pack2bit(codes, -(-n // 16)).astype(U64)
    words = Words(packed)
    for seed, c in ((0, C), (1, C), (0, EMIT_C)):
        mask = spaced_seed_mask(window, k, seed)
        t0 = np.arange(0, 16 * packed.size, c, dtype=np.int64)
        lo, hi = thread_keys(words, t0, window, mask, c)
        want_lo, want_hi = direct_keys(codes, t0.size * c, window, mask)
        np.testing.assert_array_equal(lo.reshape(-1), want_lo)
        np.testing.assert_array_equal(hi.reshape(-1), want_hi)
        t = np.arange(t0.size * c, dtype=np.int64)
        r_lo, r_hi = strand_key(strands_at(words, t, window), mask.lo,
                                mask.hi)
        np.testing.assert_array_equal(r_lo, want_lo)
        np.testing.assert_array_equal(r_hi, want_hi)


# --- K7 (c): one run search a thread, then a walk ----------------------------

def thread_valid(bounds, rid0: int, vlen: int, n: int, t0: int,
                 window: int) -> int:
    """slide_windows' validity: the kept-mask bits of windows t0 ..
    t0 + 31 that may be kept."""
    room = min(vlen, n) - (window - 1) - t0
    if room <= 0:
        return 0
    iend = min(room, C)
    k = len(bounds)
    cnt = bisect_right(bounds, t0)

    def rel_of(c):
        return min(bounds[c] - t0, FAR) if c < k else FAR
    rel, ok, bits = rel_of(cnt), rid0 + cnt >= 0, 0
    for i in range(C):
        if rel <= i:
            while True:
                cnt += 1
                rel = rel_of(cnt)
                if rel > i:
                    break
            ok = rid0 + cnt >= 0
        if i < iend and ok and rel >= i + window:
            bits |= 1 << i
    return bits


def plane_valid(bounds, rid0, vlen, n, windows, window) -> np.ndarray:
    """Per-window validity from the plain version's run-id plane
    (run_ids_from_bounds over n positions, -1 past them)."""
    b = torch.tensor([bounds], dtype=torch.int32).reshape(1, -1)
    rid = extract.run_ids_from_bounds(b, torch.tensor([rid0], dtype=torch.int32),
                                      torch.tensor([vlen], dtype=torch.int32),
                                      n)[0].numpy().astype(np.int64)
    full = np.full(windows + window - 1, -1, np.int64)
    full[:min(n, full.size)] = rid[:full.size]
    a, z = full[:windows], full[window - 1:window - 1 + windows]
    return (a == z) & (a >= 0)


def walk_cases():
    n = 16 * 40
    edge = [0, 31, 32, 33, 63, 64, 95, 96, 127, 128, 160, 191, 192, 31 * 7,
            32 * 9 - 1]
    yield "edges", sorted(edge), 0, n - 50, n
    yield "no bounds", [], 0, n, n
    yield "no bounds, rid0 -1", [], -1, n, n
    yield "rid0 -1", [64, 200, 201], -1, n - 3, n
    yield "rid0 -3", [5, 40, 41, 300], -3, n, n
    yield "duplicates", [32, 32, 33, 96, 96, 96, 400], 0, n, n
    yield "vlen past the body", [100, 329], 2, n + 3000, n
    yield "padding at vlen", [50, 500, 500, 500], 0, 500, n
    yield "bounds past n", [n + 5, n + 9], 0, n + 20, n
    yield "every position", list(range(0, 80)), 0, n, n


@pytest.mark.parametrize("window", [1, 2, 16, 17, 31, 32, 33, 64])
def test_run_walk_matches_the_run_id_plane(window):
    """Bounds on a thread's first and last window, K = 0, rid0 = -1 and
    below, duplicate bounds, vlen past the body: one search a thread and
    the walk give the run-id plane's validity at every window."""
    rng = np.random.default_rng(window)
    cases = list(walk_cases())
    n = 16 * 40
    for _ in range(6):
        real = sorted(int(x) for x in rng.choice(n, int(rng.integers(1, 40)),
                                                 replace=False))
        cases.append(("random", real, int(rng.integers(-2, 3)),
                      int(rng.integers(n - 100, n + 100)), n))
    for what, bounds, rid0, vlen, n in cases:
        threads = -(-n // C)
        got = np.array([(thread_valid(bounds, rid0, vlen, n, t0 * C, window)
                         >> i) & 1 for t0 in range(threads) for i in range(C)],
                       dtype=bool)
        want = plane_valid(bounds, rid0, vlen, n, threads * C, window)
        np.testing.assert_array_equal(got, want, err_msg=what)


# --- K7 whole: rows ranked by a scan over four threads -----------------------

def compact_rows_model(words: Words, valid: np.ndarray, mask, salt, *,
                       window, scale, variant, k_slots, out_words):
    """One grid row of K1 or K7 (CompactRows) from each thread's validity
    (threads, 32) bool: the thread's keys slid from t0 (a thread whose
    word is 0 computes none), the valid ones hashed and filtered, the
    row's four kept counts scanned, the kept keys below k_slots rebuilt
    into their slots, the sentinel fill and the true row counts."""
    threads = valid.shape[0]
    rows = threads // ROW_THREADS
    t0 = np.arange(threads, dtype=np.int64) * C
    live = valid.any(1)
    lo = np.zeros((threads, C), U64)
    hi = np.zeros_like(lo)
    lo[live], hi[live] = thread_keys(words, t0[live], window, mask)
    hashed = boosthash.hash_bitset128(lo[valid], hi[valid],
                                      variant) ^ u(salt)
    kept = np.zeros_like(valid)
    kept[valid] = model_mod(hashed, scale) == 0
    # the row's four counts scanned; each thread's keys in order
    counts = kept.sum(1).reshape(rows, ROW_THREADS)
    first = (np.cumsum(counts, 1) - counts).reshape(-1)
    slot = first[:, None] + np.cumsum(kept, 1) - 1
    out = np.full((out_words, rows * k_slots), SENT, np.uint32)
    th, i = np.nonzero(kept & (slot < k_slots))
    r_lo, r_hi = strand_key(strands_at(words, t0[th] + i, window), mask.lo,
                            mask.hi)
    dst = th // ROW_THREADS * k_slots + slot[th, i]
    key = [r_lo & u(M32), r_lo >> u(32), r_hi & u(M32), r_hi >> u(32)]
    for q in range(out_words):
        out[q, dst] = key[q].astype(np.uint32)
    return out, counts.sum(1).astype(np.int32)


def k7_model(packed, bounds, rid0, vlen, mask, salt, *, window, nw, scale,
             variant, k_slots, out_words):
    """K7 (one seed per genome row) as its kernel computes it."""
    g, p = packed.shape
    n = 16 * p
    threads = extract.out_rows(nw) * ROW_THREADS
    outs, counts = [], []
    for gi in range(g):
        brow = [int(x) for x in bounds[gi]]
        bits = np.array([thread_valid(brow, int(rid0[gi]), int(vlen[gi]), n,
                                      t * C, window)
                         for t in range(threads)], np.int64)
        valid = (bits[:, None] >> np.arange(C)) & 1 == 1
        out, rowcnt = compact_rows_model(
            Words(packed[gi].astype(np.uint32)), valid, mask, salt,
            window=window, scale=scale, variant=variant, k_slots=k_slots,
            out_words=out_words)
        outs.append(out)
        counts.append(rowcnt)
    return np.stack(outs, 1), np.stack(counts)


def raw_inputs(rng, g, n, k, real, rid0, short):
    body = extract.packed_body(n)
    packed = rng.integers(0, 2 ** 32, (g, body // 16), dtype=np.uint64)
    bounds = np.full((g, k), body, np.int32)
    for i in range(g):
        if real:
            bounds[i, :real] = np.sort(rng.choice(n - max(short, 0), real,
                                                  replace=False))
    return (packed.astype(np.uint32), bounds, np.asarray(rid0, np.int32),
            np.full(g, n - short, np.int32))


@pytest.mark.parametrize("n,k,real,rid0,short,window,kk,scale,variant,slots", [
    (20000, 8, 5, [0, 7], 1000, 20, 16, 200, "modern", 0),
    (3000, 0, 0, [0, -1], 100, 64, 40, 50, "legacy", 0),
    (5000, 16, 16, [-1, 1], 0, 1, 1, 1, "modern", 8),      # every window kept
    (4000, 4, 3, [2, 0], -3000, 17, 12, 7, "modern", 0),   # vlen past the body
    (4000, 64, 64, [0, 0], 10, 33, 25, 641, "legacy", 0)])
def test_k7_model_matches_plain(n, k, real, rid0, short, window, kk, scale,
                                variant, slots):
    rng = np.random.default_rng(n + k + window)
    packed, bounds, r0, vlen = raw_inputs(rng, 2, n, k, real, rid0, short)
    mask = spaced_seed_mask(window, kk, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    nw = n - window + 1
    args = dict(window=window, nw=nw, scale=scale, variant=variant,
                k_slots=slots or min(128, max(4, 4 * 128 // scale)),
                out_words=min(4, -(-2 * window // 32)))
    got = k7_model(packed, bounds, r0, vlen, mask, salt, **args)
    want = extract.extract_compact_raw_plain(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(bounds),
        torch.from_numpy(r0), torch.from_numpy(vlen), mask.words_u32, salt,
        **args)
    np.testing.assert_array_equal(got[0], want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert int(got[1].sum()) > 0


# --- K1 and K11: the run-id plane through a warp's slab ----------------------

def slab_index(e, c=C):
    """RunPlane's slab index of element e for threads of c windows."""
    return e + e // c


def slab_ints(c=C):
    return slab_index(32 * c + 63 - 1, c) + 1


def plane_valid_words(rid_row: np.ndarray, threads: int, window: int,
                      c=C) -> np.ndarray:
    """RunPlane.valid_word of `threads` threads (a multiple of 32) of c
    windows over one genome's plane: each warp stages rid[w0 .. w0 + 32 c
    - 1 + w - 1] (-1 at or past n) into its slab at slab_index(e), then
    lane L reads rid[t] and rid[t + w - 1] of its windows t = w0 + c L + i
    from the slab.  Returns (threads, c) bool; asserts every read was
    staged and that the slab returns the plane's values."""
    n = rid_row.size
    warps, ww = threads // 32, 32 * c
    span = ww + window - 1
    e = np.arange(span)
    t = np.arange(warps)[:, None] * ww + e                    # (warps, span)
    full = np.full(warps * ww + 64, -1, np.int64)
    full[:n] = rid_row
    slab = np.full((warps, slab_ints(c)), 1 << 40, np.int64)  # unstaged
    slab[:, slab_index(e, c)] = full[t]
    a = np.arange(32)[:, None] * c + np.arange(c)             # (lane, i)
    ra = slab[:, slab_index(a, c)]
    rb = slab[:, slab_index(a + window - 1, c)]
    assert (ra < 1 << 40).all() and (rb < 1 << 40).all()
    tw = np.arange(warps)[:, None, None] * ww + a
    np.testing.assert_array_equal(ra, full[tw])
    np.testing.assert_array_equal(rb, full[tw + window - 1])
    return ((ra >= 0) & (ra == rb)).reshape(threads, c)


def worst_bank_conflict(indices: np.ndarray) -> int:
    """The most lanes of one step that share a bank (1: none share)."""
    return int(np.bincount(np.asarray(indices) % 32).max())


@pytest.mark.parametrize("c", [C, EMIT_C])
@pytest.mark.parametrize("window", [1, 20, 33, 64])
def test_slab_banks_are_distinct_and_the_slab_returns_the_plane(window, c):
    """At every step of the reads the 32 lanes touch 32 distinct banks
    (the staging stores too at 32 windows a thread; at most two lanes a
    bank at 8); the slab holds every index a read needs; and the validity
    it gives is rid[t] == rid[t + w - 1] >= 0 on the plane."""
    lanes = np.arange(32)
    span = 32 * c + window - 1
    for k in range(-(-span // 32)):
        e = 32 * k + lanes
        assert worst_bank_conflict(slab_index(e[e < span], c)) <= (
            1 if c == C else 2)
    for i in range(c):
        for off in (0, window - 1):
            assert worst_bank_conflict(slab_index(c * lanes + i + off,
                                                  c)) == 1, (i, off)
    assert slab_index(span - 1, c) < slab_ints(c)
    assert slab_ints(C) == 1120 and slab_ints(EMIT_C) == 358
    rng = np.random.default_rng(window)
    n = 3 * 32 * c + 77
    rid = rng.integers(-1, 3, n)
    rid[rng.random(n) < 0.5] = 1                 # some long runs
    got = plane_valid_words(rid, 4 * 32, window, c)
    full = np.full(4 * 32 * c + window, -1, np.int64)
    full[:n] = rid
    t = np.arange(4 * 32 * c)
    want = (full[t] >= 0) & (full[t] == full[t + window - 1])
    np.testing.assert_array_equal(got.reshape(-1), want)


def hard_plane(rng, g: int, n: int) -> np.ndarray:
    """(G, n) int32 run ids that no sorted-bounds form can give: runs of
    1-300 positions whose ids repeat out of order, -1 holes inside the
    genome, single-position runs, and a tail of -1 past a random end."""
    rid = np.empty((g, n), np.int32)
    for gi in range(g):
        pos = 0
        while pos < n:
            ln = int(rng.integers(1, 300)) if rng.random() > 0.1 else 1
            rid[gi, pos:pos + ln] = int(rng.integers(-1, 6))
            pos += ln
        rid[gi, n - int(rng.integers(0, 200)):] = -1
    return rid


def k1_model(packed, rid, mask_words, salt, *, window, nw, scale, variant,
             k_slots, out_words):
    """K1 as its kernel computes it: each genome row (or, in seed-batch
    mode, each seed over genome row 0) with the run-id plane's validity
    through the warp slab, then K7's rows."""
    g = packed.shape[0]
    threads = extract.out_rows(nw) * ROW_THREADS
    seeds = np.asarray(mask_words, dtype=np.uint64)
    if seeds.ndim == 1:
        jobs = [(gi, seeds, salt) for gi in range(g)]
    else:
        jobs = [(0, m, sv) for m, sv in zip(seeds, salt)]
    outs, counts = [], []
    for gi, mw, sv in jobs:
        mask = Mask(mw)
        valid = plane_valid_words(rid[gi].astype(np.int64), threads, window)
        out, rowcnt = compact_rows_model(
            Words(packed[gi].astype(np.uint32)), valid, mask, int(sv),
            window=window, scale=scale, variant=variant, k_slots=k_slots,
            out_words=out_words)
        outs.append(out)
        counts.append(rowcnt)
    return np.stack(outs, 1), np.stack(counts)


class Mask:
    """A mask's (lo, hi) 64-bit halves from its four u32 words."""

    def __init__(self, words):
        w = [int(x) for x in words]
        self.lo, self.hi = w[0] | w[1] << 32, w[2] | w[3] << 32
        self.words_u32 = words


@pytest.mark.parametrize("what,n,window,k,scale,variant,slots,seeds", [
    ("non-monotone, holes", 5000, 20, 16, 7, "modern", 0, 0),
    ("nw odd, legacy", 4999, 33, 25, 3, "legacy", 0, 0),
    ("ends mid-row, w 1", 128 * 30 + 37, 1, 1, 2, "modern", 0, 0),
    ("w 64", 3001, 64, 40, 5, "modern", 0, 0),
    ("rows overflow", 4000, 17, 12, 1, "modern", 8, 0),
    ("seed-batch mode", 4500, 20, 16, 5, "modern", 0, 3)])
def test_k1_model_matches_plain(what, n, window, k, scale, variant, slots,
                                seeds):
    """K1's plane validity from the warp slab, K7's slide and rows, held
    to extract_compact_plain on planes that are not ascending runs, with
    -1 holes inside a genome, a plane that ends mid-row, nw not a
    multiple of 32 or 128, rows past k_slots and seed-batch mode."""
    rng = np.random.default_rng(n + window)
    g = 1 if seeds else 2
    words = -(-n // 16) + 2
    packed = rng.integers(0, 2 ** 32, (g, words), dtype=np.uint64
                          ).astype(np.uint32)
    rid = hard_plane(rng, g, n)
    if seeds:
        masks = [spaced_seed_mask(window, k, s) for s in range(seeds)]
        mw = np.stack([m.words_u32 for m in masks])
        salt = [boosthash.fmh_salt(m.lo, m.hi, window, 1, variant)
                for m in masks]
    else:
        m = spaced_seed_mask(window, k, 1)
        mw, salt = m.words_u32, boosthash.fmh_salt(m.lo, m.hi, window, 1,
                                                   variant)
    nw = n - window + 1
    assert nw % 32
    args = dict(window=window, nw=nw, scale=scale, variant=variant,
                k_slots=slots or min(128, max(4, 4 * 128 // scale)),
                out_words=min(4, -(-2 * window // 32)))
    got = k1_model(packed, rid, mw, salt, **args)
    want = extract.extract_compact_plain(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(rid), mw,
        salt, **args)
    np.testing.assert_array_equal(got[0], want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert int(got[1].sum()) > 0
    if slots:
        assert int(got[1].max()) > slots


STAGE_PLANE = slab_index(32 * EMIT_C - 1) + 1       # K11's staging


def test_k11_staging_banks_are_distinct():
    """K11's staging: a lane's windows e = 8 L + i written at step i, and
    the write-out's words e = L + 32 r read at step r, each fall in 32
    distinct banks; the plane stride leaves room for every window."""
    lanes = np.arange(32)
    for i in range(EMIT_C):
        assert worst_bank_conflict(slab_index(EMIT_C * lanes + i)) == 1
    for r in range(EMIT_C):
        assert worst_bank_conflict(slab_index(lanes + 32 * r)) == 1
    assert slab_index(32 * EMIT_C - 1) < STAGE_PLANE == 263


class Memory:
    """A flat output buffer that counts the writes of each element."""

    def __init__(self, size: int):
        self.v = np.zeros(size, np.int64)
        self.writes = np.zeros(size, np.int64)

    def store(self, at, values):
        self.v[at] = values
        np.add.at(self.writes, at, 1)


def k11_model(codes, rid, mask, salt, *, window, scale, variant):
    """K11 as its kernel computes it: threads of 8 windows, every window's
    key slid from t0, the plane's validity through the warp slab, the
    valid windows hashed and filtered; each warp stages its keys at
    slab_index(e) and writes them out with lane L on windows w0 + L + 32 r
    (r < 8), the keep bytes from the kept masks of lanes e // 8 (a
    shuffle).  Returns (canon (4, G, nw) uint32, keep (G, nw) bool);
    asserts every output element was written once."""
    g, n = codes.shape
    nw = n - window + 1
    c = EMIT_C
    threads = -(-(-(-nw // c)) // 256) * 256    # ceil(nw / 8) in 256-blocks
    canon = Memory(4 * g * nw)
    keep = Memory(g * nw)
    lanes = np.arange(32)
    for y in range(g):
        packed = extract.pack2bit(codes[y].astype(np.uint8), -(-n // 16))
        words = Words(packed.astype(np.uint32))
        t0 = np.arange(threads, dtype=np.int64) * c
        lo, hi = thread_keys(words, t0, window, mask, c)
        valid = plane_valid_words(rid[y].astype(np.int64), threads, window, c)
        hashed = boosthash.hash_bitset128(lo[valid], hi[valid],
                                          variant) ^ u(salt)
        kept = np.zeros_like(valid)
        kept[valid] = model_mod(hashed, scale) == 0
        kept[t0 >= nw] = False                # threads past nw slide nothing
        key = [lo & u(M32), lo >> u(32), hi & u(M32), hi >> u(32)]
        masks = (kept.astype(np.int64) << np.arange(c)).sum(1)
        for w in range(threads // 32):
            w0 = w * 32 * c
            stage = np.full((4, STAGE_PLANE), -1, np.int64)
            e = (lanes[:, None] * c + np.arange(c)).reshape(-1)
            for q in range(4):
                stage[q, slab_index(e)] = key[q][32 * w:32 * (w + 1)].reshape(
                    -1)
            for r in range(c):
                e = lanes + 32 * r
                t = w0 + e
                inr = t < nw
                for q in range(4):
                    canon.store((q * g + y) * nw + t[inr],
                                stage[q, slab_index(e[inr])])
                bits = masks[32 * w + e // c]            # __shfl_sync
                keep.store(y * nw + t[inr], (bits[inr] >> (e[inr] % c)) & 1)
    assert (canon.writes == 1).all() and (keep.writes == 1).all()
    return (canon.v.astype(np.uint32).reshape(4, g, nw),
            keep.v.reshape(g, nw) == 1)


@pytest.mark.parametrize("n,window,k,scale,variant", [
    (3000, 20, 16, 3, "modern"), (3001, 33, 25, 3, "legacy"),
    (3000, 64, 40, 3, "modern"), (1001, 1, 1, 1, "modern")])
def test_k11_model_matches_plain(n, window, k, scale, variant):
    """K11's every-window keys, slab validity, staged key write-out and
    keep bytes, held to extract_filter_plain at G = 5 with nw odd, so a
    row ends inside a warp's 256 windows and rows start at every offset
    from 16-byte alignment."""
    rng = np.random.default_rng(n * window)
    g = 5
    codes = rng.integers(0, 4, (g, n)).astype(np.uint8)
    rid = hard_plane(rng, g, n)
    nw = n - window + 1
    assert nw % 2 == 1
    mask = spaced_seed_mask(window, k, 2)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    got = k11_model(codes, rid, mask, salt, window=window, scale=scale,
                    variant=variant)
    want = extract.extract_filter_plain(
        torch.from_numpy(codes.astype(np.int64)), torch.from_numpy(rid),
        mask.words_u32, salt, window=window, scale=scale, variant=variant)
    np.testing.assert_array_equal(got[0], want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert got[1].any()


# --- K4: register tiles, the block's merge levels, K5's levels ---------------

def lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a < b over (kw, ...) uint32 planes, word kw-1 most significant."""
    lt = a[-1] < b[-1]
    eq = a[-1] == b[-1]
    for q in range(a.shape[0] - 2, -1, -1):
        lt |= eq & (a[q] < b[q])
        eq &= a[q] == b[q]
    return lt


def register_sort(x: np.ndarray, e: int) -> np.ndarray:
    """Every thread's e consecutive keys through the unrolled bitonic
    network of register_sort: (kw, total) -> the same, each run of e
    ascending."""
    kw = x.shape[0]
    r = x.reshape(kw, -1, e).copy()
    log_e = e.bit_length() - 1
    for s in range(1, log_e + 1):
        for d in range(s - 1, -1, -1):
            for i in range(e):
                l = i ^ (1 << d)
                if l <= i:
                    continue
                a, b = r[:, :, i].copy(), r[:, :, l].copy()
                up = (i & (1 << s)) == 0
                swap = lex_less(b, a) if up else lex_less(a, b)
                r[:, :, i] = np.where(swap, b, a)
                r[:, :, l] = np.where(swap, a, b)
    return r.reshape(kw, -1)


def merge_outputs(x: np.ndarray, pair: np.ndarray, run: int,
                  d0: np.ndarray, e: int) -> np.ndarray:
    """Outputs [d0, d0 + e) of the merge of A = x[pair, pair + run) and
    B = x[pair + run, pair + 2 run), one thread per entry of pair and d0:
    the diagonal found by the binary search of smem_split (ties to A),
    then e outputs merged in turn, as merge_thread does.  (kw, threads,
    e)."""
    lo, hi = np.maximum(d0 - run, 0), np.minimum(d0, run)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        xa = x[:, pair + np.minimum(mid, run - 1)]
        yb = x[:, pair + run + np.clip(d0 - 1 - mid, 0, run - 1)]
        below = lex_less(yb, xa)
        hi = np.where(act & below, mid, hi)
        lo = np.where(act & ~below, mid + 1, lo)
    i, j = lo, d0 - lo
    out = np.empty((x.shape[0], pair.size, e), dtype=x.dtype)
    for k in range(e):
        xa = x[:, pair + np.minimum(i, run - 1)]
        yb = x[:, pair + run + np.minimum(j, run - 1)]
        take_a = (j >= run) | ((i < run) & ~lex_less(yb, xa))
        out[:, :, k] = np.where(take_a, xa, yb)
        i, j = i + take_a, j + ~take_a
    return out


def merge_level(x: np.ndarray, run: int, e: int) -> np.ndarray:
    """One merge level: every pair of ascending runs of `run` keys merged,
    each thread writing e outputs in place."""
    e0 = np.arange(0, x.shape[1], e, dtype=np.int64)
    pair = e0 & ~(2 * run - 1)
    return merge_outputs(x, pair, run, e0 - pair, e).reshape(x.shape)


def k4_model(planes: np.ndarray, sms: int = 132):
    """(kw, G, N) uint32 -> (sorted planes, launches) as K4 sorts them on a
    card of `sms` SMs (sort_tile: a quarter tile when full tiles would
    leave more than half the SMs idle)."""
    kw, g, n = planes.shape
    e = 16 if kw <= 2 else 8
    tile = min(n, 1024 * e)
    if 2 * (g * n // tile) < sms:
        tile = min(n, 256 * e)
    x = register_sort(planes.reshape(kw, g * n), e)
    run = e
    while run < tile:                     # the block's levels, in one launch
        x = merge_level(x, run, e)
        run *= 2
    launches = 1
    while run < n:                        # K5's levels, one launch each
        x = merge_level(x, run, 8)
        run *= 2
        launches += 1
    return x.reshape(kw, g, n), launches


def lexsorted(planes: np.ndarray) -> np.ndarray:
    kw, g, _ = planes.shape
    out = np.empty_like(planes)
    for r in range(g):
        order = np.lexsort(tuple(planes[q, r] for q in range(kw)))
        out[:, r] = planes[:, r, order]
    return out


def sort_input(rng, kw, g, n):
    x = rng.integers(0, 2 ** 32, (kw, g, n), dtype=np.uint64).astype(np.uint32)
    x[:, 0, ::3] = x[:, 0, 1:2]                   # duplicates
    x[:, 0, -(n // 7):] = SENT                    # a sentinel tail
    x[:, 0, rng.random(n) < 0.05] = 0             # the all-zero key
    if g > 1:
        x[:, 1] = SENT                            # all sentinels
    if g > 2:
        x[:, 2] = x[:, 2, :1]                     # all equal
    if g > 3:
        x[1:, 3] = 7                              # ties on the top words
    return x


@pytest.mark.parametrize("kw,g,n,sms,launches", [
    (1, 4, 1024, 132, 1), (2, 4, 1024, 132, 1), (3, 3, 1024, 132, 1),
    (4, 4, 1024, 132, 1), (2, 2, 16384, 132, 3), (3, 2, 8192, 132, 3),
    (4, 4, 16384, 132, 4), (1, 4, 65536, 132, 5), (2, 4, 65536, 132, 5),
    (3, 3, 65536, 132, 6), (4, 2, 65536, 132, 6), (2, 2, 16384, 4, 1),
    (2, 4, 65536, 8, 3), (4, 2, 65536, 8, 4), (2, 1, 1 << 20, 132, 9),
    (4, 1, 1 << 20, 132, 8)])
def test_k4_model_matches_lexsort(kw, g, n, sms, launches):
    """The tile by kw (16,384 keys at kw <= 2, 8,192 at kw 3-4, a quarter
    of that when full tiles would leave more than half the SMs idle), the
    register runs, the block's merge levels and K5's levels above the tile
    give np.lexsort's order, with duplicate, all-sentinel and all-equal
    rows; one launch for N <= tile, 1 + log2(N / tile) above."""
    rng = np.random.default_rng(kw * n + g)
    planes = sort_input(rng, kw, g, n)
    got, count = k4_model(planes, sms)
    np.testing.assert_array_equal(got, lexsorted(planes))
    assert count == launches


def test_k4_model_matches_plain():
    rng = np.random.default_rng(11)
    planes = sort_input(rng, 2, 4, 32768)
    got, _ = k4_model(planes)
    want = sort.sort_rows_plain(torch.from_numpy(planes.view(np.int32)))
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))


# --- K8 and K9: runs stored reversed, levels cut to the share ---------------

RUN_E = 8                 # K8's and K9's keys a thread
RUN_TILE = 4096           # their tile (K8: 2,048 up to runs of 2,048)
CUT_KEYS = 8192           # cut_merge_kernel's segment
TILE = sort.TILE


def cut_levels(x: np.ndarray, seg: int, length: int, pieces: int, cut: int,
               e: int, threads: int):
    """The block's levels with CUT on each segment of `seg` slots in
    shared memory (x (kw, nseg * seg)), holding `pieces` packed pieces of
    `length`: a level's pairs give min(cut, 2 length) outputs, stored
    packed at e0 = thread * e; a thread with e0 past the level's outputs
    skips it (its slots keep stale keys).  Returns x and the last piece's
    length."""
    kw, n = x.shape
    x = x.copy()
    base = np.arange(0, n, seg, dtype=np.int64)[:, None]
    e0 = np.arange(0, threads * e, e, dtype=np.int64)[None, :]
    while pieces > 1:
        outlen = min(cut, 2 * length)
        active = np.broadcast_to(e0 < pieces // 2 * outlen,
                                 (base.size, threads))
        d0 = e0 & (outlen - 1)
        pair = base + (e0 - d0) // outlen * 2 * length
        got = merge_outputs(x, pair[active], length,
                            np.broadcast_to(d0, active.shape)[active], e)
        dst = (base + e0)[active][:, None] + np.arange(e)
        x[:, dst] = got
        length, pieces = outlen, pieces // 2
    return x, length


def staged_level(x: np.ndarray, run: int, outlen: int, alt: int):
    """One of K5's levels through merge_pairs: pair p's first outlen
    outputs, 2,048 (or outlen) a CTA, stored packed at p outlen; with alt
    > 0 a pair odd within its row of alt pairs stored reversed by the
    staged write-out (out[o + outlen - 1 - d0 - e])."""
    kw, n = x.shape
    pairs = n // (2 * run)
    tile = min(outlen, 2048)
    out = np.empty((kw, pairs * outlen), dtype=x.dtype)
    for blk in range(pairs * outlen // tile):
        pair, d0 = divmod(blk, outlen // tile)
        d0 *= tile
        e0 = d0 + np.arange(0, tile, 8, dtype=np.int64)
        got = merge_outputs(x, np.full(e0.size, 2 * run * pair), run, e0,
                            8).reshape(kw, tile)
        e = np.arange(tile)
        if alt and (pair % alt) & 1:
            out[:, pair * outlen + outlen - 1 - d0 - e] = got
        else:
            out[:, pair * outlen + d0 + e] = got
    return out


def k8_model(planes: np.ndarray, run: int):
    """(kw, G, m) uint32 -> (K8's output, launches): tiles of 2,048 (runs
    <= 2,048) or 4,096 entries, the last one padded with sentinels, each
    thread's 8 keys sorted in registers, the block's levels up to the run
    (or the tile), odd runs of a row mirrored in the tile's store; K5's
    levels above the tile, the last reversing."""
    kw, g, m = planes.shape
    total, alt = g * m, m // run
    tile = 2048 if run <= 2048 else RUN_TILE
    x = np.full((kw, -(-total // tile) * tile), SENT, dtype=np.uint32)
    x[:, :total] = planes.reshape(kw, total)
    x = register_sort(x, RUN_E)
    length = RUN_E
    while length < min(run, tile):
        x = merge_level(x, length, RUN_E)
        length *= 2
    x = x[:, :total]
    if run <= tile:
        i = np.arange(total, dtype=np.int64)
        odd = (i // run % alt) & 1 == 1
        out = np.empty_like(x)
        out[:, np.where(odd, i ^ (run - 1), i)] = x
        return out.reshape(kw, g, m), 1
    launches = 1
    while length < run:
        last = 2 * length == run
        x = staged_level(x, length, 2 * length, alt if last else 0)
        length *= 2
        launches += 1
    return x.reshape(kw, g, m), launches


def k9_tile(tile: np.ndarray, cut: int):
    """One CTA of K9's step 1 on (kw, 4,096) keys: the valid keys moved to
    the front in slot order (the ballot scan), the smallest power of two
    >= 8 that holds them sorted (8 keys a thread, then the levels cut to
    the share), the first min(cut, 4,096) entries written, sentinels past
    the sorted span.  Returns them and the levels run."""
    kw = tile.shape[0]
    valid = (tile != SENT).any(0)
    n = int(valid.sum())
    span = max(RUN_E, 1 << (n - 1).bit_length()) if n else RUN_E
    x = np.full((kw, span), SENT, dtype=np.uint32)
    x[:, :n] = tile[:, valid]
    x, length = cut_levels(register_sort(x, RUN_E), span, RUN_E,
                           span // RUN_E, cut, RUN_E, span // RUN_E)
    out = np.full((kw, min(cut, RUN_TILE)), SENT, dtype=np.uint32)
    out[:, :length] = x[:, :min(length, out.shape[1])]
    return out, (span // RUN_E).bit_length() - 1


def cut_merge_model(x: np.ndarray, nseg: int, pieces: int, length: int,
                    keep: int):
    """K9's merge of each segment's pieces to its first keep entries:
    levels cut to keep (staged_level) while a segment's pieces overflow
    CUT_KEYS, then cut_merge_kernel's levels in one segment's shared
    memory (span / 8 threads).  Returns the packed result and launches."""
    launches = 0
    while pieces > 1 and pieces * length > CUT_KEYS:
        outlen = min(keep, 2 * length)
        x = staged_level(x, length, outlen, 0)
        pieces, length = pieces // 2, outlen
        launches += 1
    if pieces > 1:
        span = pieces * length
        x, length = cut_levels(x, span, length, pieces, keep, 8, span // 8)
        x = x.reshape(x.shape[0], nseg, span)[:, :, :length]
        launches += 1
    return x.reshape(x.shape[0], -1), launches


def k9_model(planes: np.ndarray, capacity: int):
    """(kw, G, m = t * 32,768) uint32 -> (K9's (kw, G, capacity), launches):
    tiles of 4,096 (k9_tile), each writing its first min(cut, 4,096)
    entries packed; each 32,768-entry tile's 8 pieces merged to its cut;
    each row's t cuts merged (cut_merge_kernel up to 8,192, else K5's
    levels)."""
    kw, g, m = planes.shape
    t = m // TILE
    cut = capacity // t
    cutc = min(cut, RUN_TILE)
    x = planes.reshape(kw, g * m // RUN_TILE, RUN_TILE)
    x = np.concatenate([k9_tile(x[:, i], cut)[0]
                        for i in range(x.shape[1])], axis=1)
    x, launches = cut_merge_model(x, g * t, TILE // RUN_TILE, cutc, cut)
    if capacity <= CUT_KEYS:
        x, more = cut_merge_model(x, g, t, cut, capacity)
    else:                                   # K5's merge_runs
        run = cut
        while run < capacity:               # pairs never cross a row
            x = merge_level(x, run, 8)
            run *= 2
        # one launch for the levels below 2,048, then one a level
        more = (cut < 2048) + (capacity // max(cut, 2048)).bit_length() - 1
    return x.reshape(kw, g, capacity), 1 + launches + more


def runs_input(rng, kw, g, m, run):
    x = sort_input(rng, kw, g, m)
    x[:, -1, :run] = SENT                      # an all-sentinel run
    return x


def plain(fn, planes, arg):
    got = fn(torch.from_numpy(planes.view(np.int32)), arg)
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("kw,g,runs,run,launches", [
    (1, 2, 4, 128, 1), (2, 3, 3, 256, 1), (3, 2, 1, 1024, 1),
    (4, 3, 3, 1024, 1), (2, 8, 2, 2048, 1), (1, 1, 3, 4096, 1),
    (2, 2, 3, 8192, 2), (3, 1, 2, 16384, 3), (4, 1, 1, 32768, 4)])
def test_k8_model_matches_plain(kw, g, runs, run, launches):
    """Runs sorted in tiles that stop at the run (runs of 128 to 2,048
    share a tile of 2,048; a tile past the end of an odd run count is
    padded), odd runs mirrored in the tile's store, and K5's levels above
    4,096 whose last staged store writes odd runs reversed; odd run counts
    a row, duplicates, an all-sentinel run, kw 1-4."""
    rng = np.random.default_rng(run * runs + kw)
    planes = runs_input(rng, kw, g, runs * run, run)
    got, count = k8_model(planes, run)
    np.testing.assert_array_equal(got, plain(sort.sort_runs_plain, planes,
                                             run))
    assert count == launches


@pytest.mark.parametrize("valid,cut,levels", [(0, 512, 0), (8, 128, 0),
                                              (33, 512, 3), (600, 512, 7),
                                              (4096, 128, 9),
                                              (4096, 4096, 9)])
def test_k9_tile_sorts_only_its_valid_span(valid, cut, levels):
    """A tile of K9's step 1 sorts only the power of two that holds its
    valid keys (33 valid: 64 entries, 3 levels; a full tile 9), and
    writes the full sort's first cut entries; keys with some all-ones
    words stay valid."""
    rng = np.random.default_rng(valid + cut)
    tile = np.full((2, RUN_TILE), SENT, dtype=np.uint32)
    pos = rng.choice(RUN_TILE, valid, replace=False)
    tile[:, pos] = rng.integers(0, 2 ** 32, (2, valid), dtype=np.uint64)
    tile[1, pos[::5]] = SENT
    got, count = k9_tile(tile, cut)
    want = lexsorted(tile[:, None])[:, 0, :min(cut, RUN_TILE)]
    np.testing.assert_array_equal(got, want)
    assert count == levels


def truncate_input(rng, kw, g, t, cap, kind):
    m, cut = t * TILE, cap // t
    x = np.full((kw, g, m), SENT, dtype=np.uint32)
    keys = rng.integers(0, 2 ** 31, (kw, g, m), dtype=np.uint64).astype(
        np.uint32)
    if kind == "full":
        return keys
    for r in range(g):
        for j in range(t):
            pos = j * TILE + rng.choice(TILE, {"exact": cut,
                                               "over": 2 * cut}[kind],
                                        replace=False)
            x[:, r, pos] = keys[:, r, pos]
    x[:, :, TILE:2 * TILE] = np.where(x[:, :, TILE:2 * TILE] == SENT, SENT,
                                      x[:, :, :TILE])   # ties across tiles
    return x


@pytest.mark.parametrize("kw,g,t,cap,kind,launches", [
    (2, 1, 4, 2048, "exact", 3), (1, 2, 2, 256, "over", 3),
    (3, 1, 2, 512, "exact", 3), (4, 1, 2, 4096, "over", 4),
    (2, 1, 2, 65536, "full", 5), (1, 1, 4, 16384, "over", 6),
    (2, 1, 16, 8192, "exact", 3)])
def test_k9_model_matches_plain(kw, g, t, cap, kind, launches):
    """The levels cut to each pair's first cut outputs with the thread-skip
    rule, each tile's first cut entries written packed, the tile's pieces
    merged to its cut (levels cut to the share above 8,192 entries a
    tile, then one CTA), a row's cuts merged; cut 128 to 32,768 (no cut),
    tiles with exactly or more than their cut of valid keys, ties across
    tiles, kw 1-4."""
    rng = np.random.default_rng(t * cap + kw)
    planes = truncate_input(rng, kw, g, t, cap, kind)
    got, count = k9_model(planes, cap)
    np.testing.assert_array_equal(
        got, plain(sort.sort_truncate_plain, planes, cap))
    assert count == launches
