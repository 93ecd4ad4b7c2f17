"""Models of the decompositions of K7 (the sliding raw-word extract) and K4
(the register tile sort), held on the CPU to the port's plain versions.

The CUDA kernels cannot run here, so each test re-traces one kernel's
decomposition in numpy, as csrc/extract.cu and csrc/sort.cu compute it:

* K7: the FracMinHash filter's remainder as a multiply-high by the
  reciprocal that ops/cuda/extract.fmh_divisor computes, a shift, a
  multiply and a subtract; a thread's 32 windows from a word-aligned
  start, its two strands built once and slid one code a window (the
  forward strand from a stream of the codes at t + w, the complement's
  source from the codes at t + 64); one upper-bound search of the run
  starts a thread and a walk forward; each 128-window row's four kept
  masks scanned into slots, the kept keys rebuilt into them, the
  sentinel fill and the row count.
* K4: the tile by kw, each thread's E keys sorted by an unrolled bitonic
  network, the block's merge-path levels (each thread's diagonal found by
  a binary search, then E outputs merged in turn), and K5's levels above
  the tile.

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
C = 32                 # K7: windows a thread
ROW_THREADS = 4        # K7: threads a 128-window row
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


def thread_keys(words: Words, t0: np.ndarray, window: int, mask):
    """Each thread's 32 canonical keys (threads, 32) as slide_windows
    computes them: strands at t0, then one slide a window, the codes
    taken from the two streams."""
    a = t0 >> 4
    next_s = words(a + 4) | (words(a + 5) << u(32))
    b, o = a + (window >> 4), 2 * (window & 15)
    x0 = words(b) | (words(b + 1) << u(32))
    next_f = (shr(x0, o) | shl(words(b + 2), 64 - o)) if o else x0
    st = strands_at(words, t0, window)
    lo = np.zeros((t0.size, C), U64)
    hi = np.zeros_like(lo)
    for i in range(C):
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
    """Every window of every thread, from the thread's first window slid
    one code at a time, and the rebuild of a kept key at any window, equal
    the direct key build; the last words run past the packed body."""
    rng = np.random.default_rng(window * 100 + k)
    n = 16 * 37 + 5                       # 38 words, the last one partial
    codes = rng.integers(0, 4, n).astype(np.uint8)
    packed = extract.pack2bit(codes, -(-n // 16)).astype(U64)
    words = Words(packed)
    for seed in (0, 1):
        mask = spaced_seed_mask(window, k, seed)
        t0 = np.arange(0, 16 * packed.size, C, dtype=np.int64)
        lo, hi = thread_keys(words, t0, window, mask)
        want_lo, want_hi = direct_keys(codes, t0.size * C, window, mask)
        np.testing.assert_array_equal(lo.reshape(-1), want_lo)
        np.testing.assert_array_equal(hi.reshape(-1), want_hi)
        t = np.arange(t0.size * C, dtype=np.int64)
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

def k7_model(packed, bounds, rid0, vlen, mask, salt, *, window, nw, scale,
             variant, k_slots, out_words):
    """K7 (one seed per genome row) as its kernel computes it."""
    g, p = packed.shape
    n = 16 * p
    rows = extract.out_rows(nw)
    threads = rows * ROW_THREADS
    out = np.full((out_words, g, rows * k_slots), SENT, np.uint32)
    rowcnt = np.zeros((g, rows), np.int32)
    for gi in range(g):
        words = Words(packed[gi].astype(np.uint32))
        t0 = np.arange(threads, dtype=np.int64) * C
        lo, hi = thread_keys(words, t0, window, mask)
        brow = [int(x) for x in bounds[gi]]
        bits = [thread_valid(brow, int(rid0[gi]), int(vlen[gi]), n,
                             int(t), window) for t in t0]
        valid = (np.array(bits, np.int64)[:, None] >> np.arange(C)) & 1 == 1
        hashed = boosthash.hash_bitset128(lo[valid], hi[valid],
                                          variant) ^ u(salt)
        kept = np.zeros_like(valid)
        kept[valid] = model_mod(hashed, scale) == 0
        # the row's four counts scanned; each thread's keys in order
        counts = kept.sum(1).reshape(rows, ROW_THREADS)
        first = (np.cumsum(counts, 1) - counts).reshape(-1)
        slot = first[:, None] + np.cumsum(kept, 1) - 1
        rowcnt[gi] = counts.sum(1)
        th, i = np.nonzero(kept & (slot < k_slots))
        t = t0[th] + i
        r_lo, r_hi = strand_key(strands_at(words, t, window), mask.lo,
                                mask.hi)
        dst = th // ROW_THREADS * k_slots + slot[th, i]
        key = [r_lo & u(M32), r_lo >> u(32), r_hi & u(M32), r_hi >> u(32)]
        for q in range(out_words):
            out[q, gi, dst] = key[q].astype(np.uint32)
    return out, rowcnt


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


def merge_level(x: np.ndarray, run: int, e: int) -> np.ndarray:
    """One merge level: every pair of ascending runs of `run` keys merged,
    each thread writing e outputs.  A thread finds its diagonal d0 by the
    binary search of smem_split (ties to A), then merges e outputs in
    turn, as merge_thread does."""
    kw, total = x.shape
    e0 = np.arange(0, total, e, dtype=np.int64)
    pair = e0 & ~(2 * run - 1)
    d0 = e0 - pair
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
    out = np.empty_like(x)
    for k in range(e):
        xa = x[:, pair + np.minimum(i, run - 1)]
        yb = x[:, pair + run + np.minimum(j, run - 1)]
        take_a = (j >= run) | ((i < run) & ~lex_less(yb, xa))
        out[:, e0 + k] = np.where(take_a, xa, yb)
        i, j = i + take_a, j + ~take_a
    return out


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
