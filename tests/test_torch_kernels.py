"""The port's kernel modules (K1-K4) against the JAX package's Pallas kernels.

On the CPU every port wrapper runs its kernel's plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do.  Inputs are made from a seed with numpy and fed to both.  Every
comparison is exact: the values are integer keys and counts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
from spaced_kmer_sketching_tpu.ops.pallas.compact import (
    compact_global as jax_compact_global, compact_rows as jax_compact_rows)
from spaced_kmer_sketching_tpu.ops.pallas.extract import (
    extract_compact_windows_prepacked, pack_genomes_np)
from spaced_kmer_sketching_tpu.ops.pallas.sort import bitonic_sort_128
from spaced_kmer_sketching_tpu.utils import boosthash
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

from spaced_kmer_sketching_tpu_torch.ops import u64ops
from spaced_kmer_sketching_tpu_torch.ops.cuda import build
from spaced_kmer_sketching_tpu_torch.ops.cuda.compact import (
    compact_global, compact_rows)
from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import (
    extract_compact, pack2bit_rows)
from spaced_kmer_sketching_tpu_torch.ops.cuda.sort import sort_rows
from spaced_kmer_sketching_tpu_torch.ops.sketch import finish_words
from spaced_kmer_sketching_tpu_torch.utils import boosthash as t_boosthash

SENT = 0xFFFFFFFF


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def run_k1(codes, rid, mask, salt, window, scale, variant, k_slots):
    """K1 through both packages with the dynamic-window contract; returns
    (jax words, jax rowcnt, port planes, port rowcnt) as numpy."""
    g, n = codes.shape
    kw = finish_words(window)
    nw = n - (16 * (kw - 1) + 1) + 1          # the dyn step's nw_prog
    qc, qr, r = pack_genomes_np(codes, rid)
    salts = np.broadcast_to(np.concatenate(
        [u64ops.salt_pair(salt), [window]]).astype(np.uint32), (g, 3))
    jw, jrc, _ = extract_compact_windows_prepacked(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(r),
        jnp.asarray(mask.words_u32), nw=nw, window=None,
        salt=jnp.asarray(salts), scale=scale, variant=variant,
        k_slots=k_slots, out_words=kw, interpret=True)
    planes, rowcnt = extract_compact(
        i32(pack2bit_rows(codes.astype(np.uint8))), torch.from_numpy(rid),
        mask.words_u32, salt, window=window, nw=nw, scale=scale,
        variant=variant, k_slots=k_slots, out_words=kw)
    return ([np.asarray(w) for w in jw], np.asarray(jrc), u32(planes),
            rowcnt.numpy())


@pytest.mark.parametrize("variant", ["modern", "legacy"])
@pytest.mark.parametrize("window,k", [(10, 10), (20, 16), (31, 21),
                                      (33, 25), (50, 40), (64, 40)])
def test_k1_matches_pallas_extract(window, k, variant):
    """One 32,768-window block, three runs per genome and a padding tail;
    scale 8 with 8 slots makes some rows overflow their slots."""
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    rng = np.random.default_rng(window)
    g, n = 2, 16384
    codes = rng.integers(0, 4, (g, n)).astype(np.uint32)
    rid = np.stack([run_ids_from_lens([5000, 40, 11000], n)] * g)
    jw, jrc, planes, rowcnt = run_k1(codes, rid, mask, salt, window, 8,
                                     variant, 8)
    np.testing.assert_array_equal(rowcnt, jrc)
    assert len(jw) == planes.shape[0] == finish_words(window)
    for q, w in enumerate(jw):
        np.testing.assert_array_equal(planes[q], w)
    assert (rowcnt > 8).any() and rowcnt.sum() > 0


def test_k1_two_blocks():
    """Two 32,768-window blocks (the block seam must not matter)."""
    window, k, scale = 20, 16, 50
    mask = spaced_seed_mask(window, k, 3)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    rng = np.random.default_rng(5)
    g, n = 2, 65536
    codes = rng.integers(0, 4, (g, n)).astype(np.uint32)
    rid = np.stack([run_ids_from_lens([30000, 20000, 15000], n)] * g)
    jw, jrc, planes, rowcnt = run_k1(codes, rid, mask, salt, window, scale,
                                     "modern", 16)
    assert rowcnt.shape == (g, 512)
    np.testing.assert_array_equal(rowcnt, jrc)
    for q, w in enumerate(jw):
        np.testing.assert_array_equal(planes[q], w)


def test_k1_overflowing_row_reports_true_counts():
    """Poly-A: every window has the same key; at scale 1 every valid window
    is kept, so each full row keeps 128 > k_slots and must say so."""
    window, k = 12, 8
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    g, n = 1, 16384
    codes = np.zeros((g, n), np.uint32)
    rid = run_ids_from_lens([n - 100], n)[None]
    jw, jrc, planes, rowcnt = run_k1(codes, rid, mask, salt, window, 1,
                                     "modern", 8)
    np.testing.assert_array_equal(rowcnt, jrc)
    for q, w in enumerate(jw):
        np.testing.assert_array_equal(planes[q], w)
    assert rowcnt.max() == 128 and rowcnt.sum() == n - 100 - window + 1


def test_fmh_keep_matches_host_hash():
    """The plain int64-held u64 hash against the host numpy boost hash, for
    both variants, on keys with every word populated."""
    rng = np.random.default_rng(17)
    w = rng.integers(0, 2 ** 32, (4, 4096), dtype=np.uint64)
    w[:, :4] = 0xFFFFFFFF
    lo = w[0] | (w[1] << np.uint64(32))
    hi = w[2] | (w[3] << np.uint64(32))
    words = [torch.from_numpy(x.astype(np.int64)) for x in w]
    for variant in ("modern", "legacy"):
        want = t_boosthash.hash_bitset128(lo, hi, variant)
        h, l = u64ops.hash_bitset128(*words, variant=variant)
        got = (h.numpy().astype(np.uint64) << np.uint64(32)) | \
            l.numpy().astype(np.uint64)
        np.testing.assert_array_equal(got, want)
        salt = 0x0123456789ABCDEF
        keep = u64ops.fmh_keep(*words, salt=salt, scale=7, variant=variant)
        np.testing.assert_array_equal(
            keep.numpy(), t_boosthash.sketch_keep(lo, hi, salt, 7, variant))


def holed_planes(rng, kw, shape, fill):
    """Random u32 words with all-ones holes (a fraction `fill` valid)."""
    words = rng.integers(0, 2 ** 32 - 1, (kw,) + shape,
                         dtype=np.uint64).astype(np.uint32)
    words[:, rng.random(shape) >= fill] = SENT
    return words


@pytest.mark.parametrize("kw", [1, 2, 4])
def test_k2_matches_pallas_compact_rows(kw):
    rng = np.random.default_rng(9 + kw)
    g, r, k_out = 2, 16, 16
    words = holed_planes(rng, kw, (g, r, 128), 0.12)   # some rows overflow
    jout, jcnt = jax_compact_rows([jnp.asarray(w) for w in words], k_out,
                                  interpret=True, with_counts=True)
    out, counts = compact_rows(i32(words), k_out, with_counts=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcnt))
    for q in range(kw):
        np.testing.assert_array_equal(u32(out)[q], np.asarray(jout[q]))
    assert (counts.numpy() == k_out).any()
    out2, none = compact_rows(i32(words), k_out)
    assert none is None and torch.equal(out2, out)


@pytest.mark.parametrize("kw", [1, 3, 4])
def test_k3_matches_pallas_compact_global(kw):
    rng = np.random.default_rng(13 + kw)
    g, n = 3, 2048
    words = holed_planes(rng, kw, (g, n), 0.3)
    words[:, 1] = SENT                        # an empty genome row
    jout = jax_compact_global([jnp.asarray(w) for w in words],
                              interpret=True)
    out = compact_global(i32(words))
    for q in range(kw):
        np.testing.assert_array_equal(u32(out)[q], np.asarray(jout[q]))


def keys_with_duplicates(rng, kw, g, n):
    keys = rng.integers(0, 2 ** 32, (kw, g, n), dtype=np.uint64).astype(
        np.uint32)
    keys[:, :, ::3] = keys[:, :, 1:2]          # heavy duplication
    keys[:, :, -100:] = SENT                  # sentinel padding
    keys[kw // 2:, :, :50] = 0                # low-entropy high words
    return keys


@pytest.mark.parametrize("n,kw", [(1024, 1), (1024, 4), (4096, 2)])
def test_k4_matches_pallas_bitonic_sort(n, kw):
    rng = np.random.default_rng(n + kw)
    g = 2
    keys = keys_with_duplicates(rng, kw, g, n)
    out = u32(sort_rows(i32(keys)))
    for gi in range(g):
        want = np.asarray(bitonic_sort_128(
            jnp.asarray(keys[:, gi].T.copy()), interpret=True))
        np.testing.assert_array_equal(out[:, gi].T, want)


@pytest.mark.parametrize("kw", [2, 3])
def test_k4_main_path_size_matches_lexsort(kw):
    """N = 65,536, the main path's tiled sort size (interpret mode is too
    slow there, so numpy's lexsort is the reference)."""
    rng = np.random.default_rng(kw)
    g, n = 2, 65536
    keys = keys_with_duplicates(rng, kw, g, n)
    out = u32(sort_rows(i32(keys)))
    for gi in range(g):
        order = np.lexsort(tuple(keys[q, gi] for q in range(kw)))
        np.testing.assert_array_equal(out[:, gi], keys[:, gi][:, order])


def test_wrappers_validate_and_take_plain_on_cpu():
    """CPU tensors run the plain versions (no launch is counted); bad
    shapes are refused before any kernel could see them."""
    build.reset_launches()
    keys = torch.full((2, 1, 1024), -1, dtype=torch.int32)
    assert torch.equal(sort_rows(keys), keys)
    assert all(k.launches == 0 for k in build.KERNELS.values())
    with pytest.raises(ValueError):
        sort_rows(torch.zeros((2, 1, 1000), dtype=torch.int32))
    with pytest.raises(ValueError):
        compact_rows(torch.zeros((2, 1, 4, 64), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        compact_global(torch.zeros((5, 1, 1024), dtype=torch.int32))
    with pytest.raises(ValueError):
        extract_compact(torch.zeros((1, 10), dtype=torch.int32),
                        torch.zeros((1, 1024), dtype=torch.int32),
                        [0, 0, 0, 0], 0, window=20, nw=1000, scale=2,
                        variant="modern", k_slots=8, out_words=2)


def test_pack2bit_rows_numpy_fallback_matches_native(monkeypatch):
    """K1's genome plane: 16 codes per u32, LSB first, with or without the
    native library."""
    from spaced_kmer_sketching_tpu_torch.utils import native
    codes = np.random.default_rng(2).integers(0, 4, (3, 4096)).astype(np.uint8)
    with_native = pack2bit_rows(codes)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(pack2bit_rows(codes), with_native)
    assert with_native[0, 0] == sum(int(c) << (2 * i)
                                    for i, c in enumerate(codes[0, :16]))
