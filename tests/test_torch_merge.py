"""The port's K5 / K10 merge wrappers on the CPU: K10's gid offset and the
wrappers' argument checks.

merge_pair_streams shifts stream B's valid gids as it reads them (the
blocked schedule's column block, ops/gram.py); its plain version must give
what merging a shifted copy gave, and what the JAX package's pair merge
(Pallas interpret mode) gives on the stream the JAX schedule shifts
(spaced_kmer_sketching_tpu/ops/gram.py:704-706).  Inputs are made with
numpy from a seed; every value is an integer, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.ops.pallas.sort import (
    merge_pair_streams as jax_merge_pair_streams)

from spaced_kmer_sketching_tpu_torch.ops.cuda import sort

BLOCK = 128


def packed_stream(rng, pw, rows, gids, sentinels):
    """(pw, rows, 128) int32 ascending packed stream: random keys above a
    gid field of 8 bits (gids in [0, gids)), word pw-1's top bit clear, the
    last `sentinels` entries all-ones."""
    n = rows * 128
    hi = np.full(pw, 1 << 32, np.int64)
    hi[-1] = 1 << 31
    words = rng.integers(0, hi, (n, pw))
    words[:, 0] = (words[:, 0] & ~0xFF) | rng.integers(0, gids, n)
    words = words[np.lexsort(words.T)]
    if sentinels:
        words[n - sentinels:] = 0xFFFFFFFF
    planes = words.T.astype(np.uint32).reshape(pw, rows, 128)
    return torch.from_numpy(planes.view(np.int32).copy())


def shifted_copy(pb, block):
    """Stream B with block added to plane 0 of its valid entries, as the
    blocked schedule shifted it before K10 took the offset."""
    shift = (pb[-1] >= 0).to(torch.int32) * block
    return torch.cat([(pb[0] + shift)[None], pb[1:]])


@pytest.mark.parametrize("pw,rows,sent_a,sent_b", [
    (1, 1, 0, 40), (2, 4, 100, 0), (2, 16, 2048, 1000), (3, 8, 1024, 1024),
    (5, 2, 0, 0), (5, 4, 512, 300)])
def test_pair_offset_equals_merge_of_shifted_copy(pw, rows, sent_a, sent_b):
    rng = np.random.default_rng(pw * 100 + rows)
    pa = packed_stream(rng, pw, rows, BLOCK, sent_a)
    pb = packed_stream(rng, pw, rows, BLOCK, sent_b)
    want = sort.merge_pair_streams_plain(pa, shifted_copy(pb, BLOCK))
    got = sort.merge_pair_streams_plain(pa, pb, b_gid_offset=BLOCK)
    assert torch.equal(got, want)
    assert torch.equal(sort.merge_pair_streams(pa, pb, b_gid_offset=BLOCK),
                       want)
    # sentinels stay all-ones and sort last; every valid gid of B moved
    sent = (got == -1).all(0)
    assert int(sent.sum()) == sent_a + sent_b
    assert bool(sent.reshape(-1)[got.shape[1] * 128 - sent_a - sent_b:]
                .all())
    assert not bool((got[-1] < 0)[~sent].any())
    gid = got[0][~sent] & 0xFF
    assert int((gid >= BLOCK).sum()) == rows * 128 - sent_b


@pytest.mark.parametrize("pw", [1, 2, 5])
def test_pair_offset_zero_is_the_default(pw):
    rng = np.random.default_rng(pw)
    pa = packed_stream(rng, pw, 4, BLOCK, 50)
    pb = packed_stream(rng, pw, 4, BLOCK, 70)
    want = sort.merge_pair_streams_plain(pa, pb)
    assert torch.equal(sort.merge_pair_streams(pa, pb, b_gid_offset=0), want)
    assert torch.equal(sort.merge_pair_streams(pa, pb), want)


@pytest.mark.parametrize("pw", [2, 5])
def test_pair_offset_matches_jax_schedule(pw):
    """The JAX schedule shifts stream B itself, then runs its pair merge
    in interpret mode; the port's plain version takes the offset."""
    rng = np.random.default_rng(40 + pw)
    pa = packed_stream(rng, pw, 8, BLOCK, 200)
    pb = packed_stream(rng, pw, 8, BLOCK, 500)
    ja = [jnp.asarray(p.numpy().view(np.uint32)) for p in pa]
    jb = [jnp.asarray(p.numpy().view(np.uint32)) for p in pb]
    valid = (jb[pw - 1] >> 31) == 0
    jb[0] = jb[0] + jnp.where(valid, jnp.uint32(BLOCK), jnp.uint32(0))
    want = jax_merge_pair_streams(ja, jb, interpret=True, nkeys=pw)
    got = sort.merge_pair_streams_plain(pa, pb, b_gid_offset=BLOCK)
    for q in range(pw):
        np.testing.assert_array_equal(got[q].numpy().view(np.uint32),
                                      np.asarray(want[q]))


def planes(pw, rows):
    return torch.zeros((pw, rows, 128), dtype=torch.int32)


@pytest.mark.parametrize("rows,run_rows,what", [
    (6, 2, "3 runs: not a power-of-two count"),
    (12, 4, "3 runs: not a power-of-two count"),
    (8, 3, "a run length that does not divide the rows"),
    (12, 3, "4 runs of 3 rows: not a power-of-two length"),
    (8, 16, "a run longer than the stream")])
def test_merge_sorted_runs_rejects(rows, run_rows, what):
    with pytest.raises(ValueError, match="power-of-two"):
        sort.merge_sorted_runs(planes(2, rows), run_rows)


@pytest.mark.parametrize("shape", [(6, 4, 128), (2, 4, 64), (2, 4)])
def test_merge_sorted_runs_rejects_bad_planes(shape):
    with pytest.raises(ValueError, match="planes"):
        sort.merge_sorted_runs(torch.zeros(shape, dtype=torch.int32), 1)


@pytest.mark.parametrize("a,b", [((2, 4), (2, 8)), ((2, 4), (3, 4)),
                                 ((2, 6), (2, 6)), ((2, 3), (2, 3))])
def test_merge_pair_streams_rejects_unequal_or_odd_streams(a, b):
    with pytest.raises(ValueError, match="two equal streams"):
        sort.merge_pair_streams(planes(*a), planes(*b))


@pytest.mark.parametrize("offset", [-1, 1 << 31])
def test_merge_pair_streams_rejects_bad_offset(offset):
    with pytest.raises(ValueError, match="b_gid_offset"):
        sort.merge_pair_streams(planes(2, 4), planes(2, 4),
                                b_gid_offset=offset)


@pytest.mark.parametrize("n,run", [(1024, 3), (1024, 2048), (768, 256),
                                   (1024, 0)])
def test_merge_row_runs_rejects(n, run):
    with pytest.raises(ValueError, match="power-of-two runs"):
        sort.merge_row_runs(torch.zeros((2, 3, n), dtype=torch.int32), run)


@pytest.mark.parametrize("m,capacity", [(2 * sort.TILE, 128),
                                        (2 * sort.TILE, 4 * sort.TILE),
                                        (3 * sort.TILE, 3 * 128)])
def test_sort_truncate_rejects(m, capacity):
    with pytest.raises(ValueError, match="sort_truncate takes"):
        sort.sort_truncate(torch.zeros((2, 1, m), dtype=torch.int32),
                           capacity)
