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

from spaced_kmer_sketching_tpu_torch.ops.cuda import build
from spaced_kmer_sketching_tpu_torch.ops.cuda import compact, extract, sort
from spaced_kmer_sketching_tpu_torch.ops.sketch import (
    _k_slots_for, finish_words, sketch_batch_packed_dyn)
from spaced_kmer_sketching_tpu_torch.utils import boosthash
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


@pytest.mark.parametrize("variant", ["modern", "legacy"])
@pytest.mark.parametrize("window,k", [(10, 10), (20, 16), (31, 20),
                                      (33, 25), (50, 40), (64, 40)])
def test_k1_matches_plain(dev, window, k, variant):
    rng = np.random.default_rng(window)
    g, n = 2, 262144
    codes, rid = genome_batch(rng, g, n, [100000, 40, 100000])
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    p = torch.from_numpy(extract.pack2bit_rows(codes).view(np.int32)).to(dev)
    r = torch.from_numpy(rid).to(dev)
    kw = finish_words(window)
    nw = n - (16 * (kw - 1) + 1) + 1
    args = dict(window=window, nw=nw, scale=20, variant=variant,
                k_slots=_k_slots_for(nw, 20, 4096), out_words=kw)
    got = extract.extract_compact(p, r, mask.words_u32, salt, **args)
    want = extract.extract_compact_plain(p, r, mask.words_u32, salt, **args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("kw", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1024, 65536])
def test_k4_matches_plain(dev, n, kw):
    z = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, 2, n), dtype=torch.int32,
                      device=dev)
    z[:, :, ::3] = z[:, :, 1:2]
    z[:, :, -100:] = -1
    assert torch.equal(sort.sort_rows(z), sort.sort_rows_plain(z))


def test_sketch_step_counts_every_kernel(dev):
    """The dyn sketch step on the GPU launches K1-K4 (tree finish shape)
    and gives the plain versions' result."""
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
    assert all(k.launches > 0 for k in build.KERNELS.values())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
