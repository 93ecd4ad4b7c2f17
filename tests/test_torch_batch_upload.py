"""The batch step's genome uploads (models/fracminhash.py) against host
planes and the JAX sketcher.

The batch step packs each genome into 2-bit words and run ends, uploads
them, and expands the run-id plane on the device.  The port runs on the
CPU (the kernels' plain versions); every comparison is exact.
"""
import numpy as np
import torch

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs as JaxPacked
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher)

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
from spaced_kmer_sketching_tpu_torch.models import fracminhash as fm
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import pack2bit_rows

CPU = torch.device("cpu")
N = 16384
# (window, k): finish_words 1, 2, 3 and 4
SWEEP = ((14, 9), (24, 16), (40, 24), (60, 40))


def genome(seed: int, runs: int = 12, lo: int = 5, hi: int = 900):
    """Codes and run lengths of a genome cut by N-runs, some runs shorter
    than the windows."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, runs).astype(np.int64)
    return PackedSeqs(rng.integers(0, 4, int(lens.sum())).astype(np.uint8),
                      lens)


def up(pk: PackedSeqs, n: int = N, device: torch.device = CPU):
    """One genome's upload."""
    return fm.upload_genomes([pk], n, device)[0]


def host_planes(genomes, n):
    """The batch step's inputs built on the host with a loop over runs:
    the (G, n/16) code words and the (G, n) run-id plane."""
    codes = np.zeros((len(genomes), n), np.uint8)
    rid = np.full((len(genomes), n), -1, np.int32)
    for j, pk in enumerate(genomes):
        codes[j, :pk.codes.size] = pk.codes
        pos = 0
        for r, ln in enumerate(pk.run_lens):
            rid[j, pos:pos + int(ln)] = r
            pos += int(ln)
    return pack2bit_rows(codes).view(np.int32), rid


def test_stacked_inputs_equal_host_planes():
    """The step's inputs stacked from the uploads are bit for bit the host
    planes, with zero-length runs first, inside and last, and new tensors
    that share no memory with the uploads."""
    gs = [genome(1), genome(2, runs=3),
          PackedSeqs(genome(3, runs=4).codes[:1200],
                     np.array([0, 500, 0, 700, 0], np.int64))]
    ups = [up(g) for g in gs]
    packed, rid = fm._stack_uploads(ups, N)
    want_packed, want_rid = host_planes(gs, N)
    assert packed.dtype == rid.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    np.testing.assert_array_equal(rid.numpy(), want_rid)
    for u in ups:
        assert not packed.untyped_storage().data_ptr() == \
            u.words.untyped_storage().data_ptr()


def test_mini_sweep_equals_jax():
    """Three genomes with N-runs over four configs (finish_words 1-4), one
    sketcher a config as the driver's sweep builds them: every sketch
    equals the JAX sketcher's."""
    genomes = [genome(10), genome(11, runs=20), genome(12, runs=6)]
    jax_packed = [JaxPacked(g.codes, g.run_lens) for g in genomes]
    for window, k in SWEEP:
        got = FracMinHashSketcher(SketchConfig(window=window, k=k, scale=8),
                                  device="cpu").sketch_packed_batch(genomes)
        want = JaxSketcher(JaxConfig(window=window, k=k, scale=8)) \
            .sketch_packed_batch(jax_packed)
        for x, z in zip(got, want):
            assert x.count == z.count > 0
            np.testing.assert_array_equal(x.keys, z.keys)


def test_overflow_retry_equals_first_sketch():
    """A sketch at a capacity that sends one genome through the batch
    step's overflow retry (index_select of the stacked inputs) returns the
    keys and counts of a sketch that fits the first time, the other genome
    untouched by the retry."""
    rng = np.random.default_rng(23)
    genomes = [PackedSeqs(rng.integers(0, 4, 5000).astype(np.uint8),
                          np.array([2000, 3000])),
               PackedSeqs(rng.integers(0, 4, 600).astype(np.uint8),
                          np.array([600]))]
    cfg = dict(window=14, k=9, scale=4)
    first = FracMinHashSketcher(SketchConfig(**cfg), device="cpu") \
        .sketch_packed_batch(genomes)
    retry = FracMinHashSketcher(SketchConfig(**cfg, sketch_capacity=256),
                                device="cpu")
    raws = retry._dispatch_sketch(genomes, N, 256)[0].raw_kept.numpy()
    assert raws[0] > 256 >= raws[1]          # only genome 0 overflows
    second = retry.sketch_packed_batch(genomes)
    assert second[0].count > 256
    for a, b in zip(first, second):
        assert a.count == b.count
        np.testing.assert_array_equal(a.keys, b.keys)
