"""The plain reference against the program's CPU path at small sizes."""
import numpy as np
import pytest

from benchmark import data, reference
from spaced_kmer_sketching_tpu_torch import driver
from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.utils.boosthash import hash_bitset128
from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

CONFIGS = [(10, 10), (20, 16), (12, 5), (33, 20), (50, 40), (64, 31)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    return data.write_genomes(d, 7, {"length_nt": 6000,
                                     "substitution": 0.03})


def _program_keys(sketch):
    """The program's sketch as sorted (hi, lo) rows, the reference's form."""
    u = sketch.keys_u64()
    return u[:, ::-1]


@pytest.mark.parametrize("window,k", CONFIGS)
@pytest.mark.parametrize("variant", ["modern", "legacy"])
def test_sketches_match_program(pair, window, k, variant):
    cfg = SketchConfig(window=window, k=k, hash_variant=variant)
    got = FracMinHashSketcher(cfg, device="cpu").sketch_files(pair)
    mask = reference.spaced_mask(window, k)
    for path, sk in zip(pair, got):
        want = reference.sketch(reference.read_fasta_runs(path), mask,
                                variant=variant)
        assert want.shape[0] > 0 or window == 64
        np.testing.assert_array_equal(_program_keys(sk), want)


@pytest.mark.parametrize("window,k", [(20, 16), (50, 40)])
def test_experiment_matches_program(pair, tmp_path, window, k):
    csv = tmp_path / "out.csv"
    ani = driver.run_experiment(window, k, pair, str(csv), False,
                                device="cpu", echo_timings=False)
    mask, counts, inter = reference.experiment(
        [reference.read_fasta_runs(p) for p in pair], window, k)
    want = reference.ani(inter, counts, k)
    assert np.array_equal(np.asarray(ani, np.float64), want)
    assert 0.3 < want[1] < 1.0                 # related genomes
    lines = [reference.CSV_HEADER] + reference.csv_rows(pair, want, mask)
    assert csv.read_text() == "\n".join(lines) + "\n"


def test_float32_ani_differs(pair):
    _, counts, inter = reference.experiment(
        [reference.read_fasta_runs(p) for p in pair], 20, 16)
    exact = reference.ani(inter, counts, 16)
    low = reference.ani(inter, counts, 16, np.float32)
    assert np.count_nonzero(exact != low) >= 2          # the cross pairs


def test_masks_match_program():
    for w, k, _ in driver.reference_sweep_schedule():
        assert reference.spaced_mask(w, k).bitstring() == \
            spaced_seed_mask(w, k, use_native=False).bitstring()


@pytest.mark.parametrize("variant", ["modern", "legacy"])
def test_hash_matches_program(variant):
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 2 ** 63, 1000, dtype=np.uint64) * np.uint64(2)
    hi = rng.integers(0, 2 ** 40, 1000, dtype=np.uint64)
    np.testing.assert_array_equal(reference.hash128(lo, hi, variant),
                                  hash_bitset128(lo, hi, variant))


FASTA_CASES = [
    b">a\nACGTNacgt\nGGGG\n>b\nTTTTTT\n",
    b"ACGT\n>a\nACG TT\nCCCC\n>b\nAAAA\n\nCCCCCC\n",   # space drops a record
    b">a\nAC\rGT\n\n\nGGG\n>\nAAAA\n>c\n",             # \r splits a run
    b">a\nACGTRYKMACGT\nacgtn\n",
]


@pytest.mark.parametrize("text", FASTA_CASES)
def test_fasta_rules_match_program(tmp_path, text):
    path = tmp_path / "x.fa"
    path.write_bytes(text)
    runs = reference.read_fasta_runs(str(path))
    for use_native in (False, True):
        pk = read_fasta(str(path), use_native=use_native)
        assert [r.size for r in runs] == list(pk.run_lens)
        got = np.concatenate(runs) if runs else np.empty(0, np.uint8)
        np.testing.assert_array_equal(got, pk.codes)


def test_unpack_matches_program_packing():
    from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import pack2bit
    codes = np.random.default_rng(5).integers(0, 4, 1000).astype(np.uint8)
    words = pack2bit(codes, 63)
    np.testing.assert_array_equal(reference.unpack_2bit(words, 1000), codes)


def test_intersections_count_shared_keys():
    a = np.array([[0, 1], [0, 2], [1, 0]], np.uint64)
    b = np.array([[0, 2], [1, 0], [5, 5]], np.uint64)
    c = np.empty((0, 2), np.uint64)
    np.testing.assert_array_equal(reference.intersections([a, b, c]),
                                  [[3, 2, 0], [2, 3, 0], [0, 0, 0]])
