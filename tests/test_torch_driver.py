"""The port's CLI against the JAX package's CLI: byte-identical CSVs.

The port runs with `--device cpu` (the kernels' plain versions); the JAX
driver runs on the CPU backend.  FASTAs are made from a seed with numpy.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from spaced_kmer_sketching_tpu import driver as jax_driver

from spaced_kmer_sketching_tpu_torch import driver

BASES = "ACGT"


def seq(codes) -> str:
    return "".join(BASES[c] for c in codes)


def write_fasta(path, records):
    with open(path, "w") as f:
        for i, s in enumerate(records):
            f.write(f">rec{i}\n")
            for j in range(0, len(s), 70):
                f.write(s[j:j + 70] + "\n")
    return str(path)


def mutate(rng, codes, rate):
    out = codes.copy()
    hit = rng.random(out.size) < rate
    out[hit] = rng.integers(0, 4, int(hit.sum()))
    return out


@pytest.fixture
def fastas(tmp_path):
    """Three genomes: a multi-record FASTA with non-ACGT splits, a 3%
    mutated copy of its first record, and an unrelated genome."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, 4000)
    s = seq(base)
    p0 = tmp_path / "g0.fa"
    p0.write_text(">r0\n" + s[:1700] + "NN\n" + s[1700:3000] + "\nnacgt"
                  + s[3000:] + "\n>r1\n" + seq(rng.integers(0, 4, 900))
                  + "\n")
    return [str(p0),
            write_fasta(tmp_path / "g1.fa", [seq(mutate(rng, base, 0.03))]),
            write_fasta(tmp_path / "g2.fa",
                        [seq(rng.integers(0, 4, 2500)),
                         seq(rng.integers(0, 4, 300))])]


def run_both(tmp_path, fastas, args):
    """Run both CLIs on the same inputs; returns the two CSVs' bytes."""
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    for a in args:
        assert jax_driver.main([str(jax_csv), *fastas, *a]) == 0
        assert driver.main([str(port_csv), *fastas, *a,
                            "--device", "cpu"]) == 0
    return jax_csv.read_bytes(), port_csv.read_bytes()


@pytest.mark.parametrize("variant", ["modern", "legacy"])
def test_one_experiment_csv_byte_identical(tmp_path, fastas, variant):
    want, got = run_both(tmp_path, fastas, [
        ["--window", "20", "--k", "16", "--scale", "20",
         "--hash-variant", variant]])
    assert got == want
    lines = got.decode().splitlines()
    assert len(lines) == 1 + 9
    assert lines[1].split(",")[2] == "1"               # self-pair
    assert 0.8 < float(lines[2].split(",")[2]) < 1     # the mutated copy


def test_append_and_options_csv_byte_identical(tmp_path, fastas):
    want, got = run_both(tmp_path, fastas, [
        ["--window", "12", "--k", "8", "--scale", "5", "--nonce", "3"],
        ["--window", "40", "--k", "30", "--scale", "7", "--mask-seed", "2",
         "--append"]])
    assert got == want
    assert got.decode().count("File 1") == 1


def test_reference_sweep_csv_byte_identical(tmp_path, fastas):
    """The 62-config sweep (no --window/--k) on two genomes."""
    want, got = run_both(tmp_path, fastas[:2], [["--scale", "20"]])
    assert got == want
    assert len(got.decode().splitlines()) == 1 + 62 * 4


def test_sweep_schedule_matches_jax():
    assert driver.reference_sweep_schedule() == \
        jax_driver.reference_sweep_schedule()


def test_missing_fasta_stderr_bytes_identical(tmp_path, capsys):
    missing = str(tmp_path / "nope.fa")
    args = ["--window", "12", "--k", "8"]
    assert jax_driver.main([str(tmp_path / "a.csv"), missing, *args]) == 1
    want = capsys.readouterr().err
    assert driver.main([str(tmp_path / "b.csv"), missing, *args,
                        "--device", "cpu"]) == 1
    assert capsys.readouterr().err == want == \
        f"Unable to open {missing}. \n Exiting...\n"


def test_twelve_genome_csv_byte_identical(tmp_path):
    """12 related genomes: the port's all-pairs takes the device Gram (K5,
    K6), the JAX CLI its host Gram; the CSVs are byte-identical."""
    rng = np.random.default_rng(12)
    base = rng.integers(0, 4, 3000)
    paths = [write_fasta(tmp_path / f"c{i}.fa",
                         [seq(mutate(rng, base, 0.004 * i))])
             for i in range(12)]
    want, got = run_both(tmp_path, paths, [
        ["--window", "20", "--k", "16", "--scale", "10"]])
    assert got == want
    assert len(got.decode().splitlines()) == 1 + 144


def test_more_than_8_genomes_raise(tmp_path, fastas, monkeypatch):
    """Past the blocked schedule's device budget the CLI takes the
    out-of-core schedule and writes the JAX CLI's CSV bytes (the name is
    kept from when this case raised)."""
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.models import fracminhash
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs
    monkeypatch.setattr(fracminhash, "ONDEVICE_MAX_GENOMES", 8)
    monkeypatch.setattr(allpairs, "CACHE_BUDGET_BYTES", 1 << 10)
    observability.reset_counters()
    want, got = run_both(tmp_path, fastas * 3, [["--window", "12", "--k",
                                                 "8"]])
    assert got == want
    assert observability.counters()["blocked_presorts"] == 1


def test_cuda_device_without_gpu_raises(tmp_path, fastas, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        driver.main([str(tmp_path / "o.csv"), *fastas,
                     "--window", "12", "--k", "8"])


def test_port_imports_no_jax():
    code = ("import sys, spaced_kmer_sketching_tpu_torch, "
            "spaced_kmer_sketching_tpu_torch.driver; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
