"""The data makers: one seed gives the same bytes twice, two seeds give
different bytes, and the collection has the structure its spec states."""
import numpy as np
import torch

from benchmark import data, reference

PAIR = {"length_nt": 5000, "substitution": 0.03}
COLLECTION = {"count": 300, "length_nt": 4000, "species": 20,
              "zipf_exponent": 1.0, "substitution": [0.002, 0.02]}


def _bytes(paths):
    return [open(p, "rb").read() for p in paths]


def test_fasta_maker_repeats_by_seed(tmp_path):
    runs = []
    for i, seed in enumerate((2 ** 31 + 5, 2 ** 31 + 5, 11)):
        d = tmp_path / f"pair{i}"
        d.mkdir()
        runs.append(_bytes(data.write_genomes(d, seed, PAIR)))
    assert runs[0] == runs[1]
    assert all(a != b for a, b in zip(runs[0], runs[2]))


def test_pair_is_a_substituted_copy(tmp_path):
    paths = data.write_genomes(tmp_path, 4, PAIR)
    seqs = []
    for p in paths:
        text = open(p, "rb").read()
        assert text.count(b">") == 3 and text.count(b"N") >= 30
        seqs.append(np.frombuffer(b"".join(
            line for line in text.split(b"\n") if not line.startswith(b">")),
            np.uint8))
    a, b = seqs
    assert a.size == b.size == 5000
    both = (a != ord("N")) & (b != ord("N"))
    assert 0.015 < np.mean(a[both] != b[both]) < 0.045


def test_device_collection_repeats_by_seed():
    words = 256
    one, sp1 = data.device_collection(COLLECTION, 9, words, "cpu", batch=64)
    two, sp2 = data.device_collection(COLLECTION, 9, words, "cpu", batch=64)
    other, _ = data.device_collection(COLLECTION, 10, words, "cpu", batch=64)
    assert one.dtype == torch.int32 and one.shape == (300, words)
    assert torch.equal(one, two) and np.array_equal(sp1, sp2)
    assert not torch.equal(one, other)


def test_device_collection_structure():
    words, n = 256, COLLECTION["length_nt"]
    genomes, species_of = data.device_collection(COLLECTION, 3, words, "cpu",
                                                 batch=64)
    sizes = np.bincount(species_of)
    np.testing.assert_array_equal(sizes, data.species_sizes(300, 20, 1.0))
    codes = np.stack([reference.unpack_2bit(w, n)
                      for w in genomes.numpy()])
    big = np.flatnonzero(species_of == 0)
    diff = np.mean(codes[big[0]] != codes[big[1]])
    assert 0.0 < diff < 0.045                      # two members: <= 2% each
    far = np.flatnonzero(species_of == 1)[0]
    assert np.mean(codes[big[0]] != codes[far]) > 0.7   # random roots


def test_species_sizes():
    s = data.species_sizes(10240, 1024, 1.0)
    assert s.sum() == 10240 and s.min() >= 1
    assert np.all(np.diff(s) <= 0)
    assert s[0] == 1364                    # 10,240 / H(1024)
    assert data.species_sizes(10, 10, 1.0).tolist() == [1] * 10


def test_sample_genomes():
    _, species_of = data.device_collection(COLLECTION, 3, 256, "cpu")
    s = data.sample_genomes(5, species_of, 16, block=16)
    assert len(set(s.tolist())) == 16
    assert np.array_equal(s, data.sample_genomes(5, species_of, 16,
                                                 block=16))
    assert not np.array_equal(s, data.sample_genomes(6, species_of, 16,
                                                     block=16))
    sp = species_of[s]
    assert len(sp) - len(set(sp.tolist())) >= 4     # related members in it
    assert len(set((s // 16).tolist())) == 16       # one a block of 16


def test_sample_genomes_always_holds_the_given_genomes():
    _, species_of = data.device_collection(COLLECTION, 3, 256, "cpu")
    s = data.sample_genomes(5, species_of, 16, always=[7, 299, 5000])
    assert {7, 299} <= set(s.tolist()) and len(s) == 16


def _tiny_collection(seed, overflow=(3, 200)):
    import dataclasses

    from benchmark import harness
    cell = harness.load_cell("collection10k.related")
    genomes = dict(cell.config["genomes"], count=256, length_nt=3000,
                   species=40, first_pass_overflow=list(overflow))
    cell = dataclasses.replace(cell, config=dict(cell.config,
                                                 genomes=genomes))
    op = harness.operation(cell, seed, "cpu")
    op.setup()
    return op


def _rows(t):
    return sorted(map(tuple, t.numpy().tolist()))


def test_the_collection_is_one_draw_shuffled_within_blocks():
    """Every seed gets the same genomes in the same blocks; the seed
    shuffles each block's rows, and the check follows the listed
    genomes to their new rows."""
    one, two = _tiny_collection(2 ** 31 + 9), _tiny_collection(12)
    again = _tiny_collection(2 ** 31 + 9)
    assert torch.equal(one.genomes, again.genomes)
    assert not torch.equal(one.genomes, two.genomes)
    for b0 in (0, 128):
        assert _rows(one.genomes[b0:b0 + 128]) == _rows(
            two.genomes[b0:b0 + 128])
    spec = dict(one.cell.genomes)
    drawn, _ = data.device_collection(spec, spec["collection_seed"],
                                      one.genomes.shape[1], "cpu")
    for op in (one, two):
        held = {tuple(op.genomes[i].tolist()) for i in op.sample}
        assert {tuple(drawn[i].tolist()) for i in (3, 200)} <= held
    job = one.job()
    np.testing.assert_array_equal(job["diag"], job["counts"])


def test_the_sweep_check_always_takes_spaced_configs_either_side_of_32():
    import json

    from benchmark import harness
    cfg, traffic = (json.loads((harness.BENCH / d / f).read_text()) for d, f
                    in (("configs", "pair.json"), ("traffic", "sweep62.json")))
    cell = harness.Cell(name="pair.sweep62", config=cfg, traffic=traffic,
                        chips=1, end_to_end=[], per_layer=[],
                        bench=harness.BENCH)
    op = harness.operation(cell, 2 ** 31 + 1, "cpu")
    records = [{"config": i} for i in range(len(op.schedule))] * 2
    for seed in (2 ** 31 + 1, 7, 8):
        op.seed = seed
        got = op.sampled(records)
        assert len(got) == 16 and got == op.sampled(records)
        picked = [op.schedule[i][:2] for i in got]
        assert any(w > k and w > 32 for w, k in picked)
        assert any(k < w <= 32 for w, k in picked)
