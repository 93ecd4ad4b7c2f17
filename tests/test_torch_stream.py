"""The port's streaming path (BASELINE config 5) and kernel K7 against the
JAX package and the oracle.

The port runs on the CPU, where K7's wrapper takes its plain PyTorch
version; the JAX functions run their Pallas kernels in interpret mode.
Inputs are made from a seed with numpy.  Tolerance 0: keys and counts are
integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher)
from spaced_kmer_sketching_tpu.ops import sketch as jax_sketch
from spaced_kmer_sketching_tpu.ops.pallas import extract as jax_extract
from spaced_kmer_sketching_tpu.utils import boosthash
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher)
from spaced_kmer_sketching_tpu_torch.ops import sketch as t_sketch
from spaced_kmer_sketching_tpu_torch.ops.cuda import extract as t_extract
from spaced_kmer_sketching_tpu_torch.utils import native

from oracle import oracle_sketch


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def raw_inputs(seed, g, n, bounds_per_genome, rid0s, vlens, k):
    """Packed bodies of random codes (past each genome's vlen too: K7 must
    not read them), bounds padded with the body length."""
    rng = np.random.default_rng(seed)
    body = t_extract.packed_body(n)
    codes = rng.integers(0, 4, (g, body)).astype(np.uint8)
    p = t_extract.pack2bit_rows(codes)
    bounds = np.full((g, k), body, np.int32)
    for i, b in enumerate(bounds_per_genome):
        bounds[i, :len(b)] = b
    return (p, bounds, np.asarray(rid0s, np.int32),
            np.asarray(vlens, np.int32))


@pytest.mark.parametrize("window,k", [(10, 10), (17, 10), (32, 20),
                                      (33, 21), (48, 30), (64, 40)])
def test_k7_plain_matches_jax_raw_kernel(window, k):
    """K7's plain version against the JAX extract_compact_windows_raw: rid0
    > 0, bounds at a window's first and last code and at vlen's edge."""
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    n = 6000
    p, bounds, rid0, vlen = raw_inputs(
        window, 2, n, [[1, 100, 100 + window - 1, 2000, 2001, 5700],
                       [window, 3000, 5990 - window]],
        [7, 3], [5990, n], 8)
    nw = n - window + 1
    kw = t_sketch.finish_words(window)
    args = dict(nw=nw, window=window, scale=3, variant="modern",
                k_slots=64, out_words=kw)
    words, rowcnt, _ = jax_extract.extract_compact_windows_raw(
        jnp.asarray(p), jnp.asarray(bounds), jnp.asarray(rid0),
        jnp.asarray(vlen), jnp.asarray(mask.words_u32), salt=salt,
        interpret=True, **args)
    planes, cnt = t_extract.extract_compact_raw(
        t32(p), torch.from_numpy(bounds), torch.from_numpy(rid0),
        torch.from_numpy(vlen), mask.words_u32, salt, **args)
    for q in range(kw):
        np.testing.assert_array_equal(planes[q].numpy().view(np.uint32),
                                      np.asarray(words[q]))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rowcnt))
    assert cnt.sum() > 1000


def test_k7_bounds_are_the_run_id_plane():
    """K7's run ids: rid0 + #(bounds <= t) below vlen, -1 from vlen on;
    the body-length padding never counts."""
    bounds = torch.tensor([[3, 5, 12, 12], [12, 12, 12, 12]],
                          dtype=torch.int32)
    rid = t_extract.run_ids_from_bounds(
        bounds, torch.tensor([7, 0], dtype=torch.int32),
        torch.tensor([9, 12], dtype=torch.int32), 12)
    assert rid.tolist() == [[7, 7, 7, 8, 8, 9, 9, 9, 9, -1, -1, -1],
                            [0] * 12]


@pytest.mark.parametrize("window,scale,cap", [(20, 200, 1024),
                                              (40, 20, 8192)])
def test_sketch_batch_compact_matches_jax(window, scale, cap):
    """The compact sketch step (K7 + finish) against the JAX step in
    interpret mode: keys, count and raw_kept."""
    mask = spaced_seed_mask(window, 16, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    n = 70000
    p, bounds, rid0, vlen = raw_inputs(
        scale, 2, n, [[2000, 39999], [10, 11, 50000]], [5, 0], [n, 66000],
        64)
    args = dict(n=n, window=window, scale=scale, variant="modern",
                capacity=cap)
    want = jax_sketch.sketch_batch_compact(
        jnp.asarray(p), jnp.asarray(bounds), jnp.asarray(rid0),
        jnp.asarray(vlen), jnp.asarray(mask.words_u32), salt=salt,
        interpret=True, **args)
    got = t_sketch.sketch_batch_compact(
        t32(p), torch.from_numpy(bounds), torch.from_numpy(rid0),
        torch.from_numpy(vlen), mask.words_u32, salt, **args)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.raw_kept.numpy(),
                                  np.asarray(want.raw_kept))
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint32),
                                  np.asarray(want.keys))
    assert (got.count.numpy() > 100).all()


def random_sketches(rng, s, cap, pool_n, counts, words=4):
    """s sorted-unique (cap, 4) uint32 sketches drawn from one pool, all-ones
    padded past their counts."""
    pool = np.unique(rng.integers(0, 1 << 62, pool_n, dtype=np.int64)
                     .astype(np.uint64))
    keys = np.full((s, cap, 4), 0xFFFFFFFF, np.uint32)
    for i, c in enumerate(counts):
        v = np.sort(rng.choice(pool, c, replace=False))
        keys[i, :c, 0] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        keys[i, :c, 1] = (v >> np.uint64(32)).astype(np.uint32)
        keys[i, :c, 2:] = 0
        keys[i, :c, 2:words] = rng.integers(0, 3, (1, words - 2))
    return keys


@pytest.mark.parametrize("s,cap,counts,capacity,kw", [
    (2, 256, [200, 150], 512, 2),          # S * cut = 512 < 1024: padded
    (4, 512, [500, 0, 311, 512], 2048, 4),
    (8, 256, [256] * 8, 1024, 4),          # cut to a smaller capacity
])
def test_merge_sketches_matches_jax(s, cap, counts, capacity, kw):
    rng = np.random.default_rng(s * cap)
    keys = random_sketches(rng, s, cap, 900, counts, words=kw)
    cnt = np.asarray(counts, np.int32)
    want = jax_sketch.merge_sketches(jnp.asarray(keys), jnp.asarray(cnt),
                                     capacity)
    got = t_sketch.merge_sketches(t32(keys), torch.from_numpy(cnt), capacity,
                                  kw=kw)
    assert int(got.count) == int(want.count) > 0
    assert int(got.raw_kept) == int(want.raw_kept) == cnt.sum()
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint32),
                                  np.asarray(want.keys))


def chromosome(tmp_path, seed=23, name="g.fa", length=30000):
    """A two-record FASTA with an N-gap: run ends inside segments."""
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, length))
    seq = seq[:9000] + "NN" + seq[9000:]
    p = tmp_path / name
    p.write_text(f">a\n{seq[:20000]}\n>b\n{seq[20000:]}\n")
    return str(p)


def test_streaming_matches_jax_streaming_and_whole_file(tmp_path):
    """sketch_file_streaming against the JAX sketch_file_streaming and
    sketch_file, across chunk-boundary windows, run splits and records;
    12000 gives 3 segments (a padded merge stack)."""
    path = chromosome(tmp_path)
    cfg = dict(window=20, k=16, scale=20)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    jsk = JaxSketcher(JaxConfig(**cfg))
    whole = jsk.sketch_file(path)
    for segment in (1 << 12, 12000, 1 << 14):
        got = port.sketch_file_streaming(path, segment_nt=segment)
        want = jsk.sketch_file_streaming(path, segment_nt=segment)
        assert got.count == want.count == whole.count, segment
        np.testing.assert_array_equal(got.keys, want.keys)
        np.testing.assert_array_equal(got.keys, whole.keys)


def test_streaming_segments_of_many_runs_take_k7(tmp_path, monkeypatch):
    """Every segment takes the compact dispatch (K7), whatever its number
    of runs: ~150 runs of 3-60 codes a segment, so run starts fall inside
    the carry, on segment edges and within a window of them.  Equal to the
    JAX whole-file sketch."""
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 12000))
    cuts = np.cumsum(rng.integers(3, 61, 600))
    cuts = [0, *cuts[cuts < 12000].tolist(), 12000]
    seq = "N".join(seq[a:b] for a, b in zip(cuts, cuts[1:]))
    path = str(tmp_path / "runs.fa")
    open(path, "w").write(f">r\n{seq}\n")
    cfg = dict(window=16, k=12, scale=7)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    want = JaxSketcher(JaxConfig(**cfg)).sketch_file(path)
    calls = []
    orig = port._dispatch_sketch_compact
    monkeypatch.setattr(port, "_dispatch_sketch_compact", lambda *a: (
        calls.append(a[1].size), orig(*a))[1])
    monkeypatch.setattr(port, "_dispatch_sketch", None)
    for segment, runs in ((5000, 64), (997, 16)):
        calls.clear()
        got = port.sketch_file_streaming(path, segment_nt=segment)
        assert len(calls) == -(-12000 // segment) and max(calls) > runs
        assert got.count == want.count
        np.testing.assert_array_equal(got.keys, want.keys)


def test_sketch_files_streams_big_files_in_order(tmp_path, monkeypatch):
    """Files at the threshold stream inside sketch_files; the output keeps
    the order of `paths` and equals the whole-file sketches."""
    big = chromosome(tmp_path, 29, "big.fa")
    small = chromosome(tmp_path, 30, "small.fa", 25000)
    port = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=20),
                               device="cpu")
    want = port.sketch_files([small, big])
    monkeypatch.setattr(FracMinHashSketcher, "_STREAM_THRESHOLD_BYTES",
                        len(open(big).read()) - 5)
    streamed = []
    orig = port.sketch_file_streaming
    monkeypatch.setattr(port, "sketch_file_streaming",
                        lambda p, **kw: (streamed.append(p), orig(p, **kw))[1])
    got = port.sketch_files([small, big])
    assert streamed == [big]
    assert [s.name for s in got] == [small, big]
    for a, b in zip(got, want):
        assert a.count == b.count
        np.testing.assert_array_equal(a.keys, b.keys)


def test_without_native_big_files_take_the_whole_file_path(tmp_path,
                                                           monkeypatch):
    """Without the native library nothing streams (the parser is native):
    big files go through read_fasta's Python parser, as in JAX."""
    path = chromosome(tmp_path)
    port = FracMinHashSketcher(SketchConfig(window=20, k=16, scale=20),
                               device="cpu")
    want = JaxSketcher(JaxConfig(window=20, k=16, scale=20)).sketch_file(path)
    monkeypatch.setattr(FracMinHashSketcher, "_STREAM_THRESHOLD_BYTES", 64)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(port, "sketch_file_streaming", None)
    got, = port.sketch_files([path])
    assert got.count == want.count
    np.testing.assert_array_equal(got.keys, want.keys)


def test_streaming_overflow_retry_matches_oracle(tmp_path):
    """A small fixed capacity overflows every segment: each is re-sketched
    alone at a larger capacity, and the merged sketch equals the oracle's."""
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, 9000)
    text = "".join("ACGT"[c] for c in codes)
    path = tmp_path / "o.fa"
    path.write_text(f">o\n{text[:4000]}N{text[4001:]}\n")
    cfg = SketchConfig(window=14, k=9, scale=4, sketch_capacity=256)
    port = FracMinHashSketcher(cfg, device="cpu")
    got = port.sketch_file_streaming(str(path), segment_nt=3000)
    assert got.count > 256
    salt = boosthash.fmh_salt(port.mask.lo, port.mask.hi, 14, 1, "modern")
    runs = [list(codes[:4000]), list(codes[4001:])]
    ints = [int(a) | int(b) << 32 | int(c) << 64 | int(d) << 96
            for a, b, c, d in got.keys.astype(object)]
    assert ints == sorted(ints)
    assert set(ints) == oracle_sketch(runs, port.mask.value, 14, salt, 4)


def test_sketch_files_on_error_skip_matches_jax(tmp_path, caplog):
    """on_error='skip' turns an unreadable file into an empty sketch and a
    log line, streamed or not, as the JAX sketcher does; 'raise' raises."""
    good = chromosome(tmp_path)
    missing = str(tmp_path / "missing.fa")
    cfg = dict(window=20, k=16, scale=20)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    want = JaxSketcher(JaxConfig(**cfg)).sketch_files([missing, good],
                                                      on_error="skip")
    got = port.sketch_files([missing, good], on_error="skip")
    assert [s.count for s in got] == [s.count for s in want]
    assert got[0].count == 0 and got[0].name == missing
    np.testing.assert_array_equal(got[1].keys, want[1].keys)
    assert "skipping unreadable genome" in caplog.text
    with pytest.raises(FileNotFoundError):
        port.sketch_files([missing, good])
    with pytest.raises(ValueError, match="on_error"):
        port.sketch_files([good], on_error="ignore")

    def broken(p, **kw):
        raise OSError(f"cannot stream {p}")
    port.sketch_file_streaming = broken
    port._STREAM_THRESHOLD_BYTES = 64
    got = port.sketch_files([good], on_error="skip")
    assert got[0].count == 0 and got[0].name == good
    with pytest.raises(OSError):
        port.sketch_files([good])


def test_native_stream_chunks_rebuild_read_fasta(tmp_path):
    """The port's fasta_stream binding: chunks concatenate to read_fasta's
    codes and run lengths."""
    path = chromosome(tmp_path)
    whole = read_fasta(path)
    codes, lens, prev_open = [], [], False
    for c, run_ends, open_run in native.fasta_stream(path, 7000):
        b = [0] + run_ends.tolist() + [c.size]
        segs = [b[i + 1] - b[i] for i in range(len(b) - 1)]
        if prev_open and lens:
            lens[-1] += segs.pop(0)
        lens.extend(segs)
        codes.append(c)
        prev_open = open_run
    np.testing.assert_array_equal(np.concatenate(codes), whole.codes)
    assert [x for x in lens if x] == whole.run_lens.tolist()
