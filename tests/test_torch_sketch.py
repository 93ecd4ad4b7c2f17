"""The port's sketch step and sketcher against the JAX package and the oracle.

The port runs on the CPU, where every kernel wrapper takes its plain
PyTorch version; the JAX step runs its Pallas kernels in interpret mode.
Inputs are made from a seed with numpy.  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.ingest.fasta import PackedSeqs as JaxPacked
from spaced_kmer_sketching_tpu.models.fracminhash import (
    FracMinHashSketcher as JaxSketcher, Sketch as JaxSketch)
from spaced_kmer_sketching_tpu.ops import sketch as jax_sketch
from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
from spaced_kmer_sketching_tpu.ops.pallas import sort as jax_sort
from spaced_kmer_sketching_tpu.ops.pallas.extract import pack_genomes_np
from spaced_kmer_sketching_tpu.utils import boosthash
from spaced_kmer_sketching_tpu.utils.masks import spaced_seed_mask

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.ingest.fasta import PackedSeqs
from spaced_kmer_sketching_tpu_torch.models import fracminhash
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher, Sketch)
from spaced_kmer_sketching_tpu_torch.ops import sketch as t_sketch
from spaced_kmer_sketching_tpu_torch.ops import u64ops
from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import (out_rows,
                                                              pack2bit_rows)

from oracle import oracle_sketch


def run_dyn(g, n, cap, scale, window, k, variant, runs, seed, rid=None):
    """The dyn-window sketch step through both packages; `runs` are run
    lengths from position 0, or `rid` the (g, n) run-id plane."""
    mask = spaced_seed_mask(window, k, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, variant)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (g, n)).astype(np.uint32)
    if rid is None:
        rid = np.stack([run_ids_from_lens(runs, n)] * g)
    kw = t_sketch.finish_words(window)
    qc, qr, r = pack_genomes_np(codes, rid)
    want = jax_sketch.sketch_batch_packed_dyn(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(r),
        jnp.asarray(mask.words_u32), jnp.asarray(u64ops.salt_pair(salt)),
        jnp.asarray([window], np.uint32), n=n, kw=kw, scale=scale,
        variant=variant, capacity=cap, interpret=True)
    packed = torch.from_numpy(pack2bit_rows(codes.astype(np.uint8))
                              .view(np.int32))
    got = t_sketch.sketch_batch_packed_dyn(
        packed, torch.from_numpy(rid), mask.words_u32, salt, window, n=n,
        kw=kw, scale=scale, variant=variant, capacity=cap)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.raw_kept.numpy(),
                                  np.asarray(want.raw_kept))
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint32),
                                  np.asarray(want.keys))
    return got


def test_dyn_step_tree_finish_matches_jax():
    """Two K1 blocks; the planner chains two K2 stages, so the finish runs
    K2, K3 and K4 exactly as the JAX `_finish_tree` does."""
    g, n, cap, scale, window = 2, 65536, 4096, 50, 20
    kw = t_sketch.finish_words(window)
    nw_prog = n - (16 * (kw - 1) + 1) + 1
    k_slots = t_sketch._k_slots_for(nw_prog, scale, cap)
    m = (nw_prog + 32767) // 32768 * 256 * k_slots
    assert t_sketch._tree_chain(m, 128.0 / k_slots, scale, cap, g) == \
        [(128, 64), (64, 64)]
    got = run_dyn(g, n, cap, scale, window, 16, "modern",
                  [20000, 30000, n - 50100], seed=1)
    assert (got.count.numpy() > 1000).all()


@pytest.mark.parametrize("window,k,variant", [(10, 10, "modern"),
                                              (20, 16, "legacy"),
                                              (33, 25, "modern"),
                                              (64, 40, "modern")])
def test_dyn_step_sort_all_finish_matches_jax(window, k, variant):
    """The shape of the JAX package's shared-program test: no chain is
    planned, so the port's sort-everything finish is held against the JAX
    `_finish_candidates`."""
    g, n, cap, scale = 3, 4096, 1024, 20
    kw = t_sketch.finish_words(window)
    nw_prog = n - (16 * (kw - 1) + 1) + 1
    k_slots = t_sketch._k_slots_for(nw_prog, scale, cap)
    m = (nw_prog + 32767) // 32768 * 256 * k_slots
    assert t_sketch._tree_chain(m, 128.0 / k_slots, scale, cap, g) is None
    assert t_sketch.finish_route(m, nw_prog, k_slots, cap, scale, g) == \
        "sort"
    run_dyn(g, n, cap, scale, window, k, variant, [1500, 900, n - 2400],
            seed=window)


def route_of(n, window, scale, cap, g):
    """(m, nw_prog, k_slots) of the dyn step, and the port's route."""
    kw = t_sketch.finish_words(window)
    nw_prog = n - (16 * (kw - 1) + 1) + 1
    k_slots = t_sketch._k_slots_for(nw_prog, scale, cap)
    m = out_rows(nw_prog) * k_slots
    return m, nw_prog, k_slots, t_sketch.finish_route(m, nw_prog, k_slots,
                                                      cap, scale, g)


def test_finish_runs_fault_is_fixed():
    """The fault the port had: this input takes the JAX `_finish_runs`
    (K8), whose first block holds more kept keys than its share of 256,
    and the JAX step reports raw_kept 513 and count 257.  The port sent
    the shape to its sort-everything finish (raw_kept 341, count 341,
    other keys); it now routes as JAX does and gives the same keys, count
    and raw_kept."""
    n, cap, scale, window = 65536, 512, 100, 20
    assert route_of(n, window, scale, cap, 1)[3] == "runs"
    got = run_dyn(1, n, cap, scale, window, 16, "modern", [32000], seed=1)
    assert int(got.raw_kept[0]) == 513 and int(got.count[0]) == 257


@pytest.fixture
def jax_k9_interpret(monkeypatch):
    """The JAX tiled `_finish_candidates` calls sort_truncate_128 without
    its interpret flag; on the CPU backend it runs only in interpret mode."""
    orig = jax_sort.sort_truncate_128
    monkeypatch.setattr(jax_sort, "sort_truncate_128",
                        lambda keys, capacity: orig(keys, capacity,
                                                    interpret=True))


@pytest.mark.parametrize("sparse", [True, False])
def test_tiled_finish_matches_jax(jax_k9_interpret, sparse):
    """Two tiles of 32,768 candidates (n = 2^19, k_slots 16, capacity
    512): the JAX tiled `_finish_candidates` (K9).  Sparse: two short runs,
    one in each tile, and no tile exceeds its share; dense: one run over
    the whole genome, both tiles overflow and raw_kept says so."""
    n, cap, scale, window = 1 << 19, 512, 100, 20
    assert route_of(n, window, scale, cap, 1)[3] == "tiled"
    rid = np.full((1, n), -1, np.int32)
    if sparse:
        rid[0, :15000] = 0
        rid[0, 300000:318000] = 1
    else:
        rid[0, :] = 0
    got = run_dyn(1, n, cap, scale, window, 16, "modern", None, seed=2,
                  rid=rid)
    assert (int(got.raw_kept[0]) > cap) != sparse


def jax_route(m, nw, k_slots, cap, scale, g, kw):
    """The route the JAX `_finish_dispatch` takes for these shapes: the
    finishes are replaced by recorders and traced abstractly."""
    seen = []

    def dummy(shape):
        return jax_sketch.SketchBatch(
            keys=jnp.zeros(shape + (cap, 4), jnp.uint32),
            count=jnp.zeros(shape, jnp.int32),
            raw_kept=jnp.zeros(shape, jnp.int32))

    def tree(*a, **k):
        seen.append("tree")
        return dummy((g,))

    def runs(*a, **k):
        seen.append("runs")
        return dummy(())

    def tiled(keys, capacity):
        seen.append("tiled")
        return jnp.zeros((capacity, keys.shape[1]), jnp.uint32)

    def sort_rows(words, extra=()):
        seen.append("sort")
        return list(words), ()

    patches = [(jax_sketch, "_finish_tree", tree),
               (jax_sketch, "_finish_runs", runs),
               (jax_sort, "sort_truncate_128", tiled),
               (jax_sketch, "_sort_rows", sort_rows)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        words = [jax.ShapeDtypeStruct((g, m), jnp.uint32)] * kw
        rowcnt = jax.ShapeDtypeStruct((g, m // k_slots), jnp.int32)
        jax.eval_shape(lambda w, r: jax_sketch._finish_dispatch(
            w, r, nw, k_slots, cap, scale, True), words, rowcnt)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return seen[0]


@pytest.mark.parametrize("n,window,scale,cap,g,route", [
    (8388608, 20, 200, 65536, 8, "tree"),   # config 1: E. coli-sized
    (8388608, 50, 200, 65536, 2, "tree"),
    (4194304, 16, 200, 32768, 4, "tree"),
    (65536, 20, 50, 4096, 2, "tree"),
    (16384, 12, 5, 8192, 3, "tree"),
    (65536, 20, 100, 512, 1, "runs"),       # the fault's input
    (65536, 20, 200, 512, 8, "runs"),       # phage lambda, capacity 512
    (4096, 20, 20, 1024, 3, "sort"),
    (524288, 20, 100, 512, 1, "tiled"),
    (2097152, 20, 200, 2048, 1, "tiled"),   # 2 Mnt, capacity 2048
    (8388608, 20, 200, 8192, 1, "tiled"),
])
def test_planner_matches_jax(n, window, scale, cap, g, route):
    """The port keeps the JAX planner's shapes: key words, slots, the
    compaction chain and its decision, and the finish route, so
    intermediates line up."""
    kw = t_sketch.finish_words(window)
    assert kw == jax_sketch.finish_words(window)
    nw_prog = n - (16 * (kw - 1) + 1) + 1
    k_slots = t_sketch._k_slots_for(nw_prog, scale, cap)
    assert k_slots == jax_sketch._k_slots_for(nw_prog, scale, cap)
    assert t_sketch.slots_for_scale(scale) == \
        jax_sketch.slots_for_scale(scale)
    m = (nw_prog + 32767) // 32768 * 256 * k_slots
    assert t_sketch._tree_chain(m, 128.0 / k_slots, scale, cap, g) == \
        jax_sketch._tree_chain(m, 128.0 / k_slots, scale, cap, g)
    assert t_sketch.finish_route(m, nw_prog, k_slots, cap, scale, g) == \
        jax_route(m, nw_prog, k_slots, cap, scale, g, kw) == route


def packed_genomes(seed):
    """Three genomes in two size buckets, with several runs each."""
    rng = np.random.default_rng(seed)
    out = []
    for lens in ([3000, 5, 2500], [9000], [20000, 1200]):
        codes = rng.integers(0, 4, sum(lens)).astype(np.uint8)
        out.append((codes, np.asarray(lens, np.int64)))
    return out


def split_runs(codes, lens):
    runs, pos = [], 0
    for ln in lens:
        runs.append([int(c) for c in codes[pos:pos + int(ln)]])
        pos += int(ln)
    return runs


def keys_as_ints(sketch):
    k = sketch.keys.astype(object)
    return [int(a) | int(b) << 32 | int(c) << 64 | int(d) << 96
            for a, b, c, d in k]


@pytest.mark.parametrize("window,k,scale,variant", [(14, 9, 4, "modern"),
                                                    (36, 20, 6, "legacy")])
def test_sketcher_matches_jax_and_oracle(window, k, scale, variant):
    genomes = packed_genomes(window)
    cfg = dict(window=window, k=k, scale=scale, hash_variant=variant)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    got = port.sketch_packed_batch([PackedSeqs(c, lens)
                                    for c, lens in genomes])
    want = JaxSketcher(JaxConfig(**cfg)).sketch_packed_batch(
        [JaxPacked(c, lens) for c, lens in genomes])
    salt = boosthash.fmh_salt(port.mask.lo, port.mask.hi, window, 1, variant)
    for (c, lens), a, b in zip(genomes, got, want):
        assert a.count == b.count > 0
        np.testing.assert_array_equal(a.keys, b.keys)
        ints = keys_as_ints(a)
        assert ints == sorted(ints)
        assert set(ints) == oracle_sketch(split_runs(c, lens),
                                          port.mask.value, window, salt,
                                          scale, variant)


def test_overflow_retry_matches_jax():
    """A fixed small capacity forces the per-genome overflow retry; the
    retried sketch equals the oracle's and the JAX sketcher's at a capacity
    that needs no retry (the JAX retry splice writes into a read-only
    array on the CPU, so its own retry cannot be the reference)."""
    rng = np.random.default_rng(23)
    genomes = [(rng.integers(0, 4, 5000).astype(np.uint8),
                np.array([5000], np.int64)),
               (rng.integers(0, 4, 600).astype(np.uint8),
                np.array([600], np.int64))]
    cfg = dict(window=14, k=9, scale=4, sketch_capacity=256)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    packed = [PackedSeqs(c, lens) for c, lens in genomes]
    first = port._dispatch_sketch(packed, 16384, 256)[0]
    raws = first.raw_kept.numpy()
    assert raws[0] > 256 >= raws[1]          # only genome 0 overflows
    got = port.sketch_packed_batch(packed)
    want = JaxSketcher(JaxConfig(**dict(cfg, sketch_capacity=0))) \
        .sketch_packed_batch([JaxPacked(c, lens) for c, lens in genomes])
    assert got[0].count > 256
    salt = boosthash.fmh_salt(port.mask.lo, port.mask.hi, 14, 1, "modern")
    for (c, lens), a, b in zip(genomes, got, want):
        assert a.count == b.count
        np.testing.assert_array_equal(a.keys, b.keys)
        assert set(keys_as_ints(a)) == oracle_sketch(
            split_runs(c, lens), port.mask.value, 14, salt, 4)


def test_sketch_npz_is_the_jax_format(tmp_path):
    """A sketch the JAX package saved loads in the port and compares equal
    to the port's own sketch of the same genome, and the other way round."""
    (c, lens), = packed_genomes(5)[:1]
    cfg = dict(window=20, k=16, scale=5)
    jax_sk = JaxSketcher(JaxConfig(**cfg)).sketch_packed(JaxPacked(c, lens),
                                                         name="g0")
    port_sk = FracMinHashSketcher(SketchConfig(**cfg), device="cpu") \
        .sketch_packed(PackedSeqs(c, lens), name="g0")
    jax_sk.save(str(tmp_path / "jax.npz"))
    loaded = Sketch.load(str(tmp_path / "jax.npz"))
    assert (loaded.count, loaded.window, loaded.mask, loaded.name) == \
        (port_sk.count, port_sk.window, port_sk.mask, port_sk.name)
    np.testing.assert_array_equal(loaded.keys, port_sk.keys)
    port_sk.save(str(tmp_path / "port.npz"))
    back = JaxSketch.load(str(tmp_path / "port.npz"))
    assert back.count == jax_sk.count and back.mask == jax_sk.mask
    np.testing.assert_array_equal(back.keys, jax_sk.keys)


def test_all_pairs_matches_jax():
    genomes = packed_genomes(8)
    cfg = dict(window=12, k=8, scale=3)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    got = port.all_pairs_intersections(port.sketch_packed_batch(
        [PackedSeqs(c, lens) for c, lens in genomes]))
    jsk = JaxSketcher(JaxConfig(**cfg))
    want = jsk.all_pairs_intersections(jsk.sketch_packed_batch(
        [JaxPacked(c, lens) for c, lens in genomes]))
    np.testing.assert_array_equal(got, want)


def related_genomes(seed, g):
    """g genomes related as a collection is: substituted copies (0-5%) of
    one 6-kb ancestor, two runs each."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 6000).astype(np.uint8)
    out = []
    for i in range(g):
        codes = base.copy()
        hit = rng.random(codes.size) < 0.05 * i / g
        codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        out.append((codes, np.array([2500, 3500], np.int64)))
    return out


def test_all_pairs_12_related_genomes_matches_jax():
    """G = 12 takes the device Gram (plain K5/K6 on the CPU) in the port
    and the host Gram in the JAX package: the matrices are equal."""
    genomes = related_genomes(12, 12)
    cfg = dict(window=12, k=8, scale=3)
    port = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    got = port.all_pairs_intersections(port.sketch_packed_batch(
        [PackedSeqs(c, lens) for c, lens in genomes]))
    jsk = JaxSketcher(JaxConfig(**cfg))
    want = jsk.all_pairs_intersections(jsk.sketch_packed_batch(
        [JaxPacked(c, lens) for c, lens in genomes]))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all() and (got[0] < got[0, 0]).sum() > 6


def test_more_than_8_genomes_needs_k5_k6(monkeypatch):
    """More than 8 genomes go through the device Gram (K5, K6; their plain
    versions on the CPU), empty sketches included; past the blocked
    schedule's device budget the sketcher takes the out-of-core
    schedule."""
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs
    sk = FracMinHashSketcher(SketchConfig(window=12, k=8), device="cpu")
    empty = Sketch(keys=np.empty((0, 4), np.uint32), count=0, window=12,
                   mask=sk.mask)
    np.testing.assert_array_equal(sk.all_pairs_intersections([empty] * 9),
                                  np.zeros((9, 9), np.int32))
    monkeypatch.setattr(fracminhash, "ONDEVICE_MAX_GENOMES", 8)
    monkeypatch.setattr(allpairs, "CACHE_BUDGET_BYTES", 1 << 10)
    observability.reset_counters()
    np.testing.assert_array_equal(sk.all_pairs_intersections([empty] * 9),
                                  np.zeros((9, 9), np.int32))
    assert observability.counters()["blocked_presorts"] == 1


def test_streaming_size_files_are_refused(tmp_path, monkeypatch):
    """Streaming-size files are no longer refused: sketch_files streams
    them (sketch_file_streaming), and the sketch is the whole-file one."""
    rng = np.random.default_rng(7)
    path = tmp_path / "big.fa"
    path.write_text(">r\n" + "".join("ACGT"[c] for c in
                                     rng.integers(0, 4, 3000)) + "\n")
    sk = FracMinHashSketcher(SketchConfig(window=12, k=8, scale=5),
                             device="cpu")
    want, = sk.sketch_files([str(path)])
    monkeypatch.setattr(FracMinHashSketcher, "_STREAM_THRESHOLD_BYTES", 64)
    streamed = []
    orig = sk.sketch_file_streaming
    monkeypatch.setattr(sk, "sketch_file_streaming", lambda p, **kw: (
        streamed.append(p), orig(p, segment_nt=1000, **kw))[1])
    got, = sk.sketch_files([str(path)])
    assert streamed == [str(path)]
    assert got.count == want.count > 100
    np.testing.assert_array_equal(got.keys, want.keys)


def test_cuda_device_without_gpu_raises(monkeypatch):
    """The default device is cuda; without a GPU the sketcher raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FracMinHashSketcher(SketchConfig(window=12, k=8))
    assert fracminhash.resolve_device("cpu").type == "cpu"
