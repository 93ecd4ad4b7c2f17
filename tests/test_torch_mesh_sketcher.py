"""The port's MeshSketcher and the all-pairs functions over a mesh
(parallel/sketcher.py, parallel/allpairs.py) against the JAX package's on
the 8 virtual CPU devices of tests/conftest.py.

The port's meshes are CPU slots; a mesh of slots `cpu` and `cpu:0` counts
as two distinct devices, so the replica paths (a cache a device) run too.
Inputs are made from a seed with numpy; every comparison is exact
(tolerance 0), the ANI values too (float32, computed as JAX computes them).
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

from spaced_kmer_sketching_tpu.config import SketchConfig as JaxConfig
from spaced_kmer_sketching_tpu.parallel import mesh as jax_mesh
from spaced_kmer_sketching_tpu.parallel.allpairs import (
    mesh_all_pairs_packed as jax_mesh_all_pairs_packed,
    sharded_ani_fn as jax_sharded_ani_fn)
from spaced_kmer_sketching_tpu.parallel.sketcher import (
    MeshSketcher as JaxMeshSketcher)

from spaced_kmer_sketching_tpu_torch.config import SketchConfig
from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
    FracMinHashSketcher, Sketch)
from spaced_kmer_sketching_tpu_torch.observability import (counters,
                                                           reset_counters)
from spaced_kmer_sketching_tpu_torch.parallel import allpairs
from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
from spaced_kmer_sketching_tpu_torch.parallel.sketcher import MeshSketcher
from test_torch_mesh import one_torch_thread  # noqa: F401

CPU8 = ["cpu"] * 8


def assert_sketches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.count == b.count and a.name == b.name
        np.testing.assert_array_equal(a.keys, np.asarray(b.keys))


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """A 200,000-nt two-record FASTA with N-splits (one near a 2^16-code
    segment edge) and three short ones cut from it."""
    d = tmp_path_factory.mktemp("mesh_sketcher")
    rng = np.random.default_rng(23)
    n = 200_000
    chars = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for pos in (1234, 65_530, 65_540, 150_001):
        chars[pos] = ord("N")
    body = chars.tobytes().decode()
    big = d / "big.fa"
    big.write_text(f">r0\n{body[:100_000]}\n>r1\n{body[100_000:]}\n")
    paths = [str(big)]
    for i, (a, b) in enumerate([(0, 3000), (5000, 9500), (20_000, 21_000)]):
        p = d / f"s{i}.fa"
        p.write_text(f">s{i}\n{body[a:b]}\n")
        paths.append(str(p))
    return paths


def test_sketch_files_matches_jax_mesh_sketcher(fastas, monkeypatch):
    """MeshSketcher.sketch_files on a 2 x 4 mesh == JAX's MeshSketcher on
    make_mesh((2, 4)), with the streaming threshold lowered (the big file
    streams over the ring, 2^16-code segments, as JAX's
    test_mesh_streaming_bitexact_and_routing does): the big file takes
    the ring (K11) and the short ones the sharded batch (K1), whatever
    seq_par_threshold says, as in JAX.  sketch_packed sends a genome past
    seq_par_threshold through the ring, and equals JAX's too."""
    cfg = dict(window=16, k=12, scale=10)
    jsk = JaxMeshSketcher(JaxConfig(**cfg), jax_mesh.make_mesh((2, 4)),
                          seq_par_threshold=4000)
    port = MeshSketcher(SketchConfig(**cfg), make_mesh((2, 4), CPU8),
                        seq_par_threshold=4000)
    for cls in (JaxMeshSketcher, MeshSketcher):
        orig = cls.sketch_file_streaming
        monkeypatch.setattr(cls, "_STREAM_THRESHOLD_BYTES", 50_000)
        monkeypatch.setattr(
            cls, "sketch_file_streaming",
            lambda self, p, segment_nt=1 << 24, name="", orig=orig: orig(
                self, p, segment_nt=1 << 16, name=name))
    ring = []
    seq = MeshSketcher._seq_parallel_batch
    monkeypatch.setattr(MeshSketcher, "_seq_parallel_batch",
                        lambda self, c, *a: (ring.append(c.size),
                                             seq(self, c, *a))[1])
    want = jsk.sketch_files(fastas)
    got = port.sketch_files(fastas)
    assert_sketches_equal(got, want)
    single = FracMinHashSketcher(SketchConfig(**cfg), device="cpu")
    assert_sketches_equal(got[1:], single.sketch_files(fastas[1:]))
    assert len(ring) == 4                  # the big file's four segments
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    packed = read_fasta(fastas[2])         # 4,500 codes
    assert_sketches_equal([port.sketch_packed(packed, name="s1")],
                          [jsk.sketch_packed(packed, name="s1")])
    assert ring[-1] == 4500


def test_each_rank_parses_only_its_rows(fastas, monkeypatch):
    """Rank 0 of a 1 x 2 mesh owned by two ranks: sketch_files parses only
    the rows of the sharded batch that its slot holds (rows 0-1 of the
    4-row batch of 3 files), genomes past seq_par_threshold too, and the
    batch never enters the ring.  The other rank's part of the gather is
    stood in by rank 0's, so row 2 is a placeholder with no windows."""
    from spaced_kmer_sketching_tpu_torch.parallel import sketch as sk_mod
    from spaced_kmer_sketching_tpu_torch.parallel import sketcher as mod
    cfg = SketchConfig(window=16, k=12, scale=10)
    port = MeshSketcher(cfg, mod.Mesh((1, 2), (torch.device("cpu"),) * 2,
                                      (0, 1)), seq_par_threshold=100)
    read, orig = [], mod.read_fasta
    monkeypatch.setattr(mod, "read_fasta",
                        lambda p: (read.append(p), orig(p))[1])
    monkeypatch.setattr(sk_mod, "all_gather", lambda t: [t, t])
    monkeypatch.setattr(MeshSketcher, "_seq_parallel_batch",
                        lambda *a: pytest.fail("the batch took the ring"))
    got = port.sketch_files(fastas[1:])
    assert sorted(read) == sorted(fastas[1:3])
    single = FracMinHashSketcher(cfg, device="cpu")
    assert_sketches_equal(got[:2], single.sketch_files(fastas[1:3]))
    assert got[2].count == 0


def clade_keys(rng, g, cap, fill, key_bits=40):
    """(G, cap, 4) uint32 sorted-unique sketches from one key pool, all-ones
    padded, one of them empty, and their counts."""
    keys = np.full((g, cap, 4), 0xFFFFFFFF, np.uint32)
    counts = np.zeros(g, np.int32)
    pool = np.unique(rng.integers(0, 1 << key_bits, 3 * cap).astype(
        np.uint64))
    for i in range(g):
        vals = np.unique(rng.choice(pool, int(cap * fill)))
        counts[i] = vals.size
        keys[i, :vals.size, 0] = (vals & 0xFFFFFFFF).astype(np.uint32)
        keys[i, :vals.size, 1] = (vals >> 32).astype(np.uint32)
        keys[i, :vals.size, 2:] = 0
    counts[17] = 0
    keys[17] = 0xFFFFFFFF
    return keys, counts


@pytest.fixture(scope="module")
def blocks():
    return clade_keys(np.random.default_rng(91), 300, 256, 0.7)


@pytest.fixture(scope="module")
def jax_matrix(blocks):
    keys, counts = blocks
    jm = jax_mesh.make_mesh((2, 4))
    return jax_mesh_all_pairs_packed(
        jm, lambda x, spec: jax.device_put(x, NamedSharding(jm, spec)),
        np.asarray, keys, counts, key_bits=40)


@pytest.mark.parametrize("slots", [["cpu"] * 8, ["cpu", "cpu:0"] * 4,
                                   ["cpu"]])
def test_mesh_all_pairs_packed_matches_jax(blocks, jax_matrix, slots,
                                          monkeypatch):
    """Three blocks of 128 (a ragged tail, an empty sketch): the port's
    mesh_all_pairs_packed == JAX's on make_mesh((2, 4)), the slab
    presorted once a distinct device and the 6 macro-tiles split over the
    slots."""
    keys, _ = blocks
    m = make_mesh(devices=slots)
    presorts = []
    orig = allpairs.presort_blocks_packed
    monkeypatch.setattr(allpairs, "presort_blocks_packed",
                        lambda slab, **kw: (presorts.append(1),
                                            orig(slab, **kw))[1])
    got = allpairs.mesh_all_pairs_packed(m, keys, key_bits=40)
    np.testing.assert_array_equal(got, jax_matrix)
    assert len(presorts) == len(m.distinct()) == len(set(slots))


def test_sketcher_all_pairs_engines_match_jax(blocks, jax_matrix):
    """MeshSketcher.all_pairs_intersections (mesh_all_pairs_packed) and
    all_pairs_intersections_shardmap (the probe on the grid) over Sketch
    objects == JAX's engines, and == the single-device route."""
    keys, counts = blocks
    g = 64                               # the probe: one tile a slot
    cfg = dict(window=20, k=16)
    port = MeshSketcher(SketchConfig(**cfg), make_mesh((2, 4), CPU8))
    sk = [Sketch(keys=keys[i, :counts[i]], count=int(counts[i]), window=20,
                 mask=port.mask) for i in range(keys.shape[0])]
    np.testing.assert_array_equal(port.all_pairs_intersections(sk),
                                  jax_matrix)
    jsk = JaxMeshSketcher(JaxConfig(**cfg), jax_mesh.make_mesh((2, 4)))
    probe = port.all_pairs_intersections_shardmap(sk[:g])
    np.testing.assert_array_equal(
        probe, jsk.all_pairs_intersections_shardmap(sk[:g]))
    np.testing.assert_array_equal(probe, jax_matrix[:g, :g])


def test_sharded_ani_matches_jax(blocks):
    """sharded_ani_fn on a 2 x 4 mesh == JAX's: the probe's matrix and the
    float32 ANI bit for bit."""
    keys, counts = blocks
    keys, counts = keys[:64], counts[:64]
    want_i, want_a = jax_sharded_ani_fn(jax_mesh.make_mesh((2, 4)), 12)(
        keys, counts)
    got_i, got_a = allpairs.sharded_ani_fn(make_mesh((2, 4), CPU8), 12)(
        torch.from_numpy(keys.view(np.int32)), torch.from_numpy(counts))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_a.dtype == torch.float32
    np.testing.assert_array_equal(got_a.numpy().view(np.uint32),
                                  np.asarray(want_a).view(np.uint32))


def test_blocked_all_pairs_with_a_mesh(blocks, jax_matrix):
    """blocked_all_pairs(mesh=...): two distinct devices hold a replica of
    the in-core cache each and split the tiles; eight slots of one device
    share one cache and split the tiles; both == JAX's matrix.  Past the
    budget the out-of-core schedule runs on the first device."""
    keys, _ = blocks
    two = make_mesh(devices=["cpu", "cpu:0"])
    one = make_mesh(devices=CPU8)
    for m in (two, one):
        got = allpairs.blocked_all_pairs(keys[:, :, :2], key_bits=40, mesh=m)
        np.testing.assert_array_equal(got, jax_matrix)
    reset_counters()
    got = allpairs.blocked_all_pairs(keys[:, :, :2], key_bits=40, mesh=two,
                                     budget_bytes=0)
    np.testing.assert_array_equal(got, jax_matrix)
    assert counters()["blocked_presorts"] > 0      # out of core: one device
