"""The port's mesh, distributed helpers, data-parallel and sequence-parallel
sketching (parallel/{mesh,distributed,sketch,sequence}.py) against the JAX
package's on the 8 virtual CPU devices of tests/conftest.py.

The port's meshes here are 2 x 4 grids of CPU slots (one device filling
eight slots).  Inputs are made from a seed with numpy.  Every comparison
is exact (tolerance 0): keys, counts and raw_kept are integers.  JAX's
sharded compact step cannot run its raw kernel in interpret mode under
shard_map, so the port's is held to JAX's sketch_batch_compact in
interpret mode on the whole batch (the step has no cross-slot
communication).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from spaced_kmer_sketching_tpu.ops.extract import run_ids_from_lens
from spaced_kmer_sketching_tpu.ops.pallas.extract import (
    packed_body as jax_packed_body)
from spaced_kmer_sketching_tpu.ops.sketch import (
    sketch_batch_compact as jax_sketch_batch_compact,
    sketch_from_codes as jax_sketch_from_codes)
from spaced_kmer_sketching_tpu.parallel import distributed as jax_dist
from spaced_kmer_sketching_tpu.parallel import mesh as jax_mesh
from spaced_kmer_sketching_tpu.parallel import (
    pack_genome_batch as jax_pack_genome_batch,
    sequence_parallel_sketch_compact_fn as jax_seq_compact_fn,
    sequence_parallel_sketch_fn as jax_seq_fn,
    sharded_sketch_fn as jax_sharded_sketch_fn)

from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import packed_body
from spaced_kmer_sketching_tpu_torch.parallel import distributed, mesh
from spaced_kmer_sketching_tpu_torch.parallel.sequence import (
    sequence_parallel_sketch_compact_fn, sequence_parallel_sketch_fn)
from spaced_kmer_sketching_tpu_torch.parallel.sketch import (
    gather_batches, pack_genome_batch, sharded_sketch_compact_fn,
    sharded_sketch_fn)
from spaced_kmer_sketching_tpu_torch.utils import boosthash, native
from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

WINDOW, K, SCALE, VARIANT = 16, 12, 5, "modern"
CPU8 = ["cpu"] * 8


def setup_module(module):
    assert jax.device_count() == 8, "conftest must fake 8 CPU devices"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels' torch ops of a mesh test module on one thread:
    the suite runs several workers on the machine's cores, where more
    threads a worker only contend (test_torch_mesh_sketcher.py,
    test_torch_mesh_pipeline.py and test_torch_distributed.py import it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mask_salt():
    mask = spaced_seed_mask(WINDOW, K, 0)
    return mask, boosthash.fmh_salt(mask.lo, mask.hi, WINDOW, 1, VARIANT)


class Packed:
    def __init__(self, runs):
        self.codes = np.concatenate([np.asarray(r, np.uint8) for r in runs])
        self.run_lens = np.array([len(r) for r in runs], dtype=np.int64)


@pytest.fixture(scope="module")
def genomes():
    rng = np.random.default_rng(3)
    return [Packed([rng.integers(0, 4, n) for n in
                    rng.integers(200, 1200, size=rng.integers(1, 4))])
            for _ in range(6)]


def assert_batch_equal(got, want):
    """Port SketchBatch (torch) == JAX SketchBatch, every field."""
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint32),
                                  np.asarray(want.keys))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.raw_kept.numpy(),
                                  np.asarray(want.raw_kept))


# --- mesh and distributed helpers ------------------------------------------

@pytest.mark.parametrize("n", range(1, 65))
def test_factor2d_matches_jax(n):
    assert mesh._factor2d(n) == jax_mesh._factor2d(n)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_make_mesh_shapes_match_jax(n):
    m = mesh.make_mesh(devices=["cpu"] * n)
    assert m.shape == tuple(jax_mesh.make_mesh(
        devices=jax.devices()[:n]).devices.shape)
    assert m.size == n and m.local_slots() == list(range(n))
    assert mesh.make_mesh((1, n), ["cpu"] * n).shape == (1, n)


def test_make_mesh_errors():
    """A shape that does not match the devices raises, as in JAX; so does
    a default mesh without a GPU, and ranks that own unequal slots."""
    with pytest.raises(ValueError):
        jax_mesh.make_mesh((2, 3), jax.devices()[:8])
    with pytest.raises(ValueError, match="mesh shape"):
        mesh.make_mesh((2, 3), CPU8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mesh.make_mesh((1, 1))
    with pytest.raises(ValueError, match="same number"):
        mesh.make_mesh((1, 3), ["cpu"] * 3, ranks=[0, 0, 1])


def test_global_mesh_without_a_job():
    """One process: --device cpu gives R x C CPU slots (one without a
    shape); --device cuda without a GPU raises."""
    assert distributed.world_size() == 1
    distributed.init_distributed()          # no environment: stays single
    assert not torch.distributed.is_initialized()
    assert distributed.global_mesh((2, 4), "cpu").shape == (2, 4)
    assert distributed.global_mesh(None, "cpu").size == 1
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        distributed.global_mesh(None, "cuda")


def test_init_distributed_needs_a_whole_job():
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_distributed("127.0.0.1:1", None, 0)


@pytest.mark.parametrize("n,m", [(0, 1), (1, 8), (5, 8), (8, 8), (9, 4),
                                 (300, 128), (256, 128)])
def test_pad_to_multiple_matches_jax(n, m):
    assert mesh.pad_to_multiple(n, m) == jax_mesh.pad_to_multiple(n, m)


@pytest.mark.parametrize("n", [8, 16, 1024])
def test_data_rows_are_jax_sharding(n):
    """Slot s of a 2 x 4 mesh holds the rows that P(("r", "c")) gives the
    device at flat index s."""
    jm = jax_mesh.make_mesh((2, 4))
    index = NamedSharding(jm, jax_mesh.data_spec()).devices_indices_map((n,))
    m = mesh.make_mesh((2, 4), CPU8)
    for s, dev in enumerate(jm.devices.flat):
        want = index[dev][0].indices(n)
        got = mesh.data_rows(m, n, s)
        assert (got.start, got.stop) == want[:2]


@pytest.mark.parametrize("rank", [0, 1])
def test_local_batch_rows_five_genomes_two_ranks(monkeypatch, rank):
    """5 genomes on 2 ranks x 4 slots: the padded batch puts rows 0-3 on
    rank 0 and row 4 on rank 1 (JAX's sharding of the devices each rank
    owns), while the ceil split of process_shard hands row 3 to rank 1,
    as JAX's does."""
    jm = jax_mesh.make_mesh((2, 4))
    index = NamedSharding(jm, jax_mesh.data_spec()).devices_indices_map((8,))
    want = set()
    for s, dev in enumerate(jm.devices.flat):
        if s // 4 == rank:
            want.update(i for i in range(*index[dev][0].indices(8)) if i < 5)
    m = mesh.make_mesh((2, 4), CPU8, ranks=[0] * 4 + [1] * 4)
    monkeypatch.setattr(mesh, "process_rank", lambda: rank)
    monkeypatch.setattr(distributed, "process_rank", lambda: rank)
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    got = distributed.local_batch_rows(m, 5, 8)
    assert got == want == ({0, 1, 2, 3} if rank == 0 else {4})
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    assert distributed.process_shard(5) == jax_dist.process_shard(5) == \
        (slice(0, 3) if rank == 0 else slice(3, 5))


# --- data-parallel sketching -----------------------------------------------

def test_pack_genome_batch_matches_jax(genomes):
    for n_codes in (None, 5000):
        got = pack_genome_batch(genomes, 8, WINDOW, n_codes=n_codes)
        want = jax_pack_genome_batch(genomes, 8, WINDOW, n_codes=n_codes)
        for x, y in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(x, y)
        assert got[2] == want[2] == len(genomes)


def test_sharded_sketch_matches_jax(genomes):
    """K1 and the finish a slot over a 2 x 4 mesh == JAX's shard_map over
    make_mesh((2, 4)): keys, counts and raw_kept of every row, padding
    rows empty."""
    mask, salt = mask_salt()
    codes, run_ids, g = pack_genome_batch(genomes, 8, WINDOW)
    args = dict(window=WINDOW, salt=salt, scale=SCALE, variant=VARIANT,
                capacity=1024)
    want = jax_sharded_sketch_fn(jax_mesh.make_mesh((2, 4)), **args)(
        jnp.asarray(codes.astype(np.uint32)), jnp.asarray(run_ids),
        jnp.asarray(mask.words_u32))
    parts = sharded_sketch_fn(mesh.make_mesh((2, 4), CPU8), **args)(
        codes, run_ids, mask.words_u32)
    assert len(parts) == 8 and all(p.count.shape == (1,) for p in parts)
    got = gather_batches(parts)
    assert int(got.raw_kept.max()) <= 1024
    assert_batch_equal(got, want)
    assert (got.count[g:] == 0).all()


def compact_batch(rng, g, n, k):
    """(p, bounds, rid0, vlen) of g random genomes of n codes with up to k
    run starts each, as the pipeline uploads them."""
    body = packed_body(n)
    p = rng.integers(0, 2 ** 32, (g, body // 16), dtype=np.uint64) \
        .astype(np.uint32)
    bounds = np.full((g, k), body, np.int32)
    for i in range(g):
        starts = np.sort(rng.choice(np.arange(1, n), rng.integers(0, k),
                                    replace=False))
        bounds[i, :starts.size] = starts
    rid0 = rng.integers(0, 3, g).astype(np.int32)
    vlen = rng.integers(n // 2, n + 1, g).astype(np.int32)
    vlen[-1] = 0                                   # an empty padding row
    return p, bounds, rid0, vlen


def test_sharded_sketch_compact_matches_jax():
    """K7 and the finish a slot over a 2 x 4 mesh == JAX's
    sketch_batch_compact (raw kernel in interpret mode) on the batch."""
    mask, salt = mask_salt()
    n = 4096
    assert packed_body(n) == jax_packed_body(n)
    p, bounds, rid0, vlen = compact_batch(np.random.default_rng(4), 8, n, 8)
    args = dict(n=n, window=WINDOW, salt=salt, scale=SCALE, variant=VARIANT,
                capacity=1024)
    want = jax_sketch_batch_compact(
        *(jnp.asarray(x) for x in (p, bounds, rid0, vlen)),
        jnp.asarray(mask.words_u32), interpret=True, **args)
    got = gather_batches(sharded_sketch_compact_fn(
        mesh.make_mesh((2, 4), CPU8), **args)(
        p.view(np.int32), bounds, rid0, vlen, mask.words_u32))
    assert int(got.raw_kept.max()) <= 1024
    assert_batch_equal(got, want)


# --- sequence parallelism --------------------------------------------------

def ring_sequence(rng, kind):
    """One 4,096-code sequence for the 8-chunk ring (chunks of 512) and its
    run-id plane: two runs split inside a chunk; an N-split (a -1 hole)
    that straddles chunks 1 and 2; or valid codes to the very end, so the
    last chunk's windows need its (invalid) wrapped halo."""
    n = 8 * 512
    codes = rng.integers(0, 4, n).astype(np.uint32)
    if kind == "split_in_chunk":
        rid = np.array(run_ids_from_lens([3000, n - 3000 - 40], n), np.int32)
    elif kind == "hole_across_chunks":
        rid = np.array(run_ids_from_lens([1020, 9, n - 1029 - 64], n),
                       np.int32)
        rid[1020:1029] = -1              # the N's: positions 1020-1028
    else:
        rid = np.zeros(n, np.int32)
    return codes, rid


@pytest.mark.parametrize("capacity", [4096, 256])
@pytest.mark.parametrize("kind", ["split_in_chunk", "hole_across_chunks",
                                  "to_the_end"])
def test_sequence_parallel_matches_jax(kind, capacity):
    """The ring over 2 x 4 CPU slots == JAX's over make_mesh((2, 4)), keys,
    count and the ring's raw_kept, with and without overflow; without it
    both equal sketch_from_codes on the whole sequence."""
    mask, salt = mask_salt()
    codes, rid = ring_sequence(np.random.default_rng(9), kind)
    args = dict(window=WINDOW, salt=salt, scale=SCALE, variant=VARIANT,
                capacity=capacity)
    want = jax_seq_fn(jax_mesh.make_mesh((2, 4)), **args)(
        jnp.asarray(codes), jnp.asarray(rid), jnp.asarray(mask.words_u32))
    got = sequence_parallel_sketch_fn(mesh.make_mesh((2, 4), CPU8), **args)(
        codes.astype(np.uint8), rid, mask.words_u32)
    assert_batch_equal(got, want)
    if capacity == 4096:
        whole = jax_sketch_from_codes(jnp.asarray(codes), jnp.asarray(rid),
                                      jnp.asarray(mask.words_u32), **args)
        assert int(whole.raw_kept) <= capacity
        assert int(got.count) == int(whole.count)
        np.testing.assert_array_equal(got.keys.numpy().view(np.uint32),
                                      np.asarray(whole.keys))
    else:
        assert int(got.raw_kept) > capacity


@pytest.mark.parametrize("kind", ["bound_at_chunk_edge", "runs_in_chunks",
                                  "short_tail"])
def test_sequence_parallel_compact_matches_jax(kind):
    """The compact ring (words expanded a slot, run ids from global
    positions: rid0 + #(bounds <= pos), -1 from valid_len) == JAX's
    compact ring and the port's full-plane ring on the same sequence."""
    rng = np.random.default_rng(12)
    mask, salt = mask_salt()
    n = 8 * 512
    codes = rng.integers(0, 4, n).astype(np.uint8)
    vlen, rid0 = n, 2
    if kind == "bound_at_chunk_edge":
        starts = [1020, 1024, 1030, 3584]
    elif kind == "runs_in_chunks":
        starts = [100, 700, 2000, 2001, 4000]
    else:
        starts, vlen = [2500], n - 300
    bounds = np.full(8, n, np.int32)
    bounds[:len(starts)] = starts
    p = native.pack2bit(codes, n // 16) if native.available() else \
        (codes.astype(np.uint32).reshape(-1, 16)
         << (2 * np.arange(16, dtype=np.uint32))).sum(-1, dtype=np.uint32)
    args = dict(window=WINDOW, salt=salt, scale=SCALE, variant=VARIANT,
                capacity=2048)
    inputs = (bounds, np.array([rid0], np.int32), np.array([vlen], np.int32))
    want = jax_seq_compact_fn(jax_mesh.make_mesh((2, 4)), **args)(
        jnp.asarray(p), *(jnp.asarray(x) for x in inputs),
        jnp.asarray(mask.words_u32))
    m = mesh.make_mesh((2, 4), CPU8)
    got = sequence_parallel_sketch_compact_fn(m, **args)(
        p.view(np.int32), *inputs, mask.words_u32)
    assert_batch_equal(got, want)
    rid = np.full(n, -1, np.int32)
    pos = np.arange(vlen)
    rid[:vlen] = rid0 + np.searchsorted(bounds, pos, side="right")
    planes = sequence_parallel_sketch_fn(m, **args)(codes, rid,
                                                    mask.words_u32)
    assert int(planes.count) == int(got.count) > 0
    assert torch.equal(planes.keys, got.keys)
