"""Blocked all-pairs intersections on one GPU: the block-cache schedule and
the out-of-core per-tile schedule.

The port of the single-device gram routes of the JAX package's
parallel/allpairs.py (blocked_all_pairs :57, its block-cache schedule
_gram_blocked_cached :209 and that schedule's tile sweep :282, and its
per-tile schedule past the budget, :120-194), which its sketcher takes
above 2048 genomes.  The (G, G) matrix is computed in (block x block)
macro-tiles: each upper-triangle macro-tile is a pair merge of two
presorted blocks' packed (key, gid) streams (K10) and the rect block of
their Gram (K6); intersections are symmetric, so each tile also fills its
mirror.  The reference's ordered all-pairs incl. self,
src/generators.hpp:45-58.

While the key slab and the presorted cache of every block fit
CACHE_BUDGET_BYTES, every block is presorted ONCE (K5) into a device-resident
cache and the tiles are swept over it.  Past it, the out-of-core schedule
holds O(block) on the device plus a column cache of COL_CACHE_BYTES:
each row block is uploaded and presorted once, column blocks' presorted
streams are cached up to that budget (and dropped once their own row is
done, since no later tile reads them), the rest are uploaded and
presorted again per tile, and each row of tiles is downloaded into the
host matrix.  Both give the same matrix bit for bit.

The device matrix is int32 (the JAX sweep's int16 matrix is not ported:
on the H100 its download was no faster, PERF.md).  The probe engine is
ops/intersect.py.

Host keys reach the in-core cache by the bit-tight slab transport
(ops/gram.py; JAX's _gram_blocked_cached :237-275) where JAX takes it and
keys have at most 64 bits (JAX's packer asserts there, so its route
fails above): each block is packed on worker threads into a pinned
buffer, only its live key bits, uploaded without blocking the host while
the next block packs, and presorted from the tight words (K12, K5).
Otherwise, and on the out-of-core schedule, blocks travel as key words.
`transport=` picks one for a call.

The in-core tiles are swept over a mesh (parallel/mesh.py; the JAX mesh
functions :27, :331-407, :435-451), a one-slot mesh on its device when
`blocked_all_pairs` is given none: every block is presorted once per
distinct device into a replica of the in-core cache, and the upper
triangle of macro-tiles is split contiguously over the slots
(mesh_tile_sweep; `mesh_all_pairs_packed` pads the capacity and calls
blocked_all_pairs with a mesh);
`sharded_all_pairs_fn` and `sharded_ani_fn` tile the probe over the
("r", "c") grid.  JAX's `sharded_gram_fn` (over
build_rank_layout) and `sharded_all_pairs_rect_fn` (the probe's blocked
schedule) are not ported.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..observability import count as obs_count, span
from ..ops.gram import (LANES, _guard_words, gram_pair_tile,
                        pack_keys_tight_np, pack_plan, presort_block_packed,
                        presort_block_tight, presort_blocks_packed,
                        tight_words4)
from ..ops.intersect import intersection_tile
from .distributed import all_reduce
from .mesh import Mesh, make_mesh, pad_to_multiple, split_range
from .sketch import gather_slots

# Device bytes the slab and the presorted cache may take together, and the
# out-of-core schedule's column cache: the JAX package's defaults
# (SKS_BLOCKED_CACHE_BUDGET and its per-tile schedule's cache budget).
CACHE_BUDGET_BYTES = 8 << 30
COL_CACHE_BYTES = 2 << 30
BLOCK = 128          # genomes per block: the JAX sketcher's choice
GIDBITS = (2 * BLOCK - 1).bit_length()   # a tile's row and column gids
PACK_THREADS = 4     # tight-packing host threads (tools/time_transport.py)

Provider = Callable[[int, int], tuple]


def slab_cache_bytes(g: int, cap: int, words: int, key_bits: int) -> int:
    """Device bytes of the in-core schedule's key slab and presorted cache
    for g sketches of capacity cap with `words` key words."""
    nb = max(1, -(-g // BLOCK))
    kw = min(words, _guard_words(key_bits))
    return nb * BLOCK * cap * (kw + pack_plan(key_bits, GIDBITS)) * 4


def blocked_all_pairs(keys: Union[torch.Tensor, np.ndarray, Provider], *,
                      key_bits: int, g: Optional[int] = None, counts=None,
                      device=None, budget_bytes: Optional[int] = None,
                      col_cache_bytes: Optional[int] = None,
                      mesh: Optional[Mesh] = None,
                      transport: Optional[str] = None,
                      pack: Optional[Callable] = None) -> np.ndarray:
    """(G, G) int32 intersections of G sorted-unique sketches (all-ones
    padded; cap a power of two >= 128; key_bits low key bits live), block
    by block of BLOCK genomes.  `keys` is one of:
      * a (G, cap, W) int32 tensor; the work runs on its device;
      * a host numpy (G, cap, W) uint32 array, with its counts (G,) or
        without (then the padding gives them);
      * a callable block-provider keys(i0, i1) -> (np keys (i1-i0, cap, W)
        uint32, np counts), with g= (e.g. reading a store.SketchStore), so
        the whole slab never materializes on the host either.
    W >= _guard_words(key_bits).  Host keys go to `device` (default cuda).
    transport: "tight" sends host keys to the in-core cache bit-tight,
    "words" as key words; the default takes "tight" where it can (host
    keys on the in-core route, key_bits <= 64).  pack(i0, i1, out) ->
    counts, if given, writes the tight rows of sketches i0..i1 at this
    call's key_bits into the zeroed uint32 out (i1-i0, cap/4,
    tight_words4(key_bits)) in place of packing the provider's keys.
    Collections whose slab and cache pass budget_bytes take the
    out-of-core schedule, its column cache bounded by col_cache_bytes;
    the two default to CACHE_BUDGET_BYTES and COL_CACHE_BYTES as they
    stand at the call.  Each distinct device of this process's slots of
    `mesh` (default: one slot on `device`) holds a replica of the in-core
    cache and the tiles split over the slots (mesh_tile_sweep); the work
    starts on its first device, and the out-of-core schedule stays
    there."""
    if isinstance(keys, torch.Tensor):
        g, device = keys.shape[0], keys.device
        provider = lambda i0, i1: (keys[i0:i1], None)  # noqa: E731
    elif callable(keys):
        if g is None:
            raise ValueError("a block-provider needs g=")
        provider = keys
    else:
        host = np.asarray(keys)
        g = host.shape[0]
        host_counts = None if counts is None else np.asarray(counts)
        provider = lambda i0, i1: (  # noqa: E731
            host[i0:i1], None if counts is None else host_counts[i0:i1])
    if mesh is None:
        mesh = make_mesh((1, 1), [torch.device(
            "cuda" if device is None else device)])
    replicas = mesh.distinct()
    device = replicas[0]
    if budget_bytes is None:
        budget_bytes = CACHE_BUDGET_BYTES
    if col_cache_bytes is None:
        col_cache_bytes = COL_CACHE_BYTES
    cap, words = provider(0, min(g, 1))[0].shape[1:]
    kw = min(words, _guard_words(key_bits))
    pw = pack_plan(key_bits, GIDBITS)
    nb = -(-g // BLOCK)

    def block_keys(b: int) -> torch.Tensor:
        return _block(provider, b, g, kw, device)

    in_core = slab_cache_bytes(g, cap, words, key_bits) <= budget_bytes
    if _tight(transport, not isinstance(keys, torch.Tensor) and in_core,
              cap, kw, key_bits):
        caches = _presort_tight(provider, pack, g, cap, kw, key_bits, pw,
                                replicas)
        return mesh_tile_sweep(mesh, caches, g)
    if in_core:
        if isinstance(keys, torch.Tensor) and g % BLOCK == 0 and words == kw:
            slab = keys.contiguous()      # the caller's slab, used in place
        else:
            slab = torch.empty((nb * BLOCK, cap, kw), dtype=torch.int32,
                               device=device)
            for b in range(nb):
                slab[b * BLOCK:(b + 1) * BLOCK] = block_keys(b)
        caches = {d: presort_blocks_packed(
            slab.to(d), block=BLOCK, key_bits=key_bits, gidbits=GIDBITS,
            pw=pw) for d in replicas}
        del slab
        return mesh_tile_sweep(mesh, caches, g)
    return _out_of_core(block_keys, g, cap, key_bits=key_bits, pw=pw,
                        col_cache_bytes=col_cache_bytes)


def _tight(transport: Optional[str], host_in_core: bool, cap: int, kw: int,
           key_bits: int) -> bool:
    """Whether the call takes the bit-tight transport: where JAX's
    _gram_blocked_cached does (host keys, cap % 4 == 0, fewer tight words
    than key words), on the in-core route, and with key_bits <= 64."""
    if transport not in (None, "tight", "words"):
        raise ValueError(f"transport must be 'tight' or 'words', got "
                         f"{transport!r}")
    able = (host_in_core and cap % 4 == 0 and key_bits <= 64
            and tight_words4(key_bits) < 4 * kw)
    if transport == "tight" and not able:
        raise ValueError("the tight transport needs host keys on the "
                         "in-core route and key_bits <= 64")
    return able and transport != "words"


def _padding_counts(keys: np.ndarray, kw: int) -> np.ndarray:
    """Each sketch's count: the index of its first all-ones row, or cap."""
    sent = (np.asarray(keys)[:, :, :kw] == 0xFFFFFFFF).all(-1)
    return np.where(sent.any(1), sent.argmax(1), sent.shape[1]).astype(
        np.int32)


def _presort_tight(provider: Provider, pack: Optional[Callable], g: int,
                   cap: int, kw: int, key_bits: int, pw: int,
                   devices) -> Dict[torch.device, torch.Tensor]:
    """The in-core cache (nb, pw, rows, 128) on each of `devices` from
    bit-tight blocks.  PACK_THREADS host threads pack blocks ahead (`pack`,
    or the provider's keys through pack_keys_tight_np; both release the
    GIL in the native packer) into a ring of buffers, pinned when a device
    is a GPU; block b uploads to each device without blocking the host and
    is presorted there (K12, K5) while later blocks pack.  A buffer is
    packed again once its upload has completed.  Counts the bytes sent
    (observability counter blocked_h2d_bytes)."""
    nb = -(-g // BLOCK)
    w4 = tight_words4(key_bits)
    pinned = any(d.type == "cuda" for d in devices)
    depth = min(nb, PACK_THREADS + 1)
    ring = [(torch.empty((BLOCK, cap // 4, w4), dtype=torch.int32,
                         pin_memory=pinned),
             torch.empty(BLOCK, dtype=torch.int32, pin_memory=pinned))
            for _ in range(depth)]
    uploads = [[] for _ in range(depth)]     # events of a buffer's uploads
    caches = {d: torch.empty((nb, pw, BLOCK * cap // LANES, LANES),
                             dtype=torch.int32, device=d) for d in devices}

    def fill(b: int) -> None:
        tight, cnt = ring[b % depth]
        for e in uploads[b % depth]:
            e.synchronize()
        i0, i1 = b * BLOCK, min(g, (b + 1) * BLOCK)
        out, c = tight.numpy().view(np.uint32), cnt.numpy()
        out.fill(0)
        c.fill(0)
        if pack is not None:
            c[:i1 - i0] = pack(i0, i1, out[:i1 - i0])
            return
        k, kc = provider(i0, i1)
        if kc is None:
            kc = _padding_counts(k, kw)
        pack_keys_tight_np(k, kc, key_bits, out=out[:i1 - i0])
        c[:i1 - i0] = kc

    with cf.ThreadPoolExecutor(max_workers=min(depth, PACK_THREADS)) as pool:
        pending = {b: pool.submit(fill, b) for b in range(depth)}
        for b in range(nb):
            pending.pop(b).result()
            tight, cnt = ring[b % depth]
            events = []
            for d in devices:
                td = tight.to(d, non_blocking=True)
                cd = cnt.to(d, non_blocking=True)
                if d.type == "cuda":
                    events.append(torch.cuda.Event())
                    events[-1].record(torch.cuda.current_stream(d))
                caches[d][b] = presort_block_tight(
                    td, cd, key_bits=key_bits, gidbits=GIDBITS, pw=pw)
            uploads[b % depth] = events
            obs_count("blocked_h2d_bytes",
                      len(devices) * (tight.nbytes + cnt.nbytes))
            if b + depth < nb:
                pending[b + depth] = pool.submit(fill, b + depth)
    return caches


def _block(provider: Provider, b: int, g: int, kw: int,
           device: torch.device) -> torch.Tensor:
    """Block b's (BLOCK, cap, kw) int32 keys on `device`, a ragged tail
    filled with all-sentinel sketches.  Counts the bytes of host keys sent
    (blocked_h2d_bytes)."""
    i0, i1 = b * BLOCK, min(g, (b + 1) * BLOCK)
    k = provider(i0, i1)[0][:, :, :kw]
    if not isinstance(k, torch.Tensor):
        k = torch.from_numpy(
            np.ascontiguousarray(k, dtype=np.uint32).view(np.int32))
        obs_count("blocked_h2d_bytes", k.nbytes)
    k = k.to(device)
    if k.shape[0] < BLOCK:
        pad = torch.full((BLOCK - k.shape[0],) + tuple(k.shape[1:]), -1,
                         dtype=torch.int32, device=device)
        k = torch.cat([k, pad])
    return k.contiguous()


def _out_of_core(block_keys: Callable[[int], torch.Tensor], g: int, cap: int,
                 *, key_bits: int, pw: int,
                 col_cache_bytes: int) -> np.ndarray:
    """The per-tile schedule: row by row of macro-tiles, each row block
    presorted once, column blocks from the cache or presorted again; the
    row's tiles fill a device strip that is downloaded into the host matrix
    and its mirror.  Counts `blocked_presorts` and `blocked_cache_hits`
    (observability counters)."""
    nb = -(-g // BLOCK)
    block_bytes = pw * BLOCK * cap * 4

    def presort(b: int) -> torch.Tensor:
        obs_count("blocked_presorts")
        return presort_block_packed(block_keys(b), key_bits=key_bits,
                                    gidbits=GIDBITS, pw=pw)

    out = np.empty((g, g), np.int32)
    cache = {}
    for bi in range(nb):
        row = cache.pop(bi, None)         # no later tile reads column bi
        if row is None:
            row = presort(bi)
        else:
            obs_count("blocked_cache_hits")
        strip = torch.empty((BLOCK, (nb - bi) * BLOCK), dtype=torch.int32,
                            device=row.device)
        for bj in range(bi, nb):
            col = row if bj == bi else cache.get(bj)
            if col is None:
                col = presort(bj)
                if (len(cache) + 1) * block_bytes <= col_cache_bytes:
                    cache[bj] = col
            elif bj != bi:
                obs_count("blocked_cache_hits")
            strip[:, (bj - bi) * BLOCK:(bj - bi + 1) * BLOCK] = \
                gram_pair_tile(row, col, block=BLOCK, gidbits=GIDBITS)
        r0, r1 = bi * BLOCK, min(g, (bi + 1) * BLOCK)
        part = strip[:r1 - r0, :g - r0].cpu().numpy()
        out[r0:r1, r0:] = part
        out[r0:, r0:r1] = part.T
    return out


def mesh_tile_sweep(mesh: Mesh, caches: Dict[torch.device, torch.Tensor],
                    g: int) -> np.ndarray:
    """The upper-triangle macro-tile sweep over `caches` (a replica of the
    (nb, pw, rows, 128) presorted cache on each distinct device of this
    process's slots): the row-major tile list is split contiguously over
    the flattened slots as P(("r", "c")) splits them, and each of this
    process's slots computes its share on its own device (gram_pair_tile),
    a one-slot mesh all of it.  Each tile and its mirror land in one int32
    matrix on the first device, downloaded once at the end (the JAX sweep
    batches tiles per dispatch and downloads each batch).  Where other
    ranks own slots the matrix starts zeroed and the ranks' matrices,
    whose tiles are disjoint, are summed.  Spans allpairs.tiles (the
    launches) and allpairs.download."""
    nb = next(iter(caches.values())).shape[0]
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    pp = pad_to_multiple(len(pairs), mesh.size)
    first = next(iter(caches))
    local = mesh.local_slots()
    whole = len(local) == mesh.size     # this process writes every tile
    full = (torch.empty if whole else torch.zeros)(
        (nb * BLOCK, nb * BLOCK), dtype=torch.int32, device=first)
    with span("allpairs.tiles"):
        for s in local:
            d = mesh.devices[s]
            cache = caches[d]
            for bi, bj in pairs[split_range(pp, mesh.size, s)]:
                t = gram_pair_tile(cache[bi], cache[bj], block=BLOCK,
                                   gidbits=GIDBITS)
                if d != first:
                    t = t.to(first)
                rows = slice(bi * BLOCK, (bi + 1) * BLOCK)
                cols = slice(bj * BLOCK, (bj + 1) * BLOCK)
                full[rows, cols] = t
                if bj != bi:
                    full[cols, rows] = t.T
    with span("allpairs.download"):
        out = full[:g, :g]
        return (out if whole else all_reduce(out)).cpu().numpy()


# --- over a mesh ------------------------------------------------------------

def mesh_all_pairs_packed(mesh: Mesh, keys_np: np.ndarray, *,
                          key_bits: int) -> np.ndarray:
    """(G, G) int32 intersections of G sorted-unique sketches (keys (G,
    cap, W) uint32, all-ones padded) over the mesh: the capacity padded to
    a power of two >= 128, then blocked_all_pairs(mesh=mesh), which
    presorts the slab block by block (K5) once per distinct device and
    splits the macro-tiles (K10, split K6) over the slots.  Equal to the
    single-device engines.  The JAX function also takes the counts; the
    padding marks each sketch's end."""
    g, cap, words = keys_np.shape
    capp = max(LANES, 1 << max(0, (cap - 1).bit_length()))
    if capp != cap:
        slab = np.full((g, capp, words), 0xFFFFFFFF, np.uint32)
        slab[:, :cap] = keys_np
        keys_np = slab
    return blocked_all_pairs(keys_np, key_bits=key_bits, mesh=mesh,
                             transport="words")


def sharded_all_pairs_fn(mesh: Mesh) -> Callable:
    """(keys (G, cap, W), counts (G,)) -> (G, G) int32 intersections by the
    probe (ops/intersect.py), G a multiple of both mesh axes: slot (i, j)
    computes the tile of row block i (rows split over "r") and column
    block j (columns over "c"); the tiles are gathered to every rank and
    returned on the CPU."""
    r, c = mesh.shape

    def run(keys, counts) -> torch.Tensor:
        keys, counts = torch.as_tensor(keys), torch.as_tensor(counts)
        g = keys.shape[0]
        parts = []
        for s in mesh.local_slots():
            d = mesh.devices[s]
            rows, cols = split_range(g, r, s // c), split_range(g, c, s % c)
            parts.append(intersection_tile(
                keys[rows].to(d), counts[rows].to(d), keys[cols].to(d),
                counts[cols].to(d))[None])
        tiles = gather_slots(parts).cpu()
        return tiles.reshape(r, c, g // r, g // c).permute(0, 2, 1, 3) \
            .reshape(g, g)
    return run


def sharded_ani_fn(mesh: Mesh, care_positions: int) -> Callable:
    """(keys, counts) -> (inter (G, G) int32, ani (G, G) float32): the
    probe over the mesh, then the reference's containment (denominator the
    row genome's sketch size, the FIRST of the ordered pair,
    src/kmer-sketching.cpp:198) and estimator (src/ani_estimation.cpp:
    24-42) in float32, as the JAX function computes them on the device."""
    pairs = sharded_all_pairs_fn(mesh)
    inv_k = 1.0 / float(care_positions)

    def run(keys, counts):
        inter = pairs(keys, counts)
        den = torch.as_tensor(counts).cpu().clamp(min=1)[:, None]
        c = torch.where(inter == 0, 0.0,
                        inter.to(torch.float32) / den.to(torch.float32))
        ani = torch.where(c <= 0, 0.0, torch.pow(c, inv_k))
        return inter, ani
    return run
