"""K6: exact Gram of a sorted packed (key, gid) stream (csrc/gram_tiles.cu).

The counterpart of the JAX package's ops/pallas/gram_tiles.py::
gram_tile_scan_fused and, above its gp <= 1024 gate, the XLA scan
ops/gram._gram_chunks_packed: entry (a, b) of the result counts the keys
shared by genomes a and b, the diagonal holds the sketch sizes.  The JAX
functions return float32 (exact, counts < 2^24); the port returns int32.
The kernel takes the sum over runs of the 0/1 run multi-hots' products on
the int8 tensor cores (wgmma), for any gp the 16-bit gid field of its
chunk entries holds (gp <= 65,536).  It sizes its own segments of the
stream's valid entries: whole 4,096-entry chunks less 64 entries each,
for about 264 blocks over all 128 x 128 output tiles, two resident on
each of the H100's 132 SMs (csrc/gram_tiles.cu says why).  Every launch adds the runs it multiplied
(kept runs, summed over the output tiles) to an int64 counter on the
device, which `take_kept_runs` reads.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import build

LANES = 128
K6 = build.KERNELS["K6"]
_kept: Dict[torch.device, torch.Tensor] = {}   # per device, since the take


def _shape(sw: torch.Tensor, gidbits: int, gp: int, split: Optional[int]):
    if sw.dim() < 2 or not 1 <= sw.shape[0] <= 5:
        raise ValueError(f"gram_tile_scan takes (pw<=5, ...) planes, got "
                         f"{tuple(sw.shape)}")
    if gp <= 0 or gp % LANES or not 1 <= gidbits <= 31:
        raise ValueError(f"gp must be a positive multiple of 128 and "
                         f"1 <= gidbits <= 31, got gp={gp} gidbits={gidbits}")
    if split is not None and (split <= 0 or split >= gp or split % LANES):
        raise ValueError(f"split must be a multiple of 128 in (0, {gp}), "
                         f"got {split}")
    r = gp if split is None else split
    c0 = 0 if split is None else split
    return r, c0


def gram_tile_scan(sw: torch.Tensor, gidbits: int, gp: int, *,
                   split: Optional[int] = None) -> torch.Tensor:
    """sw (pw, ...) int32 planes of an ascending packed stream (valid
    entries first; a set bit 31 of word pw-1 marks a sentinel) -> the
    (gp, gp) int32 Gram, or with `split` the (split, gp - split) block of
    rows < split and columns >= split.  Every gid must be < gp.  CPU
    tensors take the plain version; CUDA tensors launch K6."""
    r, c0 = _shape(sw, gidbits, gp, split)
    if sw.device.type == "cpu":
        return gram_tile_scan_plain(sw, gidbits, gp, split=split)
    dev = sw.device
    pw = sw.shape[0]
    flat = sw.reshape(pw, -1)
    build.require(flat, "sw", torch.int32, 2, dev)
    n = flat.shape[1]
    out = torch.zeros((r, gp - c0), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    build.launch("sks_gram_tiles", dev, flat.data_ptr(), pw, n, gidbits, gp,
                 split or 0, 0, out.data_ptr(), _kept_counter(dev).data_ptr())
    K6.launches += 1
    return out


def _device(dev) -> torch.device:
    """`dev` with its index (a CUDA device without one is the current)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _kept_counter(dev: torch.device) -> torch.Tensor:
    t = _kept.get(dev)
    if t is None:
        t = _kept[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return t


def reset_kept_runs(dev) -> None:
    """Zero `dev`'s kept-run counter (enqueued on its stream; no sync)."""
    t = _kept.get(_device(dev))
    if t is not None:
        t.zero_()


def take_kept_runs(dev) -> int:
    """Runs that K6 launches on `dev` multiplied since the last take or
    reset: for each launch, the runs of the stream with an entry in an
    output tile's row range and one in its column range (two in range on
    a diagonal tile of full mode), summed over its tiles; each cost 2 x
    128 x 128 int8 tensor operations.  Reading it waits for the device.
    The plain version counts none."""
    t = _kept.get(_device(dev))
    if t is None:
        return 0
    n = int(t.item())
    t.zero_()
    return n


def gram_tile_scan_plain(sw: torch.Tensor, gidbits: int, gp: int, *,
                         split: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K6 (any device): run ids from a cumsum of
    key boundaries, then per chunk of runs the 0/1 run multi-hot H (runs x
    gp) and H^T H in float64.  The operands are 0/1 and every count is
    below 2^53, so the float64 products are exact (and float64 has no TF32
    mode)."""
    r, c0 = _shape(sw, gidbits, gp, split)
    pw = sw.shape[0]
    w = sw.reshape(pw, -1)
    gmask = (1 << gidbits) - 1
    valid = w[pw - 1] >= 0
    key = torch.cat([(w[0] & ~gmask)[None], w[1:]])
    bnd = torch.ones_like(valid)
    bnd[1:] = (key[:, 1:] != key[:, :-1]).any(0)
    rid = (torch.cumsum(bnd.to(torch.int64), 0) - 1)[valid]
    gid = (w[0] & gmask).to(torch.int64)[valid]
    acc = torch.zeros((r, gp - c0), dtype=torch.float64, device=sw.device)
    if rid.numel():
        rid = rid - rid[0]
        nruns = int(rid[-1]) + 1
        chunk = max(1024, (1 << 24) // gp)       # 128 MB of H per chunk
        for q0 in range(0, nruns, chunk):
            e0, e1 = torch.searchsorted(rid, torch.tensor(
                [q0, q0 + chunk], device=rid.device)).tolist()
            h = torch.zeros((min(chunk, nruns - q0), gp), dtype=torch.float64,
                            device=sw.device)
            h[rid[e0:e1] - q0, gid[e0:e1]] = 1.0
            acc += h[:, :r].T @ h[:, c0:]
    return acc.to(torch.int32)
