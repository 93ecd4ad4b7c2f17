"""K12: a bit-tight block unpacked straight into K5's packed (key, gid)
planes (csrc/tight.cu).

The JAX package's blocked schedule unpacks each bit-tight block
(ops/gram.py::unpack_keys_tight :570) and packs the (key, gid) planes
(_pack_gid_planes, called at :624) inside its presort scan, where XLA
fuses the two into one pass; eager PyTorch would take ~50 elementwise
launches a block with full-width int64 temporaries.  K12 is that fused
pass: one thread a 4-key group reads the group's tight_words4(key_bits)
words once and writes its 4 entries of every plane with one 16-byte
store each, so it is bound by bytes (each tight word read once, each
packed word written once).  It is the port's own kernel, not a Pallas
one.
"""
from __future__ import annotations

import torch

from . import build

LANES = 128
K12 = build.KERNELS["K12"]


def _shape(tight: torch.Tensor, counts: torch.Tensor, key_bits: int,
           gidbits: int, pw: int):
    if tight.dim() != 3:
        raise ValueError(f"tight_gid_planes takes (rows, cap/4, w4) words, "
                         f"got {tuple(tight.shape)}")
    rows, cap4, w4 = tight.shape
    if not 0 < key_bits <= 64 or not 0 < gidbits < 32:
        raise ValueError(f"need 0 < key_bits <= 64 and 0 < gidbits < 32, "
                         f"got {key_bits}, {gidbits}")
    if w4 != (4 * key_bits + 31) // 32 or rows > 1 << gidbits:
        raise ValueError(f"{tuple(tight.shape)} is no tight block of "
                         f"{key_bits}-bit keys with {gidbits}-bit gids")
    if pw != (key_bits + gidbits + 1 + 31) // 32:
        raise ValueError(f"pw {pw} is not the pack plan of {key_bits} key "
                         f"and {gidbits} gid bits")
    if tuple(counts.shape) != (rows,) or (rows * cap4 * 4) % LANES:
        raise ValueError(f"counts {tuple(counts.shape)} for {rows} rows of "
                         f"{4 * cap4} entries (a multiple of 128 in all)")
    return rows, cap4, w4


def tight_gid_planes(tight: torch.Tensor, counts: torch.Tensor, *,
                     key_bits: int, gidbits: int, pw: int) -> torch.Tensor:
    """tight (rows, cap/4, tight_words4(key_bits)) int32 holding u32 bits,
    counts (rows,) int32 -> (pw, rows*cap/128, 128) int32 planes of
    (key << gidbits) | row, all-ones at or past each row's count: K5's
    input for the block.  CPU tensors take the plain version; CUDA tensors
    launch K12."""
    rows, cap4, w4 = _shape(tight, counts, key_bits, gidbits, pw)
    if tight.device.type == "cpu":
        return tight_gid_planes_plain(tight, counts, key_bits=key_bits,
                                      gidbits=gidbits, pw=pw)
    dev = tight.device
    build.require(tight, "tight", torch.int32, 3, dev)
    build.require(counts, "counts", torch.int32, 1, dev)
    out = torch.empty((pw, rows * cap4 * 4 // LANES, LANES),
                      dtype=torch.int32, device=dev)
    if rows * cap4 == 0:
        return out
    build.launch("sks_tight_gid_planes", dev, tight.data_ptr(),
                 counts.data_ptr(), rows, cap4, w4, key_bits, gidbits, pw,
                 out.data_ptr())
    K12.launches += 1
    return out


def tight_gid_planes_plain(tight: torch.Tensor, counts: torch.Tensor, *,
                           key_bits: int, gidbits: int,
                           pw: int) -> torch.Tensor:
    """Plain PyTorch version of K12 (any device): ops/gram.py's
    unpack_keys_tight to the guard words, then _pack_gid_planes with the
    row as gid, as the JAX presort composes them."""
    from .. import gram                   # gram imports this module

    rows, cap4, _ = _shape(tight, counts, key_bits, gidbits, pw)
    keys = gram.unpack_keys_tight(tight, counts, key_bits,
                                  gram._guard_words(key_bits))
    gid = torch.arange(rows, dtype=torch.int32,
                       device=tight.device)[:, None].expand(rows, 4 * cap4)
    planes = gram._pack_gid_planes(keys, gid, key_bits, gidbits, pw)
    return planes.reshape(pw, rows * cap4 * 4 // LANES, LANES)
