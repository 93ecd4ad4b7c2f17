"""K2 compact_rows and K3 compact_global (csrc/compact.cu).

Order-preserving compaction of stacked key planes (kw, ...) int32 whose
holes are all-ones sentinels; a slot is valid iff it is not all-ones in
the carried words (a canonical key never is, see csrc/common.cuh).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

LANES = 128
K2 = build.KERNELS["K2"]
K3 = build.KERNELS["K3"]


def _valid(planes: torch.Tensor) -> torch.Tensor:
    return (planes != -1).any(0)


def compact_rows(planes: torch.Tensor, k_out: int, *,
                 with_counts: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """planes (kw, G, R, 128) int32 -> ((kw, G, R, k_out) int32, counts):
    each row's valid slots moved to the front in order, the first k_out
    kept, all-ones after them.  counts (G, R) int32 = min(valid, k_out)
    when with_counts, else None.  CPU tensors take the plain version;
    CUDA tensors launch K2."""
    if planes.dim() != 4 or planes.shape[-1] != LANES or \
            not 1 <= planes.shape[0] <= 4 or not 1 <= k_out <= LANES:
        raise ValueError(f"compact_rows takes (kw<=4, G, R, 128) planes and "
                         f"1 <= k_out <= 128, got {tuple(planes.shape)}, "
                         f"{k_out}")
    if planes.device.type == "cpu":
        return compact_rows_plain(planes, k_out, with_counts=with_counts)
    dev = planes.device
    build.require(planes, "planes", torch.int32, 4, dev)
    kw, g, r, _ = planes.shape
    out = torch.empty((kw, g, r, k_out), dtype=torch.int32, device=dev)
    counts = (torch.empty((g, r), dtype=torch.int32, device=dev)
              if with_counts else None)
    build.launch("sks_compact_rows", dev, planes.data_ptr(), kw, g * r,
                 k_out, out.data_ptr(),
                 counts.data_ptr() if counts is not None else None)
    K2.launches += 1
    return out, counts


def compact_rows_plain(planes: torch.Tensor, k_out: int, *,
                       with_counts: bool = False):
    """Plain PyTorch version of K2 (any device): stable compaction by a
    per-row cumsum and a scatter."""
    kw, g, r, lanes = planes.shape
    valid = _valid(planes)
    cum = valid.cumsum(-1)
    sel = valid & (cum <= k_out)
    base = torch.arange(g * r, device=planes.device).reshape(g, r, 1) * k_out
    dst = (base + cum - 1)[sel]
    out = torch.full((kw, g * r * k_out), -1, dtype=torch.int32,
                     device=planes.device)
    out[:, dst] = planes[:, sel]
    counts = cum[..., -1].clamp(max=k_out).to(torch.int32) \
        if with_counts else None
    return out.reshape(kw, g, r, k_out), counts


def compact_global(planes: torch.Tensor) -> torch.Tensor:
    """planes (kw, G, n) int32 -> same shape, each genome row's valid
    entries moved to the front in order, all-ones tail.  CPU tensors take
    the plain version; CUDA tensors launch K3 (three kernels: tile counts,
    their offsets, the ranked scatter), whose count scratch is sized by
    the library."""
    if planes.dim() != 3 or not 1 <= planes.shape[0] <= 4:
        raise ValueError(f"compact_global takes (kw<=4, G, n) planes, got "
                         f"{tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return compact_global_plain(planes)
    dev = planes.device
    build.require(planes, "planes", torch.int32, 3, dev)
    kw, g, n = planes.shape
    out = torch.empty_like(planes)
    if g == 0 or n == 0:
        return out
    scratch = torch.empty(build.lib().sks_compact_global_scratch(g, n),
                          dtype=torch.int32, device=dev)
    build.launch("sks_compact_global", dev, planes.data_ptr(), kw, g, n,
                 scratch.data_ptr(), out.data_ptr())
    K3.launches += 1
    return out


def compact_global_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device): stable compaction by a
    per-row cumsum and a scatter."""
    kw, g, n = planes.shape
    valid = _valid(planes)
    cum = valid.cumsum(-1)
    base = torch.arange(g, device=planes.device).reshape(g, 1) * n
    dst = (base + cum - 1)[valid]
    out = torch.full((kw, g * n), -1, dtype=torch.int32,
                     device=planes.device)
    out[:, dst] = planes[:, valid]
    return out.reshape(kw, g, n)
