"""K4: batched lexicographic ascending sort of multi-word keys (csrc/sort.cu).

Sorts each genome row of stacked planes (kw, G, N) int32 holding u32 words,
word kw-1 most significant, N a power of two >= 1024; all-ones sentinels
sort last.  The JAX entry is bitonic_sort_128 on (N, W) keys, batched by
the finish's vmap.
"""
from __future__ import annotations

import torch

from .. import u64ops
from . import build

K4 = build.KERNELS["K4"]


def sort_rows(planes: torch.Tensor) -> torch.Tensor:
    """planes (kw, G, N) int32 -> a sorted copy.  CPU tensors take the plain
    version; CUDA tensors launch K4."""
    if planes.dim() != 3 or not 1 <= planes.shape[0] <= 4:
        raise ValueError(f"sort_rows takes (kw<=4, G, N) planes, got "
                         f"{tuple(planes.shape)}")
    n = planes.shape[2]
    if n < 1024 or n & (n - 1):
        raise ValueError(f"N must be a power of two >= 1024, got {n}")
    if planes.device.type == "cpu":
        return sort_rows_plain(planes)
    dev = planes.device
    build.require(planes, "planes", torch.int32, 3, dev)
    kw, g, _ = planes.shape
    out = torch.empty_like(planes)
    err = build.lib().sks_sort_rows(planes.data_ptr(), out.data_ptr(), kw, g,
                                    n, build.stream_ptr(dev))
    build.check(err, "sks_sort_rows")
    K4.launches += 1
    return out


def sort_rows_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (any device): LSD radix over words —
    one stable torch.sort per word, lowest word first, on int64-held u32
    values, composing the permutation."""
    kw = planes.shape[0]
    perm = None
    for q in range(kw):
        key = u64ops.as_u32(planes[q])
        if perm is not None:
            key = key.gather(-1, perm)
        order = torch.sort(key, dim=-1, stable=True).indices
        perm = order if perm is None else perm.gather(-1, order)
    return torch.stack([planes[q].gather(-1, perm) for q in range(kw)])
