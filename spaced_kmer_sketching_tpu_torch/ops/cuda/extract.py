"""K1: fused extract + hash + filter + per-row compaction (csrc/extract.cu).

Contract (the JAX entry extract_compact_windows_prepacked with the window
as a runtime value): for every genome g and window t < rows * 128, with
rows = ceil(nw / 32768) * 256 as the JAX kernel's block grid gives it,
compute the canonical masked key and keep it iff the window is valid and
(boost_hash(key) ^ salt) % scale == 0.  Each 128-window row emits its first
k_slots kept keys in window order, all-ones fill after them, and its TRUE
kept count.

The genome arrives as raw 2-bit words, 16 codes per u32, LSB first
(utils/native.pack2bit), plus an int32 run-id plane that is -1 on padding;
the JAX kernel's 16x-repeated window-index planes do not exist here.
Key words travel as int32 tensors holding the u32 bits.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ...utils import native
from .. import u64ops
from ..extract import extract_windows
from . import build

BLOCK = 32768                      # windows per JAX kernel grid step
LANES = 128
K1 = build.KERNELS["K1"]


def out_rows(nw: int) -> int:
    """Output rows of 128 windows for `nw` windows (the JAX block grid)."""
    return (nw + BLOCK - 1) // BLOCK * (BLOCK // LANES)


def pack2bit_rows(codes: np.ndarray) -> np.ndarray:
    """(G, n) uint8 codes 0..3, n a multiple of 16 -> (G, n // 16) uint32,
    16 codes per word LSB-first (native when built, numpy otherwise)."""
    g, n = codes.shape
    if native.available():
        return np.stack([native.pack2bit(row, n // 16) for row in codes])
    c = codes.reshape(g, n // 16, 16).astype(np.uint32)
    return (c << (2 * np.arange(16, dtype=np.uint32))).sum(
        -1, dtype=np.uint32)


def _check(packed, run_id, window, k_slots, out_words) -> None:
    if packed.dim() != 2 or run_id.dim() != 2 or \
            packed.shape[0] != run_id.shape[0]:
        raise ValueError(f"packed {tuple(packed.shape)} and run_id "
                         f"{tuple(run_id.shape)} must be (G, words), (G, n)")
    if 16 * packed.shape[1] < run_id.shape[1]:
        raise ValueError("packed words must cover every run-id position")
    if not (1 <= window <= 64 and 1 <= k_slots <= LANES
            and 1 <= out_words <= 4):
        raise ValueError(f"window {window}, k_slots {k_slots} or out_words "
                         f"{out_words} out of range")


def extract_compact(packed: torch.Tensor, run_id: torch.Tensor,
                    mask_words: Sequence[int], salt: int, *, window: int,
                    nw: int, scale: int, variant: str, k_slots: int,
                    out_words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed (G, P) int32 (u32 bits), run_id (G, n) int32 ->
    (planes (out_words, G, rows * k_slots) int32, rowcnt (G, rows) int32).

    mask_words: the mask's 4 u32 words; salt: the 64-bit FracMinHash salt.
    CPU tensors take the plain version; CUDA tensors launch K1."""
    _check(packed, run_id, window, k_slots, out_words)
    if packed.device.type == "cpu":
        return extract_compact_plain(
            packed, run_id, mask_words, salt, window=window, nw=nw,
            scale=scale, variant=variant, k_slots=k_slots,
            out_words=out_words)
    dev = packed.device
    build.require(packed, "packed", torch.int32, 2, dev)
    build.require(run_id, "run_id", torch.int32, 2, dev)
    if variant not in ("modern", "legacy"):
        raise ValueError(f"unknown hash variant {variant!r}")
    g, pw = packed.shape
    n = run_id.shape[1]
    rows = out_rows(nw)
    out = torch.empty((out_words, g, rows * k_slots), dtype=torch.int32,
                      device=dev)
    rowcnt = torch.empty((g, rows), dtype=torch.int32, device=dev)
    m = [int(x) for x in mask_words]
    err = build.lib().sks_extract_compact(
        packed.data_ptr(), pw, run_id.data_ptr(), n, g, rows, window,
        m[0] | m[1] << 32, m[2] | m[3] << 32, salt, scale,
        int(variant == "legacy"), k_slots, out_words, out.data_ptr(),
        rowcnt.data_ptr(), build.stream_ptr(dev))
    build.check(err, "sks_extract_compact")
    K1.launches += 1
    return out, rowcnt


def extract_compact_plain(packed, run_id, mask_words, salt, *, window: int,
                          nw: int, scale: int, variant: str, k_slots: int,
                          out_words: int):
    """Plain PyTorch version of K1 (any device): unpack the codes,
    extract (ops/extract.py), filter (ops/u64ops.fmh_keep), then select
    each row's first k_slots kept windows by a cumsum."""
    _check(packed, run_id, window, k_slots, out_words)
    g = packed.shape[0]
    n = run_id.shape[1]
    rows = out_rows(nw)
    span = rows * LANES + window - 1          # codes the windows touch
    dev = packed.device
    shifts = 2 * torch.arange(16, device=dev)
    codes = ((u64ops.as_u32(packed)[..., None] >> shifts) & 3).reshape(g, -1)
    cfull = torch.zeros((g, span), dtype=torch.int64, device=dev)
    c = min(codes.shape[1], span)
    cfull[:, :c] = codes[:, :c]
    rfull = torch.full((g, span), -1, dtype=torch.int64, device=dev)
    r = min(n, span)
    rfull[:, :r] = run_id[:, :r]

    canon, valid = extract_windows(cfull, rfull, window, mask_words)
    keep = valid & u64ops.fmh_keep(*canon, salt=salt, scale=scale,
                                   variant=variant)
    keep = keep.reshape(g, rows, LANES)
    cum = keep.cumsum(-1)
    rowcnt = cum[..., -1].to(torch.int32)
    sel = keep & (cum <= k_slots)
    base = torch.arange(g * rows, device=dev).reshape(g, rows, 1) * k_slots
    dst = (base + cum - 1)[sel]
    out = torch.full((out_words, g * rows * k_slots), -1, dtype=torch.int32,
                     device=dev)
    for q in range(out_words):
        out[q, dst] = u64ops.as_i32(canon[q].reshape(g, rows, LANES)[sel])
    return out.reshape(out_words, g, rows * k_slots), rowcnt
