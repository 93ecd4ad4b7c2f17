"""K1, K7 and K11: fused extract + hash + filter (csrc/extract.cu, one
kernel template with two sources of run ids and two outputs).

K1 and K7 contract (the JAX entries extract_compact_windows_prepacked and
extract_compact_windows_raw, with the window as a runtime value): for every
genome g and window t < rows * 128, with rows = ceil(nw / 32768) * 256 as
the JAX kernels' block grid gives it, compute the canonical masked key and
keep it iff the window is valid and (boost_hash(key) ^ salt) % scale == 0.
Each 128-window row emits its first k_slots kept keys in window order,
all-ones fill after them, and its TRUE kept count.  Seed-batch mode (the
JAX `batch=S` over one shared genome, BASELINE config 3): mask_words (S, 4)
and salt S ints run S seeds over the ONE genome row of the inputs in one
launch; the outputs have one row per seed.

K11 contract (the JAX extract_filter_windows_batched): codes and run ids
(G, n) -> every window's canonical key and keep flag, nw = n - window + 1
windows, no compaction.  The key is defined at every window, valid or not.

The genome arrives as raw 2-bit words, 16 codes per u32, LSB first
(utils/native.pack2bit, or pack_codes on the device); the JAX kernels'
16x-repeated window-index planes do not exist here.  The run ids come from
an int32 plane that is -1 on padding (K1, `extract_compact`; K11) or from
each genome's sorted run starts, the id of the run open at position 0 and
its code count (K7, `extract_compact_raw`, the compact uploads of
streaming segments, of the device pipeline and of multi-seed sketching).
Key words travel as int32 tensors holding the u32 bits.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils import native
from .. import u64ops
from ..extract import extract_windows
from . import build

BLOCK = 32768                      # windows per JAX kernel grid step
LANES = 128
HALO = 1024                        # codes the JAX kernel reads past a block
K1 = build.KERNELS["K1"]
K7 = build.KERNELS["K7"]
K11 = build.KERNELS["K11"]


def out_rows(nw: int) -> int:
    """Output rows of 128 windows for `nw` windows (the JAX block grid)."""
    return (nw + BLOCK - 1) // BLOCK * (BLOCK // LANES)


def packed_body(n: int) -> int:
    """Window-independent padded code count of an n-nt compact upload (the
    JAX package's ops/pallas/extract.packed_body): the largest window-block
    grid plus the trailing halo, so K7's input shape matches JAX's."""
    return (n + BLOCK - 1) // BLOCK * BLOCK + HALO


def pack2bit(codes: np.ndarray, words: int) -> np.ndarray:
    """(n,) uint8 codes 0..3 -> (words,) uint32, 16 codes per word
    LSB-first, positions past n as code 0 (native when built, numpy
    otherwise)."""
    if native.available():
        return native.pack2bit(codes, words)
    c = np.zeros(16 * words, np.uint32)
    c[:codes.size] = codes
    return (c.reshape(words, 16) << (2 * np.arange(16, dtype=np.uint32))
            ).sum(-1, dtype=np.uint32)


def pack2bit_rows(codes: np.ndarray) -> np.ndarray:
    """(G, n) uint8 codes 0..3, n a multiple of 16 -> (G, n // 16) uint32
    (pack2bit of each row)."""
    return np.stack([pack2bit(row, codes.shape[1] // 16) for row in codes])


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(G, n) integer codes 0..3 -> (G, ceil(n / 16)) int32 (u32 bits), 16
    codes per word LSB first, positions past n as code 0: pack2bit on the
    codes' device."""
    g, n = codes.shape
    c = torch.zeros((g, -(-n // 16) * 16), dtype=torch.int64,
                    device=codes.device)
    c[:, :n] = codes
    shifts = 2 * torch.arange(16, device=codes.device)
    return u64ops.as_i32((c.reshape(g, -1, 16) << shifts).sum(-1))


def fmh_divisor(scale: int) -> Tuple[int, int]:
    """(magic, l): the round-up reciprocal of `scale` (Granlund and
    Montgomery 1994, figure 4.1) that the kernels' filter takes in place of
    a division.  l = ceil(log2 scale) and magic = floor(2^64 (2^l - scale)
    / scale) + 1 < 2^64; then for every 64-bit h, with t the high word of
    magic * h, floor(h / scale) = (t + ((h - t) >> min(l, 1))) >> max(l -
    1, 0), so h % scale is h less that times scale.  scale in 1..2^31 - 1."""
    if not 1 <= scale < 2 ** 31:
        raise ValueError(f"scale must lie in [1, 2^31), got {scale}")
    l = (scale - 1).bit_length()
    return (2 ** 64 * (2 ** l - scale)) // scale + 1, l


def _seed_rows(mask_words, salt) -> Optional[np.ndarray]:
    """None for one seed (mask_words 4 ints, salt an int); for S seeds
    (mask_words (S, 4), salt S ints) the (S, 3) uint64 rows [mask_lo,
    mask_hi, salt] that seed-batch mode reads."""
    m = np.asarray(mask_words, dtype=np.uint64)
    if m.ndim == 1:
        if m.shape != (4,) or np.ndim(salt) != 0:
            raise ValueError("one seed takes 4 mask words and one salt")
        return None
    salts = np.asarray([int(x) for x in salt], dtype=np.uint64)
    if m.ndim != 2 or m.shape[1] != 4 or salts.shape != (m.shape[0],) \
            or m.shape[0] < 1:
        raise ValueError(f"seed-batch mode takes (S, 4) masks and S salts, "
                         f"got {m.shape} and {salts.shape}")
    return np.stack([m[:, 0] | m[:, 1] << np.uint64(32),
                     m[:, 2] | m[:, 3] << np.uint64(32), salts], axis=1)


def _seed_args(rows: Optional[np.ndarray], mask_words, salt, dev):
    """The C entries' (mask_lo, mask_hi, salt, seeds) arguments; `keep`
    holds the uploaded rows alive until the launch is queued."""
    if rows is None:
        m = [int(x) for x in mask_words]
        return m[0] | m[1] << 32, m[2] | m[3] << 32, int(salt), None, None
    t = torch.from_numpy(rows.view(np.int64)).to(dev)
    return 0, 0, 0, t.data_ptr(), t


def _per_seed(plain, mask_words, salt):
    """A plain version over each seed of seed-batch mode, rows stacked."""
    outs = [plain(list(mw), int(sv)) for mw, sv in
            zip(np.asarray(mask_words, dtype=np.uint64), salt)]
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=0))


def _check(packed, run_id, window, k_slots, out_words) -> None:
    if packed.dim() != 2 or run_id.dim() != 2 or \
            packed.shape[0] != run_id.shape[0]:
        raise ValueError(f"packed {tuple(packed.shape)} and run_id "
                         f"{tuple(run_id.shape)} must be (G, words), (G, n)")
    if 16 * packed.shape[1] < run_id.shape[1]:
        raise ValueError("packed words must cover every run-id position")
    _check_args(window, k_slots, out_words)


def _check_args(window, k_slots, out_words) -> None:
    if not (1 <= window <= 64 and 1 <= k_slots <= LANES
            and 1 <= out_words <= 4):
        raise ValueError(f"window {window}, k_slots {k_slots} or out_words "
                         f"{out_words} out of range")


def extract_compact(packed: torch.Tensor, run_id: torch.Tensor,
                    mask_words, salt, *, window: int,
                    nw: int, scale: int, variant: str, k_slots: int,
                    out_words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed (G, P) int32 (u32 bits), run_id (G, n) int32 ->
    (planes (out_words, Y, rows * k_slots) int32, rowcnt (Y, rows) int32).

    mask_words: the mask's 4 u32 words and salt the 64-bit FracMinHash
    salt (Y = G); or (S, 4) masks and S salts over a single genome row
    (seed-batch mode, Y = S).  CPU tensors take the plain version; CUDA
    tensors launch K1."""
    _check(packed, run_id, window, k_slots, out_words)
    rows_s = _check_seeds(packed, mask_words, salt)
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
    y = g if rows_s is None else rows_s.shape[0]
    n = run_id.shape[1]
    rows = out_rows(nw)
    out = torch.empty((out_words, y, rows * k_slots), dtype=torch.int32,
                      device=dev)
    rowcnt = torch.empty((y, rows), dtype=torch.int32, device=dev)
    m_lo, m_hi, sv, seeds, _keep = _seed_args(rows_s, mask_words, salt, dev)
    build.launch(
        "sks_extract_compact", dev, packed.data_ptr(), pw, run_id.data_ptr(),
        n, y, rows, window, m_lo, m_hi, sv, seeds, scale, *fmh_divisor(scale),
        int(variant == "legacy"), k_slots, out_words, out.data_ptr(),
        rowcnt.data_ptr())
    K1.launches += 1
    return out, rowcnt


def _check_seeds(packed, mask_words, salt) -> Optional[np.ndarray]:
    rows = _seed_rows(mask_words, salt)
    if rows is not None and packed.shape[0] != 1:
        raise ValueError(f"seed-batch mode reads one genome row, got "
                         f"{packed.shape[0]}")
    return rows


def extract_compact_plain(packed, run_id, mask_words, salt, *, window: int,
                          nw: int, scale: int, variant: str, k_slots: int,
                          out_words: int):
    """Plain PyTorch version of K1 (any device): unpack the codes,
    extract (ops/extract.py), filter (ops/u64ops.fmh_keep), then select
    each row's first k_slots kept windows by a cumsum; seed-batch mode
    runs it once per seed."""
    _check(packed, run_id, window, k_slots, out_words)
    args = dict(window=window, nw=nw, scale=scale, variant=variant,
                k_slots=k_slots, out_words=out_words)
    if _check_seeds(packed, mask_words, salt) is not None:
        return _per_seed(lambda mw, sv: extract_compact_plain(
            packed, run_id, mw, sv, **args), mask_words, salt)
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


def _check_raw(packed, bounds, rid0, vlen) -> None:
    g = packed.shape[0]
    if packed.dim() != 2 or bounds.dim() != 2 or bounds.shape[0] != g \
            or tuple(rid0.shape) != (g,) or tuple(vlen.shape) != (g,):
        raise ValueError(f"packed {tuple(packed.shape)}, bounds "
                         f"{tuple(bounds.shape)}, rid0 {tuple(rid0.shape)} "
                         f"and vlen {tuple(vlen.shape)} must be (G, words), "
                         "(G, K), (G,), (G,)")


def extract_compact_raw(packed: torch.Tensor, bounds: torch.Tensor,
                        rid0: torch.Tensor, vlen: torch.Tensor,
                        mask_words, salt, *, window: int,
                        nw: int, scale: int, variant: str, k_slots: int,
                        out_words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's contract with the run ids given as bounds: packed (G, P) int32
    (u32 bits; positions past a genome packed as code 0), bounds (G, K)
    int32 sorted run starts (padding must lie at or past vlen, e.g. the
    body length), rid0 (G,) int32 the id of the run open at position 0,
    vlen (G,) int32 the code count.  The run id at position t is rid0 +
    #(bounds <= t) for t < min(vlen, 16 * P), else -1.  mask_words and
    salt as extract_compact's (seed-batch mode over one genome row).
    Returns (planes (out_words, Y, rows * k_slots) int32, rowcnt (Y, rows)
    int32).  CPU tensors take the plain version; CUDA tensors launch K7."""
    _check_raw(packed, bounds, rid0, vlen)
    rows_s = _check_seeds(packed, mask_words, salt)
    if packed.device.type == "cpu":
        return extract_compact_raw_plain(
            packed, bounds, rid0, vlen, mask_words, salt, window=window,
            nw=nw, scale=scale, variant=variant, k_slots=k_slots,
            out_words=out_words)
    dev = packed.device
    build.require(packed, "packed", torch.int32, 2, dev)
    build.require(bounds, "bounds", torch.int32, 2, dev)
    build.require(rid0, "rid0", torch.int32, 1, dev)
    build.require(vlen, "vlen", torch.int32, 1, dev)
    _check_args(window, k_slots, out_words)
    if variant not in ("modern", "legacy"):
        raise ValueError(f"unknown hash variant {variant!r}")
    g, pw = packed.shape
    y = g if rows_s is None else rows_s.shape[0]
    rows = out_rows(nw)
    out = torch.empty((out_words, y, rows * k_slots), dtype=torch.int32,
                      device=dev)
    rowcnt = torch.empty((y, rows), dtype=torch.int32, device=dev)
    m_lo, m_hi, sv, seeds, _keep = _seed_args(rows_s, mask_words, salt, dev)
    build.launch(
        "sks_extract_compact_raw", dev, packed.data_ptr(), pw,
        bounds.data_ptr(), bounds.shape[1], rid0.data_ptr(), vlen.data_ptr(),
        y, rows, window, m_lo, m_hi, sv, seeds, scale, *fmh_divisor(scale),
        int(variant == "legacy"), k_slots, out_words, out.data_ptr(),
        rowcnt.data_ptr())
    K7.launches += 1
    return out, rowcnt


def run_ids_from_bounds(bounds: torch.Tensor, rid0: torch.Tensor,
                        vlen: torch.Tensor, n: int) -> torch.Tensor:
    """(G, n) int32 run-id plane of K7's inputs: rid0 + #(bounds <= t) for
    t < vlen, else -1 (the expansion of the JAX sketch_batch_compact)."""
    g = bounds.shape[0]
    pos = torch.arange(n, device=bounds.device).expand(g, n).contiguous()
    r = rid0.long()[:, None] + torch.searchsorted(
        bounds.long().contiguous(), pos, right=True)
    return torch.where(pos < vlen.long()[:, None], r, -1).to(torch.int32)


def extract_compact_raw_plain(packed, bounds, rid0, vlen, mask_words, salt,
                              *, window: int, nw: int, scale: int,
                              variant: str, k_slots: int, out_words: int):
    """Plain PyTorch version of K7 (any device): expand the bounds into a
    run-id plane over the packed body, then K1's plain version."""
    _check_raw(packed, bounds, rid0, vlen)
    run_id = run_ids_from_bounds(bounds, rid0, vlen, 16 * packed.shape[1])
    return extract_compact_plain(
        packed, run_id, mask_words, salt, window=window, nw=nw, scale=scale,
        variant=variant, k_slots=k_slots, out_words=out_words)


def extract_filter(codes: torch.Tensor, run_id: torch.Tensor,
                   mask_words: Sequence[int], salt: int, *, window: int,
                   scale: int, variant: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes (G, n) integer 0..3, run_id (G, n) int32 -> (canon (4, G, nw)
    int32 every window's canonical key words (u32 bits), keep (G, nw)
    bool), nw = n - window + 1.  CPU tensors take the plain version; CUDA
    tensors are packed on the device (pack_codes) and launch K11."""
    _check_filter(codes, run_id, window)
    if codes.device.type == "cpu":
        return extract_filter_plain(codes, run_id, mask_words, salt,
                                    window=window, scale=scale,
                                    variant=variant)
    dev = codes.device
    build.require(run_id, "run_id", torch.int32, 2, dev)
    if variant not in ("modern", "legacy"):
        raise ValueError(f"unknown hash variant {variant!r}")
    g, n = codes.shape
    nw = n - window + 1
    packed = pack_codes(codes)
    canon = torch.empty((4, g, nw), dtype=torch.int32, device=dev)
    keep = torch.empty((g, nw), dtype=torch.bool, device=dev)
    m = [int(x) for x in mask_words]
    build.launch(
        "sks_extract_filter", dev, packed.data_ptr(), packed.shape[1],
        run_id.data_ptr(), n, g, nw, window, m[0] | m[1] << 32,
        m[2] | m[3] << 32, salt, scale, *fmh_divisor(scale),
        int(variant == "legacy"), canon.data_ptr(), keep.data_ptr())
    K11.launches += 1
    return canon, keep


def _check_filter(codes, run_id, window) -> None:
    if codes.dim() != 2 or tuple(run_id.shape) != tuple(codes.shape):
        raise ValueError(f"codes {tuple(codes.shape)} and run_id "
                         f"{tuple(run_id.shape)} must both be (G, n)")
    if not 1 <= window <= min(64, codes.shape[1]):
        raise ValueError(f"window {window} out of range for n = "
                         f"{codes.shape[1]}")


def extract_filter_plain(codes, run_id, mask_words, salt, *, window: int,
                         scale: int, variant: str):
    """Plain PyTorch version of K11 (any device): ops/extract.
    extract_windows, then ops/u64ops.fmh_keep on the valid windows."""
    _check_filter(codes, run_id, window)
    canon, valid = extract_windows(codes.long(), run_id.long(), window,
                                   mask_words)
    keep = valid & u64ops.fmh_keep(*canon, salt=salt, scale=scale,
                                   variant=variant)
    return torch.stack([u64ops.as_i32(c) for c in canon]), keep
