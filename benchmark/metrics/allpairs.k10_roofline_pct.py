"""allpairs.k10_roofline_pct: K10 (csrc/sort.cu, merge_pair_kernel)
against its byte bound at the card's HBM rate.  The bytes are those the
inputs need: per off-diagonal tile of blocks (b1 < b2), both blocks'
streams of valid entries read once and their merged stream written once,
8 B an entry."""
import numpy as np

from benchmark import peaks, trace

KERNELS = ("merge_pair_kernel",)
BLOCK = 128
ENTRY = 8


def bytes_needed(counts) -> float:
    c = np.asarray(counts, np.int64)
    nb = -(-c.size // BLOCK)
    n = np.bincount(np.arange(c.size) // BLOCK, c, nb)
    # every block is one side of nb - 1 off-diagonal tiles: read, written
    return 2 * ENTRY * (nb - 1) * float(n.sum())


def read(run):
    if run.trace is None or not run.records:
        return None
    s = trace.device_seconds(run.trace, KERNELS)
    if not s:
        return None
    need = sum(bytes_needed(r["counts"]) for r in run.records)
    return 100.0 * need / peaks.peak(run.device_kind, "hbm_bytes_per_s") / s
