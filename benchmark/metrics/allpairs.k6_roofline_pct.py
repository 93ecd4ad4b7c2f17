"""allpairs.k6_roofline_pct: K6 (csrc/gram_tiles.cu, gram_mma_kernel)
against its byte bound at the card's HBM rate.  The bytes are those the
inputs need, whatever implements the kernel: per upper-triangle tile of
blocks (b1 <= b2), the merged stream of both blocks' valid entries read
once (one block's on the diagonal), 8 B an entry (a 40-bit key and its
genome id in one 64-bit word), and its 128 x 128 int32 counts written
once."""
import numpy as np

from benchmark import peaks, trace

KERNELS = ("gram_mma_kernel",)
BLOCK = 128
ENTRY = 8


def block_entries(counts):
    """Valid entries (sketch sizes) of each block of BLOCK genomes."""
    c = np.asarray(counts, np.int64)
    nb = -(-c.size // BLOCK)
    return np.bincount(np.arange(c.size) // BLOCK, c, nb)


def bytes_needed(counts) -> float:
    n = block_entries(counts)
    nb = n.size
    # every block's stream is read by the nb tiles of its row and column
    return ENTRY * nb * float(n.sum()) + nb * (nb + 1) // 2 * BLOCK ** 2 * 4


def read(run):
    if run.trace is None or not run.records:
        return None
    s = trace.device_seconds(run.trace, KERNELS)
    if not s:
        return None
    need = sum(bytes_needed(r["counts"]) for r in run.records)
    return 100.0 * need / peaks.peak(run.device_kind, "hbm_bytes_per_s") / s
