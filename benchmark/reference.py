"""The plain reference: the reference tool's pipeline in NumPy.

Independent of the program under test (it imports nothing of it and no
native library) and written from the reference C++ tool's semantics
(github.com/bensonlzl/spaced-kmer-sketching):

  * FASTA records (src/fasta_processing.cpp:79-131): lines split on '\\n';
    '>' starts a record, an empty line ends one and keeps its name, a
    sequence line with a space drops the record, lines before the first
    header are ignored; each record is cut into maximal ACGT runs
    (case-insensitive A/C/G/T -> 0/1/2/3) at every other character;
  * the spaced mask (src/kmer_bitset.cpp:132-152): std::shuffle of
    [0, window) by std::mt19937(seed), the first k positions, both bits of
    each (bit 2p is position p, p = 0 the window's newest nucleotide);
  * keys (src/kmer_sliding.cpp:112-186): for each window of a run, the
    forward value F = sum_j c[i + w-1-j] << 2j and the reverse complement
    R = sum_j (3 - c[i+j]) << 2j, both masked with the same mask; the key
    is F if F < R as 128-bit numbers, else R;
  * the filter (src/kmer.hpp:135-149, src/kmer-sketching.cpp:29-34): keep a
    key iff (H(key) ^ H(mask) ^ window ^ nonce) % scale == 0, H boost's
    hash of a 128-bit dynamic_bitset;
  * a sketch is the set of kept keys; containment |A & B| / |A| (0 for an
    empty intersection), ANI containment ** (1 / k) (src/ani_estimation.cpp);
  * the CSV (src/kmer-sketching.cpp:46-81): header, then
    `file1,file2,%g value,window,128-bit mask MSB first` per ordered pair.

Keys are held as two uint64 arrays (lo = bits 0-63, hi = bits 64-127).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .mt19937 import libstdcxx_shuffle

U64 = np.uint64
GOLDEN32 = U64(0x9E3779B9)
MIX_M = U64(0x0E9846AF9B1A615D)
LEGACY_M = U64(0xC6A4A7935BD1E995)
LEGACY_ADD = U64(0xE6546B64)
CSV_HEADER = "File 1,File 2,Estimated Value,Window Size,Mask"
CHUNK = 1 << 20          # windows hashed at a time (bounds the temporaries)

_CODE = np.full(256, 4, np.uint8)
for _c, _v in zip(b"ACGT", range(4)):
    _CODE[_c] = _v
    _CODE[ord(chr(_c).lower())] = _v


# --- FASTA ------------------------------------------------------------------

def fasta_records(data: bytes) -> List[bytes]:
    """Record sequences of a FASTA file, by the reference's line rules."""
    records: List[bytes] = []
    name = b""
    content: List[bytes] = []
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    for line in lines:
        if line == b"" or line[:1] == b">":
            if name:
                records.append(b"".join(content))
            if line:
                name = line[1:]
            content = []
        elif name:
            if b" " in line:
                name, content = b"", []
            else:
                content.append(line)
    if name:
        records.append(b"".join(content))
    return records


def acgt_runs(records: Iterable[bytes]) -> List[np.ndarray]:
    """Maximal runs of ACGT codes (uint8 0..3) of the records."""
    runs = []
    for rec in records:
        codes = _CODE[np.frombuffer(rec, np.uint8)]
        ok = np.concatenate(([0], (codes < 4).view(np.int8), [0]))
        edges = np.flatnonzero(np.diff(ok))
        runs.extend(codes[s:e] for s, e in zip(edges[0::2], edges[1::2]))
    return runs


def read_fasta_runs(path: str) -> List[np.ndarray]:
    with open(path, "rb") as f:
        return acgt_runs(fasta_records(f.read()))


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """16 codes a 32-bit word, least significant first -> the first n."""
    w = np.ascontiguousarray(words).view(np.uint32)
    shifts = 2 * np.arange(16, dtype=np.uint32)
    return ((w[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)[:n]


# --- mask and hash ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mask:
    window: int
    k: int
    value: int               # 128-bit mask

    @property
    def positions(self) -> List[int]:
        return [p for p in range(self.window) if self.value >> (2 * p) & 1]

    @property
    def lo(self) -> int:
        return self.value & 0xFFFFFFFFFFFFFFFF

    @property
    def hi(self) -> int:
        return self.value >> 64

    def bitstring(self) -> str:
        return format(self.value, "0128b")


def spaced_mask(window: int, k: int, seed: int = 0) -> Mask:
    v = 0
    for p in libstdcxx_shuffle(list(range(window)), seed)[:k]:
        v |= 0b11 << (2 * p)
    return Mask(window, k, v)


def _mix(x: np.ndarray) -> np.ndarray:
    """boost's hash_mix for a 64-bit size_t (boost >= 1.81), in place."""
    x ^= x >> U64(32)
    x *= MIX_M
    x ^= x >> U64(32)
    x *= MIX_M
    x ^= x >> U64(28)
    return x


def _combine(seed, value, variant: str) -> np.ndarray:
    """boost::hash_combine(seed, value) of an integral value."""
    with np.errstate(over="ignore"):
        if variant == "modern":
            return _mix(np.asarray(seed, U64) + GOLDEN32 + value)
        k = np.asarray(value, U64) * LEGACY_M
        k ^= k >> U64(47)
        k *= LEGACY_M
        return (np.asarray(seed, U64) ^ k) * LEGACY_M + LEGACY_ADD


def hash128(lo, hi, variant: str = "modern") -> np.ndarray:
    """boost::hash_value of a 128-bit dynamic_bitset with blocks [lo, hi]:
    hash_combine(128, hash_range(blocks))."""
    lo = np.asarray(lo, U64)
    inner = _combine(_combine(np.zeros_like(lo), lo, variant),
                     np.asarray(hi, U64), variant)
    return _combine(np.full_like(lo, 128), inner, variant)


def salt(mask: Mask, nonce: int = 1, variant: str = "modern") -> int:
    """H(mask) ^ window ^ nonce: boost's hash of a small int is the int."""
    h = hash128(U64(mask.lo), U64(mask.hi), variant)
    return int(h ^ U64(mask.window) ^ U64(nonce))


# --- sketches ---------------------------------------------------------------

def _masked_window(src: np.ndarray, starts: Sequence[int],
                   shifts: Sequence[int], m: int) -> np.ndarray:
    out = np.zeros(m, U64)
    tmp = np.empty(m, U64)
    for a, s in zip(starts, shifts):
        np.left_shift(src[a:a + m], U64(s), out=tmp)
        out |= tmp
    return out


def run_keys(codes: np.ndarray, mask: Mask, salt_: int, scale: int,
             variant: str = "modern", fingerprint: bool = False):
    """Kept canonical keys of one ACGT run as (lo, hi) uint64 arrays, one
    entry per kept window (duplicates included).  With fingerprint=True the
    keys are replaced by the low 32 bits of their hash (the control)."""
    w = mask.window
    nw = codes.size - w + 1
    if nw <= 0:
        return np.empty(0, U64), np.empty(0, U64)
    fwd = codes.astype(U64)
    rev = (3 - codes).astype(U64)
    pos = mask.positions
    parts_lo, parts_hi = [], []
    for c0 in range(0, nw, CHUNK):
        m = min(CHUNK, nw - c0)
        f, r = fwd[c0:c0 + m + w - 1], rev[c0:c0 + m + w - 1]
        low = [p for p in pos if p < 32]
        high = [p for p in pos if p >= 32]
        f_lo = _masked_window(f, [w - 1 - p for p in low],
                              [2 * p for p in low], m)
        r_lo = _masked_window(r, low, [2 * p for p in low], m)
        f_hi = _masked_window(f, [w - 1 - p for p in high],
                              [2 * p - 64 for p in high], m)
        r_hi = _masked_window(r, high, [2 * p - 64 for p in high], m)
        fwd_lt = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo < r_lo))
        lo = np.where(fwd_lt, f_lo, r_lo)
        hi = np.where(fwd_lt, f_hi, r_hi)
        h = hash128(lo, hi, variant)
        keep = (h ^ U64(salt_)) % U64(scale) == 0
        if fingerprint:
            parts_lo.append(h[keep] & U64(0xFFFFFFFF))
            parts_hi.append(np.zeros(int(keep.sum()), U64))
        else:
            parts_lo.append(lo[keep])
            parts_hi.append(hi[keep])
    return np.concatenate(parts_lo), np.concatenate(parts_hi)


def sketch(runs: Sequence[np.ndarray], mask: Mask, nonce: int = 1,
           scale: int = 200, variant: str = "modern",
           fingerprint: bool = False) -> np.ndarray:
    """The sketch of a genome: its distinct kept keys, as a sorted (n, 2)
    uint64 array of (hi, lo) rows."""
    s = salt(mask, nonce, variant)
    los, his = [], []
    for run in runs:
        lo, hi = run_keys(run, mask, s, scale, variant, fingerprint)
        los.append(lo)
        his.append(hi)
    if not los:
        return np.empty((0, 2), U64)
    keys = np.stack([np.concatenate(his), np.concatenate(los)], axis=1)
    return np.unique(keys, axis=0)


def intersections(sketches: Sequence[np.ndarray],
                  chunk: int = 1 << 18) -> np.ndarray:
    """(G, G) int64 |A_i & A_j| of distinct-key sketches: the products of
    0/1 membership columns, `chunk` distinct keys at a time (float32 sums
    of at most `chunk` ones are exact)."""
    g = len(sketches)
    if g == 0:
        return np.zeros((0, 0), np.int64)
    keys = np.concatenate(sketches)
    gid = np.repeat(np.arange(g), [s.shape[0] for s in sketches])
    _, key_id = np.unique(keys, axis=0, return_inverse=True)
    key_id = key_id.reshape(-1)
    out = np.zeros((g, g), np.float64)
    for c0 in range(0, int(key_id.max(initial=-1)) + 1, chunk):
        sel = (key_id >= c0) & (key_id < c0 + chunk)
        member = np.zeros((chunk, g), np.float32)
        member[key_id[sel] - c0, gid[sel]] = 1
        out += member.T @ member
    return out.astype(np.int64)


def ani(inter: np.ndarray, counts: np.ndarray, k: int,
        dtype=np.float64) -> np.ndarray:
    """Row-major ANI of every ordered pair: containment over the FIRST
    set's size, then containment ** (1 / k); 0 where the intersection is
    empty.  dtype=float32 is the control's lower precision."""
    inter = np.asarray(inter).reshape(-1)
    first = np.repeat(np.asarray(counts), len(counts))
    out = np.zeros(inter.size, np.float64)
    hit = inter > 0
    c = inter[hit].astype(dtype) / first[hit].astype(dtype)
    out[hit] = np.power(c, dtype(1.0) / dtype(k))
    return out


def csv_rows(names: Sequence[str], values: Sequence[float], mask: Mask
             ) -> List[str]:
    """The CSV rows of an all-ordered-pairs experiment."""
    g = len(names)
    bits = mask.bitstring()
    return [f"{names[i]},{names[j]},{float(values[i * g + j]):g},"
            f"{mask.window},{bits}" for i in range(g) for j in range(g)]


def experiment(runs_per_genome: Sequence[Sequence[np.ndarray]], window: int,
               k: int, *, seed: int = 0, nonce: int = 1, scale: int = 200,
               variant: str = "modern") -> Tuple[Mask, np.ndarray,
                                                 np.ndarray]:
    """One (window, k) experiment: (mask, counts, (G, G) intersections)."""
    mask = spaced_mask(window, k, seed)
    sk = [sketch(r, mask, nonce, scale, variant) for r in runs_per_genome]
    return mask, np.array([s.shape[0] for s in sk], np.int64), \
        intersections(sk)
