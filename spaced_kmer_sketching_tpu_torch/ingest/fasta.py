"""FASTA ingest: parse + 2-bit pack, replicating the reference's semantics.

Record semantics (src/fasta_processing.cpp:79-131):
  * lines are split on '\\n' only ('\\r' survives and later splits runs as a
    non-ACGT character);
  * a line starting with '>' flushes the current record and starts a new name;
  * an EMPTY line flushes the current record but KEEPS the name (so sequence
    after a blank line becomes a separate record under the same name);
  * a sequence line containing a space character DISCARDS the whole current
    record (name and content cleared) — quirk at fasta_processing.cpp:114-118;
  * sequence lines before any '>' header are ignored;
  * a missing file raises FileNotFoundError (reference exit(1)s,
    fasta_processing.cpp:86-90).

Each record is then cut into maximal ACGT-only runs at non-ACGT characters
(case-insensitive A/C/G/T -> 0/1/2/3, complement = code ^ 3;
 fasta_processing.cpp:35-69,144-198).

The packed representation returned — one flat uint8 code array plus per-run
lengths — is the device-ready layout: the extraction kernels consume
(codes, run boundaries) directly.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..observability import get_logger
from ..utils import native

log = get_logger(__name__)

_CODE = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE[ord(_c)] = _v
    _CODE[ord(_c.lower())] = _v


@dataclasses.dataclass
class PackedSeqs:
    """2-bit-packed ACGT runs of one genome (device-ready host layout)."""
    codes: np.ndarray     # (total,) uint8, values 0..3, runs concatenated
    run_lens: np.ndarray  # (n_runs,) int64

    def total_windows(self, window: int) -> int:
        if self.run_lens.size == 0:
            return 0
        return int(np.maximum(self.run_lens - window + 1, 0).sum())

    @property
    def run_starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.run_lens)[:-1]]).astype(np.int64)


def records_from_fasta_text(text: str, path: Optional[str] = None) -> List[str]:
    """Record strings per the reference's line rules (pure-Python path).

    With `path` given and INFO logging enabled, each flushed record logs
    "Read <name> from file <path>" — the reference's per-record LOGGING
    line (fasta_processing.cpp:102-103,127-128)."""
    info = path is not None and log.isEnabledFor(logging.INFO)
    records: List[str] = []
    name = ""
    content: List[str] = []
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()  # std::getline never yields a line after the final '\n'
    for line in lines:
        if line == "" or line[0] == ">":
            if name:
                if info:
                    log.info("Read %s from file %s", name, path)
                records.append("".join(content))
            if line:
                name = line[1:]
            content = []
        elif name:
            if " " in line:
                name = ""
                content = []
            else:
                content.append(line)
    if name:
        if info:
            log.info("Read %s from file %s", name, path)
        records.append("".join(content))
    return records


def _cut_runs(records: Iterable[str]) -> Tuple[np.ndarray, np.ndarray]:
    codes_parts: List[np.ndarray] = []
    run_lens: List[int] = []
    for rec in records:
        raw = np.frombuffer(rec.encode("latin-1"), dtype=np.uint8)
        c = _CODE[raw]
        ok = c < 4
        if not ok.any():
            continue
        # maximal ACGT runs: boundaries where validity changes
        idx = np.flatnonzero(np.diff(np.concatenate(([0], ok.view(np.int8), [0]))))
        starts, ends = idx[0::2], idx[1::2]
        for s, e in zip(starts, ends):
            codes_parts.append(c[s:e])
            run_lens.append(int(e - s))
    if not codes_parts:
        return np.empty(0, dtype=np.uint8), np.empty(0, dtype=np.int64)
    return np.concatenate(codes_parts), np.asarray(run_lens, dtype=np.int64)


def read_fasta(path: str, use_native: bool = True) -> PackedSeqs:
    """Parse + pack a FASTA file into PackedSeqs (native fast path if built).

    With INFO logging enabled the parse routes through the Python parser
    so every record emits the reference's per-record line "Read <name>
    from file <f>" (fasta_processing.cpp:102-103,127-128) — mirroring the
    reference, whose LOGGING build also pays its logging cost in the
    parse loop; the native parser does not track record names."""
    if (use_native and native.available()
            and not log.isEnabledFor(logging.INFO)):
        parsed = native.fasta_parse(path)
        if parsed is not None:
            codes, run_lens = parsed
            return PackedSeqs(codes=codes, run_lens=run_lens)
    try:
        with open(path, "r", newline="") as f:
            text = f.read()
    except OSError as e:
        raise FileNotFoundError(f"Unable to open {path}") from e
    # match std::getline: records split on '\n'; drop nothing else
    codes, run_lens = _cut_runs(records_from_fasta_text(text, path))
    return PackedSeqs(codes=codes, run_lens=run_lens)
