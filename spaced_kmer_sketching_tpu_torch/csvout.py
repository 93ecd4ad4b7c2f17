"""Results CSV writer, bit-compatible with the reference's output channel.

Reference `write_to_csv` (src/kmer-sketching.cpp:46-81):
  * header `File 1,File 2,Estimated Value,Window Size,Mask`, written only
    when not appending;
  * one row per pair: file1,file2,value,window,mask;
  * value printed with C++ default ostream formatting (6 significant
    digits, %g-style);
  * mask printed via boost dynamic_bitset operator<< — a 128-char binary
    string, MSB first (src/kmer-sketching.cpp:76);
  * row count = min of the three list lengths (src/kmer-sketching.cpp:73).
"""
from __future__ import annotations

from typing import Sequence

from .utils.masks import SpacedSeedMask

CSV_HEADER = "File 1,File 2,Estimated Value,Window Size,Mask"


def format_double(v: float) -> str:
    """C++ `ostream << double` default formatting: %g, 6 sig digits."""
    return f"{float(v):g}"


def write_to_csv(filenames1: Sequence[str], filenames2: Sequence[str],
                 estimated_values: Sequence[float], window_size: int,
                 mask: SpacedSeedMask, output_filename: str,
                 is_append: bool = False) -> None:
    mode = "a" if is_append else "w"
    n = min(len(filenames1), len(filenames2), len(estimated_values))
    with open(output_filename, mode) as f:
        if not is_append:
            f.write(CSV_HEADER + "\n")
        bits = mask.bitstring()
        for i in range(n):
            f.write(f"{filenames1[i]},{filenames2[i]},"
                    f"{format_double(estimated_values[i])},"
                    f"{window_size},{bits}\n")
