"""Structured logging, counters and timing spans.

The reference's only observability is two chrono spans printed to stdout
(src/kmer-sketching.cpp:166-175,202-203) and compile-time LOGGING prints.
Here: stdlib logging + named wall-clock spans (the two reference spans are
emitted with the exact same stdout wording for comparability) + a process-
global counter registry that doubles as a parity check channel (sequences,
runs, windows, kept k-mers, set sizes).
"""
from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict

_counters: Dict[str, int] = defaultdict(int)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def count(name: str, inc: int = 1) -> None:
    _counters[name] += inc


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


@contextlib.contextmanager
def span(name: str, log: logging.Logger | None = None, echo: bool = False):
    """Wall-clock span; with echo=True prints the reference's stdout format:
    'Time taken for <name> = <ms> ms' (src/kmer-sketching.cpp:175,203)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        if echo:
            print(f"Time taken for {name} = {ms} ms")
        if log is not None:
            log.debug("span %s = %.3f ms", name, ms)
        _counters[f"span_ms.{name}"] = int(ms)
