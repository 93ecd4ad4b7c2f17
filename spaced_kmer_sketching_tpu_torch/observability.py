"""Structured logging, counters and timing spans.

The reference's only observability is two chrono spans printed to stdout
(src/kmer-sketching.cpp:166-175,202-203) and compile-time LOGGING prints.
Here: stdlib logging; a process-global registry of integer counters, each
a count of events (cache hits, bytes, the pipeline's blocking host
syncs) that a caller reads as the change over a stretch of work; and
named spans, host ranges timed on the host clock, whose seconds the caller
books.  While a torch.profiler run records, a span is also a
`record_function` range on the profiler's timeline, beside the device's
kernels and copies (`driver.py --profile DIR`), unless it is opened with
`trace=False`: a span taken hundreds of times a job (a dispatch, a wait)
is timed alone, since under the profiler ~1,400 such ranges cost an
all-pairs job of 10,240 genomes 0.1-0.2 s of an H100 host's time and
would skew the very trace they annotate.  The profiler records the
thread that started it: a span on another thread is timed but not
traced.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

_counters: Dict[str, int] = defaultdict(int)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def count(name: str, inc: int = 1) -> None:
    _counters[name] += inc


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


class span:
    """`with span(name) as s: ...` times the block on the host clock into
    `s.seconds` (a float, set on exit, also when the block raises) and logs
    it at debug level.  While a torch.profiler run records, the block is a
    `record_function(name)` range too, unless `trace` is False; otherwise
    no range is opened (one costs ~13 us even with no profiler, a guarded
    span ~1 us)."""

    __slots__ = ("name", "log", "seconds", "trace", "_t0", "_range")

    def __init__(self, name: str, log: Optional[logging.Logger] = None, *,
                 trace: bool = True):
        self.name = name
        self.log = log
        self.trace = trace
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "span":
        # torch's own guard for the profiler's Python entry points: True
        # from a profile's start to its stop
        if self.trace and _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.log is not None:
            self.log.debug("span %s = %.3f ms", self.name, self.seconds * 1e3)
        return False
