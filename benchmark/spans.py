"""What the metrics read of the program's own spans in a trace: the
device's idle time that falls inside a span of one name."""
from __future__ import annotations

import bisect
from typing import Optional

from . import trace


def idle_inside(tr: trace.Trace, name: str) -> Optional[float]:
    """Seconds of the window's idle gaps whose middle lies inside a host
    event `name` (the rule trace.gaps_by_host names gaps by); None where
    the trace holds no such event.  Events of one name do not nest."""
    spans = sorted((s, e) for n, s, e in tr.host if n == name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    idle = 0
    for s, e in trace.idle_gaps(tr):
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and spans[i][1] > mid:
            idle += e - s
    return idle / 1e9
