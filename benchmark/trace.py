"""A traced window, as plain intervals, and what the metrics read from it.

`Trace` holds the device's activities (kernels, copies, sets) and the
host's events on the thread that drives the device, in nanoseconds on one
clock, with the window they were traced in.  `from_profiler` fills it from
a torch.profiler run; the readers below work on it alone, so a test can
hand them a trace whose answer is known.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench::window"
_KERNEL = re.compile(r"sks::(?:\(anonymous namespace\)::)?(\w+)")


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, int, int]]   # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]     # the driving thread's events
    window: Tuple[int, int]              # traced window (start, end) ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def short_name(name: str) -> str:
    """The program's kernels by their function name (`slide_kernel`, not
    `void sks::(anonymous namespace)::slide_kernel<...>(...)`); other
    kernels by their qualified name without templates and arguments;
    copies and sets as the profiler names them."""
    m = _KERNEL.search(name)
    if m:
        return m.group(1)
    if name.startswith("void ") or "::" in name:
        name = name.removeprefix("void ").replace("(anonymous namespace)::",
                                                  "")
        return re.split(r"[<(]", name, maxsplit=1)[0]
    return name


def _busy_intervals(trace: Trace) -> List[Tuple[int, int]]:
    """The union of the device's activities inside the window, merged."""
    w0, w1 = trace.window
    spans = sorted((max(s, w0), min(e, w1)) for _, s, e in trace.device
                   if e > w0 and s < w1)
    merged: List[Tuple[int, int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return sum(e - s for s, e in _busy_intervals(trace)) / 1e9


def idle_pct(trace: Trace) -> Optional[float]:
    """100 x (1 - busy / window); None without a window."""
    if trace.window[1] <= trace.window[0]:
        return None
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)


def kernel_sums(trace: Trace) -> Dict[str, List[float]]:
    """{short name: [device seconds, launches]} inside the window."""
    w0, w1 = trace.window
    out: Dict[str, List[float]] = {}
    for name, s, e in trace.device:
        if e > w0 and s < w1:
            acc = out.setdefault(short_name(name), [0.0, 0])
            acc[0] += (e - s) / 1e9
            acc[1] += 1
    return out


def device_seconds(trace: Trace, names) -> Optional[float]:
    """Summed device seconds of the named kernels; None if none ran."""
    sums = kernel_sums(trace)
    hit = [sums[n][0] for n in names if n in sums]
    return sum(hit) if hit else None


def top_device_ops(trace: Trace, top: int = 10) -> List[list]:
    sums = kernel_sums(trace)
    ranked = sorted(sums.items(), key=lambda kv: -kv[1][0])[:top]
    return [[name, v[0]] for name, v in ranked]


def idle_gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The window's stretches with nothing on the device."""
    w0, w1 = trace.window
    gaps, t = [], w0
    for s, e in _busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def gaps_by_host(trace: Trace, top: int = 10) -> List[list]:
    """Idle seconds summed by what the host was doing at each gap's middle:
    the innermost host event there, or "host (no op)"."""
    host = sorted(trace.host, key=lambda h: (h[1], -h[2]))
    starts = [h[1] for h in host]
    parent, stack = [], []           # one thread's events nest
    for i, (_, hs, _) in enumerate(host):
        while stack and host[stack[-1]][2] <= hs:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    sums: Dict[str, float] = {}
    for s, e in idle_gaps(trace):
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and host[i][2] <= mid:
            i = parent[i]
        label = host[i][0] if i >= 0 else "host (no op)"
        sums[label] = sums.get(label, 0.0) + (e - s) / 1e9
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": top_device_ops(trace),
            "idle_gaps": gaps_by_host(trace)}


def _is_device(e, annotations) -> bool:
    """A kernel, copy or set on the device.  Newer torch names an event's
    activity; older torch gives its device type alone, and the device's
    copies of the host's record_function spans carry their names."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in DEVICE_ACTIVITIES
    return (e.device_type().name == "CUDA" and e.name() not in annotations
            and not e.name().startswith("bench::"))


def from_profiler(prof) -> Trace:
    """A Trace of a stopped torch.profiler run whose window is a
    `bench::window` record_function span: the device's kernels, copies and
    sets, and the host events of the thread that opened the window."""
    events = prof.profiler.kineto_results.events()
    window, thread = None, None
    for e in events:
        if e.name() == WINDOW_SPAN and e.device_type().name == "CPU":
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
            thread = e.start_thread_id()
    if window is None:
        raise RuntimeError("the trace holds no bench::window span")
    annotations = {e.name() for e in events
                   if e.device_type().name == "CPU"
                   and getattr(e, "is_user_annotation", lambda: False)()}
    device, host = [], []
    for e in events:
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if _is_device(e, annotations):
            device.append(span)
        elif (e.device_type().name == "CPU" and e.start_thread_id() == thread
              and e.name() != WINDOW_SPAN):
            host.append(span)
    return Trace(device=device, host=host, window=window)
