"""sweep.device_idle_pct: 100 x (1 - the union of the device's kernels,
copies and sets / the traced window), from torch.profiler."""
from benchmark import trace


def read(run):
    return trace.idle_pct(run.trace) if run.trace is not None else None
