"""allpairs.sweep_idle_ms: ms a job in which the device sat idle during
the program's tile sweep: the window's idle gaps whose middle lies inside
an `allpairs.sweep` span (the K10 and K6 launches and the matrix's
download), from torch.profiler."""
from benchmark import spans


def read(run):
    if run.trace is None or not run.records:
        return None
    s = spans.idle_inside(run.trace, "allpairs.sweep")
    return s / len(run.records) * 1e3 if s is not None else None
