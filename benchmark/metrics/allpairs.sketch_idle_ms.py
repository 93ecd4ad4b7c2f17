"""allpairs.sketch_idle_ms: ms a job in which the device sat idle while
the program's DevicePipeline sketched: the window's idle gaps whose middle
lies inside a `pipeline.attempt` span (each pass of the sketch phase, the
overflowed ones too), from torch.profiler."""
from benchmark import spans


def read(run):
    if run.trace is None or not run.records:
        return None
    s = spans.idle_inside(run.trace, "pipeline.attempt")
    return s / len(run.records) * 1e3 if s is not None else None
