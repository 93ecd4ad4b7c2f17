"""allpairs.restart_s: seconds a job that the program's DevicePipeline
spent in sketch passes that overflowed and were thrown away (its
phases["restart_s"]: each overflowed call's host time, from its start to
the raise at the overflowing block's read), a job (mean).  Device work
that the pass had already queued, its lookahead, runs on after the raise
and is not in it."""


def read(run):
    s = [r["phases"]["restart_s"] for r in run.records
         if "restart_s" in r.get("phases", {})]
    return sum(s) / len(s) if s else None
