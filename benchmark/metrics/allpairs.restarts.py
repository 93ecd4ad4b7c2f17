"""allpairs.restarts: whole-run restarts of the program's DevicePipeline
(its `restarts` counter: a sketch overflowed the capacity), a job."""


def read(run):
    if not run.records:
        return None
    return sum(r["restarts"] for r in run.records) / len(run.records)
