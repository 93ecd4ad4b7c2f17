"""allpairs.sketch_redos: re-sketch dispatches of the program's
DevicePipeline a job (its counter pipeline_sketch_redos: a block's
overflowing genomes sketched again at a larger capacity, one more each
time that capacity overflows too), 0 where no genome overflowed.  Silent
for a program whose jobs book no phases["redo_s"]: it has no re-sketch."""


def read(run):
    if not any("redo_s" in r.get("phases", {}) for r in run.records):
        return None
    return run.counters.get("pipeline_sketch_redos", 0) / len(run.records)
