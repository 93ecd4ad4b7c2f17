"""allpairs.redo_s: seconds a job that the program's DevicePipeline spent
sketching overflowing genomes again inside its one sketch pass (its
phases["redo_s"], the host time of its `pipeline.redo` spans: the genomes
asked of the source again, their sketch steps and blocking reads), a job
(mean)."""


def read(run):
    s = [r["phases"]["redo_s"] for r in run.records
         if "redo_s" in r.get("phases", {})]
    return sum(s) / len(s) if s else None
