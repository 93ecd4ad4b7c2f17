"""allpairs_pairs_per_s: the ordered pairs of all the window's jobs over
the time from the window's start to the last job's end (the last job is
let finish)."""


def read(run):
    pairs = sum(r["pairs"] for r in run.records)
    span = run.window[1] - run.window[0]
    return pairs / span if pairs and span > 0 else None
