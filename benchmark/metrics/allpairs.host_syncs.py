"""allpairs.host_syncs: the program's blocking device-to-host round trips
a job (its counter pipeline_host_syncs: a block's counts, the assembled
cache's synchronize, a sampled genome's keys, the matrix's download)."""


def read(run):
    n = run.counters.get("pipeline_host_syncs")
    return n / len(run.records) if n is not None and run.records else None
