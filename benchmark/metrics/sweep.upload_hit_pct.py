"""sweep.upload_hit_pct: the program's upload cache, hits over lookups in
the window (observability counters upload_cache_hits and _misses)."""


def read(run):
    hits = run.counters.get("upload_cache_hits", 0)
    total = hits + run.counters.get("upload_cache_misses", 0)
    return 100.0 * hits / total if total else None
