"""sweep.config_p95_ms: the 95th percentile (nearest rank) of the walls of
all the window's experiments, each from the call to its return with its
CSV rows written."""
import math


def read(run):
    walls = sorted(r["wall_s"] for r in run.records)
    if not walls:
        return None
    return walls[math.ceil(0.95 * len(walls)) - 1] * 1e3
