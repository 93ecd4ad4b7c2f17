"""allpairs.tile_sweep_s: the program's phases["allpairs_s"], the tile
sweep (K10, K6) ending in the matrix's download, a job (mean)."""


def read(run):
    s = [r["phases"]["allpairs_s"] for r in run.records
         if "allpairs_s" in r.get("phases", {})]
    return sum(s) / len(s) if s else None
