"""sweep.sketching_ms: the mean of the program's own "Time taken for
sketching = X ms" line (driver.run_experiment: host clock after a
synchronize) over the window's experiments."""
import re

_LINE = re.compile(r"Time taken for sketching = ([0-9.eE+-]+) ms")


def read(run):
    ms = [float(m.group(1)) for r in run.records
          for m in _LINE.finditer(r.get("stdout", ""))]
    return sum(ms) / len(ms) if ms else None
