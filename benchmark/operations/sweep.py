"""Operation "sweep": the reference tool's main, one experiment a job.

Set-up writes the configuration's FASTA files into a directory under the
run's TMPDIR and runs the schedule once.  A job is the program's
`driver.run_experiment(window, k, files, csv, is_append, ...)` for the
next entry of the schedule (the 62 (window, k) configs of
driver.reference_sweep_schedule), cycling; each experiment writes its CSV
rows, and the schedule's non-appending entry starts the CSV anew.

The check: traffic "check_configs" of the configs the window ran are
computed again by the reference: always a spaced config (window over k)
of a window over 32 (keys of more than one 32-bit word) and one of a
window up to 32, the rest drawn from the seed; every experiment of
those configs must return the reference's ANI values bit for bit, and the
final CSV must hold the reference's rows (for the other configs, the
rows of the values their experiment returned).  The number compared is
the count of values and lines that differ, limit 0.
"""
from __future__ import annotations

import contextlib
import io
import pathlib
import shutil
import tempfile
from typing import Dict, List

import numpy as np

from .. import data, reference, workers
from ..harness import Check


class Operation:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.sketch = cell.config["sketch"]
        from spaced_kmer_sketching_tpu_torch.driver import (
            reference_sweep_schedule)
        self.schedule = [(int(w), int(k), bool(a))
                         for w, k, a in reference_sweep_schedule()]
        self.next = 0
        self.tmp = None

    def setup(self) -> None:
        from spaced_kmer_sketching_tpu_torch import driver
        from spaced_kmer_sketching_tpu_torch.config import SketchConfig
        self.driver, self.SketchConfig = driver, SketchConfig
        self.tmp = pathlib.Path(tempfile.mkdtemp(prefix="bench-sweep-"))
        self.paths = data.write_genomes(self.tmp, self.seed,
                                        self.cell.genomes)
        self.csv = str(self.tmp / "out.csv")
        for _ in self.schedule:
            self.job()
        self.next = 0

    def job(self) -> dict:
        from torch.profiler import record_function
        i = self.next
        self.next = (i + 1) % len(self.schedule)
        w, k, append = self.schedule[i]
        cfg = self.SketchConfig(window=w, k=k, **self.sketch)
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                record_function("bench::run_experiment"):
            ani = self.driver.run_experiment(w, k, self.paths, self.csv,
                                             append, config=cfg,
                                             device=self.device)
        return {"config": i, "ani": np.array(ani, np.float64),
                "stdout": out.getvalue()}

    def release(self) -> None:
        with open(self.csv) as f:
            self.csv_lines = f.read().split("\n")

    def reference(self, configs) -> Dict[int, dict]:
        """The reference's masks, counts and intersections of `configs`."""
        tasks = [(p, *self.schedule[i][:2], self.sketch)
                 for i in configs for p in self.paths]
        sketches = iter(workers.parallel(workers.fasta_sketch, tasks))
        out = {}
        for i in configs:
            w, k, _ = self.schedule[i]
            sk = [next(sketches) for _ in self.paths]
            out[i] = {"mask": reference.spaced_mask(w, k,
                                                    self.sketch["mask_seed"]),
                      "counts": np.array([s.shape[0] for s in sk]),
                      "inter": reference.intersections(sk), "k": k}
        return out

    def sampled(self, records) -> List[int]:
        """The configs the check computes again: of those the window ran,
        one spaced config (window over k) of a window over 32 and one of a
        window up to 32, drawn from the seed, then others drawn from the
        seed, traffic "check_configs" in all."""
        ran = sorted({r["config"] for r in records})
        n = min(int(self.cell.traffic["check_configs"]), len(ran))
        rng = data.numpy_rng(self.seed, 4)
        must = []
        for wide in (True, False):
            pool = [i for i in ran if (self.schedule[i][0] > 32) == wide
                    and self.schedule[i][0] > self.schedule[i][1]]
            if pool:
                must.append(int(rng.choice(pool)))
        rest = [i for i in ran if i not in must]
        more = rng.choice(rest, max(0, min(n - len(must), len(rest))),
                          replace=False)
        return sorted({*must[:n], *(int(i) for i in more)})

    def expected_csv(self, log, values: Dict[int, np.ndarray]) -> List[str]:
        """The lines of the final CSV: the rows of the window's experiments
        (`log`: (config, ANI); the window starts at the schedule's first,
        non-appending entry) since its last non-appending one, with
        `values` (config -> ANI) in place of the returned ANI where given."""
        last = max(j for j, (i, _) in enumerate(log)
                   if not self.schedule[i][2])
        lines = [reference.CSV_HEADER]
        for i, ani in log[last:]:
            w, k, _ = self.schedule[i]
            mask = reference.spaced_mask(w, k, self.sketch["mask_seed"])
            lines += reference.csv_rows(self.paths, values.get(i, ani), mask)
        return lines + [""]

    def compare(self, answers: Dict[int, np.ndarray], log, csv_lines
                ) -> List[Check]:
        """The number the check compares: ANI values of the window's
        experiments (`log`: (config, ANI)) that differ from the reference's
        `answers`, and lines of the final CSV that differ from the rows the
        reference writes."""
        ani_bad = sum(int(np.count_nonzero(a != answers[i]))
                      + abs(a.size - answers[i].size)
                      for i, a in log if i in answers)
        want = self.expected_csv(log, answers)
        csv_bad = sum(a != b for a, b in zip(want, csv_lines)) \
            + abs(len(want) - len(csv_lines))
        return [Check("mismatches", ani_bad + csv_bad, 0,
                      {"ani": ani_bad, "csv": csv_bad})]

    def answers(self, records, dtypes=(np.float64,)) -> List[Dict]:
        """The reference's ANI of the sampled configs in each of `dtypes`."""
        ref = self.reference(self.sampled(records))
        return [{i: reference.ani(r["inter"], r["counts"], r["k"], dt)
                 for i, r in ref.items()} for dt in dtypes]

    def check(self, records) -> List[Check]:
        exact, = self.answers(records)
        return self.compare(exact, [(r["config"], r["ani"]) for r in records],
                            self.csv_lines)

    def control(self, records) -> List[Check]:
        """The reference in the program's place with its ANI in float32, the
        precision below the float64 the reference tool computes in."""
        exact, low = self.answers(records, (np.float64, np.float32))
        log = [(r["config"], low.get(r["config"], r["ani"]))
               for r in records]
        return self.compare(exact, log, self.expected_csv(log, low))

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
