"""Operation "allpairs": all ordered pairs of a device-resident collection,
one `pipeline.DevicePipeline.all_pairs` job a job.

Set-up draws the configuration's collection into 2-bit words on the
device (data.device_collection): one fixed draw, the genome spec's
"collection_seed", the same genomes for every run, which the run's seed
shuffles within each block of 128 (data.shuffle_within_blocks).  The
blocks keep their order, so every seed's jobs do the same work: the
program's whole-run restart wastes its first pass up to the same block.
A job builds `DevicePipeline(sketcher, dispatch=d)` and takes the (G, G)
intersection matrix of all genomes to the host; d is the default of
`pipeline.all_pairs_from_files`'s dispatch (the route the program's
driver takes for collections), read from its signature.  Set-up runs one
job.

The check: traffic "check_genomes" genomes, drawn from the seed over
distinct blocks, members of a few species among them, and always the
genome spec's "first_pass_overflow" genomes (ids of the draw), are sketched again by the
reference from the same words.  Every job's counts of those genomes and
their intersections must be the reference's; every job's diagonal must
be its counts; the last job's matrix must be symmetric.  The number
compared is the count of entries that break one of these, limit 0.
"""
from __future__ import annotations

import inspect
from typing import List

import numpy as np

from .. import data, reference, workers
from ..harness import Check

BLOCK = 128          # the pipeline's block of genomes: the seed shuffles
                     # genomes within blocks, never across them


class Operation:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.sketch = cell.config["sketch"]
        self.window, self.k = (cell.config["experiment"][x]
                               for x in ("window", "k"))
        spec = cell.genomes
        self.g, self.n = int(spec["count"]), int(spec["length_nt"])
        self.genomes = None
        self.last = None

    def setup(self) -> None:
        import torch

        from spaced_kmer_sketching_tpu_torch import pipeline
        from spaced_kmer_sketching_tpu_torch.config import SketchConfig
        from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
            FracMinHashSketcher)
        from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import (
            packed_body)
        self.pipeline = pipeline
        spec = self.cell.genomes
        words = packed_body(self.n) // 16
        self.genomes, species_of = data.device_collection(
            spec, int(spec["collection_seed"]), words, self.device)
        src = data.shuffle_within_blocks(self.genomes, self.seed, BLOCK)
        where = np.argsort(src)                 # drawn id -> its new place
        self.sample = data.sample_genomes(
            self.seed, species_of[src],
            int(self.cell.traffic["check_genomes"]),
            always=where[[i for i in spec.get("first_pass_overflow", ())
                          if i < self.g]], block=BLOCK)
        self.dispatch = int(inspect.signature(
            pipeline.all_pairs_from_files).parameters["dispatch"].default)
        self.sk = FracMinHashSketcher(
            SketchConfig(window=self.window, k=self.k, **self.sketch),
            device=self.device)
        self.meta = {}
        self.torch = torch
        self.job()

    def load(self, s0: int, s1: int):
        """The pipeline's source: genomes [s0, s1), one run of n codes."""
        torch, gg = self.torch, s1 - s0
        if gg not in self.meta:
            self.meta[gg] = (
                torch.full((gg, 1), 16 * self.genomes.shape[1],
                           dtype=torch.int32, device=self.device),
                torch.zeros(gg, dtype=torch.int32, device=self.device),
                torch.full((gg,), self.n, dtype=torch.int32,
                           device=self.device))
        bounds, rid0, vlen = self.meta[gg]
        return self.pipeline._DevicePlanes(p=self.genomes[s0:s1],
                                           bounds=bounds, rid0=rid0,
                                           valid_len=vlen)

    def job(self) -> dict:
        from torch.profiler import record_function
        with record_function("bench::all_pairs"):
            pipe = self.pipeline.DevicePipeline(self.sk,
                                                dispatch=self.dispatch)
            res = pipe.all_pairs(self.load, self.g, self.n)
        s = self.sample
        self.last = res.inter
        return {"pairs": self.g * self.g, "restarts": pipe.restarts,
                "phases": dict(res.phases), "counts": res.counts.copy(),
                "diag": np.diagonal(res.inter).copy(),
                "sub": res.inter[np.ix_(s, s)].copy()}

    def release(self) -> None:
        self.sample_words = self.genomes[
            self.torch.from_numpy(self.sample).to(self.genomes.device)
        ].cpu().numpy()
        self.genomes = None
        self.meta = {}
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, fingerprint: bool = False):
        """The reference's counts and intersections of the sampled genomes
        (fingerprint=True: of their keys' 32-bit hash fingerprints)."""
        sk = workers.parallel(workers.packed_sketch, [
            (w, self.n, self.window, self.k, self.sketch, fingerprint)
            for w in self.sample_words])
        return np.array([s.shape[0] for s in sk]), \
            reference.intersections(sk)

    def compare(self, counts, inter, records, last=None) -> List[Check]:
        """The number the check compares: over every job, entries of the
        sampled genomes' counts and intersections that differ from the
        reference's (`counts`, `inter`) and diagonal entries that differ
        from the job's counts; and the asymmetric entries of `last`, the
        last job's matrix."""
        s = self.sample
        sample = sum(int(np.count_nonzero(r["sub"] != inter))
                     + int(np.count_nonzero(r["counts"][s] != counts))
                     for r in records)
        diag = sum(int(np.count_nonzero(r["diag"] != r["counts"]))
                   for r in records)
        asym = 0 if last is None else sum(
            int(np.count_nonzero(last[i:i + 512] != last[:, i:i + 512].T))
            for i in range(0, last.shape[0], 512))
        return [Check("mismatches", sample + diag + asym, 0,
                      {"sample": sample, "diag": diag, "asym": asym})]

    def check(self, records) -> List[Check]:
        return self.compare(*self.reference(), records, self.last)

    def control(self, records) -> List[Check]:
        """The reference in the program's place with keys compared by 32-bit
        fingerprints, below the exact keys the reference tool compares: its
        sampled counts and intersections, for one job."""
        counts, inter = self.reference()
        fp_counts, fp_inter = self.reference(fingerprint=True)
        job = {"sub": fp_inter, "counts": np.zeros(self.g, np.int64),
               "diag": np.zeros(self.g, np.int64)}
        job["counts"][self.sample] = fp_counts
        job["diag"][self.sample] = fp_counts
        return self.compare(counts, inter, [job])

    def close(self) -> None:
        self.genomes = None
        self.last = None
