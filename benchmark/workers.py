"""The reference's work spread over the host's cores: one task a genome
and experiment, each in a worker process started by spawn (the parent
holds CUDA and threads).  Tasks name module-level functions of this file,
so a worker imports NumPy and the reference alone."""
from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os
from typing import Callable, List, Sequence

import numpy as np

from . import reference

_runs_cache: dict = {}


def workers(tasks: int) -> int:
    return max(1, min(tasks, os.cpu_count() or 1, 8))


def parallel(fn: Callable, tasks: Sequence[tuple]) -> List:
    """[fn(*t) for t in tasks], on worker processes."""
    if len(tasks) <= 1:
        return [fn(*t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(workers(len(tasks)), mp_context=ctx) as ex:
        return [f.result() for f in [ex.submit(fn, *t) for t in tasks]]


def fasta_sketch(path: str, window: int, k: int, sketch: dict) -> np.ndarray:
    """The reference sketch of a FASTA file (its runs parsed once a
    worker)."""
    if path not in _runs_cache:
        _runs_cache[path] = reference.read_fasta_runs(path)
    mask = reference.spaced_mask(window, k, sketch["mask_seed"])
    return reference.sketch(_runs_cache[path], mask, sketch["nonce"],
                            sketch["scale"], sketch["hash_variant"])


def packed_sketch(words: np.ndarray, n: int, window: int, k: int,
                  sketch: dict, fingerprint: bool = False) -> np.ndarray:
    """The reference sketch of one run of n codes packed 16 a word."""
    mask = reference.spaced_mask(window, k, sketch["mask_seed"])
    return reference.sketch([reference.unpack_2bit(words, n)], mask,
                            sketch["nonce"], sketch["scale"],
                            sketch["hash_variant"], fingerprint)
