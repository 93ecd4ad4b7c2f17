"""Sketch store: persistence + resumable experiments.

The port of the JAX package's store.py, on the port's own Sketch.  The
reference keeps sketches only in RAM and persists only the results CSV
(append mode, src/kmer-sketching.cpp:53-70), so a crash loses all
sketching work.  A store directory holds one .npz per (genome, window, k,
mask, scale, nonce, hash variant) with an index, and the ANI pass can
resume, recomputing only missing sketches and only pairs absent from the
output CSV.

The files are the JAX package's: `index.json` (sorted keys, written to a
temporary file and renamed into place), `<key>.npz` in Sketch.save's
format, and the same key hash, so a store either package wrote is read by
the other.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import pathlib
from typing import Dict, List, Optional, Sequence

from .models.fracminhash import FracMinHashSketcher, Sketch
from .observability import get_logger

log = get_logger(__name__)

_INDEX = "index.json"


def _sketch_key(path: str, window: int, k: int, mask_value: int, scale: int,
                nonce: int, variant: str) -> str:
    h = hashlib.sha256()
    h.update(f"{os.path.abspath(path)}|{window}|{k}|{mask_value:032x}|"
             f"{scale}|{nonce}|{variant}".encode())
    return h.hexdigest()[:24]


class SketchStore:
    """Directory-backed sketch checkpoint store."""

    def __init__(self, root: str):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._index_path = self.root / _INDEX
        self._index: Dict[str, dict] = {}
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    def _flush(self) -> None:
        tmp = self._index_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._index, indent=0, sort_keys=True))
        os.replace(tmp, self._index_path)

    def get(self, key: str) -> Optional[Sketch]:
        meta = self._index.get(key)
        if meta is None:
            return None
        p = self.root / meta["file"]
        if not p.exists():
            return None
        return Sketch.load(str(p))

    def put(self, key: str, sketch: Sketch, meta: Optional[dict] = None) -> None:
        fname = f"{key}.npz"
        sketch.save(str(self.root / fname))
        self._index[key] = {"file": fname, "count": sketch.count,
                            "name": sketch.name, **(meta or {})}
        self._flush()

    def sketch_files_resumable(self, sketcher: FracMinHashSketcher,
                               paths: Sequence[str]) -> List[Sketch]:
        """Like FracMinHashSketcher.sketch_files but checkpointed: a rerun
        after a crash recomputes only the missing genomes, all of them in
        one sketch_files call (one device batch a padded shape)."""
        cfg = sketcher.config
        out: List[Optional[Sketch]] = [None] * len(paths)
        todo = []
        for i, p in enumerate(paths):
            key = _sketch_key(p, cfg.window, cfg.k, sketcher.mask.value,
                              cfg.scale, cfg.nonce, cfg.hash_variant)
            cached = self.get(key)
            if cached is not None:
                out[i] = cached
            else:
                todo.append((i, p, key))
        log.info("sketch store: %d cached, %d to compute",
                 len(paths) - len(todo), len(todo))
        if todo:
            fresh = sketcher.sketch_files([p for _, p, _ in todo])
            for (i, _, key), sk in zip(todo, fresh):
                self.put(key, sk, meta={"window": cfg.window, "k": cfg.k})
                out[i] = sk
        return out  # type: ignore[return-value]


def completed_pairs_in_csv(csv_path: str) -> "collections.Counter":
    """Multiset of (file1, file2, window, mask) rows already present in a
    results CSV — lets a killed sweep resume without recomputing finished
    pairs (driver.run_reference_sweep consults this when --store is given).

    The mask column disambiguates sweep configs sharing a window size (the
    reference schedule has w=20..40 both as contiguous w==k and as spaced
    w=k+10 configs, src/kmer-sketching.cpp:228-238), and a Counter (not a
    set) preserves duplicate rows when the same FASTA path is passed twice
    — the reference writes one row per ordered pair occurrence."""
    done: "collections.Counter" = collections.Counter()
    if not os.path.exists(csv_path):
        return done
    with open(csv_path) as f:
        f.readline()                      # header
        for line in f:
            parts = line.rstrip("\n").split(",")
            if len(parts) >= 5:
                done[(parts[0], parts[1], parts[3], parts[4])] += 1
    return done
