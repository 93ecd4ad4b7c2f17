"""Spaced-seed k-mer FracMinHash sketching and ANI estimation on a CUDA GPU.

The PyTorch port of the JAX package `spaced_kmer_sketching_tpu`, which stays
beside it as the reference.  It imports torch and never jax.  The sketch
step runs as hand-written Hopper kernels (csrc/*.cu, built with nvcc at
first use); on the CPU the same functions run their plain PyTorch versions.

Public API:
    SketchConfig           — one (window, k) experiment configuration
    FracMinHashSketcher    — the sketching/ANI pipeline (device=...)
    Sketch                 — a genome's sorted-unique 128-bit key sketch
    SketchStore            — checkpoint store for resumable runs
    driver.run_experiment / run_reference_sweep / main — the reference CLI
    spaced_seed_mask / contiguous_mask — seeded spaced-seed masks
    containment / binomial_estimator   — ANI math (host float64)
"""
from .ani import binomial_estimator, containment
from .config import SketchConfig
from .models.fracminhash import FracMinHashSketcher, Sketch
from .store import SketchStore
from .utils.masks import SpacedSeedMask, contiguous_mask, spaced_seed_mask

__all__ = [
    "binomial_estimator", "containment", "SketchConfig",
    "FracMinHashSketcher", "Sketch", "SketchStore", "SpacedSeedMask",
    "contiguous_mask", "spaced_seed_mask",
]

__version__ = "0.1.0"
