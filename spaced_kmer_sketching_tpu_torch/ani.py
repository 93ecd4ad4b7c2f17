"""ANI estimation math (reference: src/ani_estimation.cpp).

Kept in float64 on host so the final pow matches the reference's C++ double
semantics exactly (src/ani_estimation.cpp:41).
"""
from __future__ import annotations

import numpy as np


def containment(intersection, set_size):
    """|A∩B| / |A|; 0 when the intersection is empty
    (src/ani_estimation.cpp:24-28)."""
    inter = np.asarray(intersection, dtype=np.float64)
    size = np.asarray(set_size, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(inter == 0, 0.0, inter / size)
    return c


def binomial_estimator(containment_vals, kmer_num_ones):
    """containment ** (1/k), 0 when containment <= 0
    (src/ani_estimation.cpp:38-42).  k = care positions = mask.count()/2."""
    c = np.asarray(containment_vals, dtype=np.float64)
    k = float(kmer_num_ones)
    with np.errstate(invalid="ignore"):
        return np.where(c <= 0, 0.0, np.power(np.maximum(c, 1e-300), 1.0 / k))
