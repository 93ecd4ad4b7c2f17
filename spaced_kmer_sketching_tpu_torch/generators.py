"""Pair generators (reference: src/generators.hpp:21-58).

The reference builds explicit pair lists; here they are index-pair lists so
the same generators drive both the batched device intersection path and the
CSV emitter.  Semantics preserved exactly:

  * ring_pairs: (i, (i+1) mod n) for every i — including the degenerate
    (0, 0) self-pair when n == 1 (generators.hpp:21-34).
  * all_pairs: the full n^2 ordered cross product INCLUDING self-pairs and
    both orders (generators.hpp:45-58) — i is the outer loop, j the inner.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, TypeVar

T = TypeVar("T")


def ring_pair_indices(n: int) -> List[Tuple[int, int]]:
    """Ring pairing (i, (i+1) mod n) (generators.hpp:21-34)."""
    return [(i, (i + 1) % n) for i in range(n)]


def all_pair_indices(n: int) -> List[Tuple[int, int]]:
    """Full ordered n^2 pairing incl. self-pairs (generators.hpp:45-58)."""
    return [(i, j) for i in range(n) for j in range(n)]


def generate_pairwise_from_vector(items: Sequence[T]) -> List[Tuple[T, T]]:
    """Value-level ring pairing, mirroring the reference template."""
    return [(items[i], items[j]) for i, j in ring_pair_indices(len(items))]


def generate_all_pairs_from_vector(items: Sequence[T]) -> List[Tuple[T, T]]:
    """Value-level all-pairs (ordered, incl. self), mirroring the template."""
    return [(items[i], items[j]) for i, j in all_pair_indices(len(items))]
