"""The device mesh of the sharded sketching and all-pairs paths.

The counterpart of the JAX package's parallel/mesh.py.  A mesh is a 2-D
("r", "c") grid of slots; each slot names a torch.device and the rank of
the process that owns it:

  * the all-pairs probe tiles the (G, G) matrix over the grid (row blocks
    over "r", column blocks over "c");
  * the flattened ("r", "c") slots, row-major, are the genome data-parallel
    axis of sketching (a leading genome axis is split contiguously over
    them: `data_rows`) and the ring of sequence-parallel halo exchange.

A device may fill several slots.  The CPU tests build 8-slot meshes that
way (the JAX tests' 8 virtual devices), and one card can run a 2 x 2 mesh
whose slots run one after another; the CLI never repeats a GPU.  Work that
depends only on the device, such as a replicated cache, is done once per
distinct device (`Mesh.distinct`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

ROW_AXIS = "r"
COL_AXIS = "c"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (r, c) grid of slots, row-major: slot s = i * c + j holds
    devices[s] and belongs to process ranks[s]."""
    shape: Tuple[int, int]
    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...]

    def __post_init__(self):
        r, c = self.shape
        if r < 1 or c < 1 or len(self.devices) != r * c \
                or len(self.ranks) != r * c:
            raise ValueError(f"mesh shape {self.shape} != {len(self.devices)} "
                             f"devices and {len(self.ranks)} ranks")
        per = self.ranks.count(self.ranks[0])
        if any(self.ranks.count(q) != per for q in set(self.ranks)) or \
                list(self.ranks) != sorted(self.ranks):
            raise ValueError("each rank must own the same number of "
                             f"consecutive slots, got ranks {self.ranks}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_slots(self, rank: Optional[int] = None) -> List[int]:
        """The slots that process `rank` (default: this process) owns."""
        me = process_rank() if rank is None else rank
        return [s for s, q in enumerate(self.ranks) if q == me]

    def distinct(self, slots: Optional[Sequence[int]] = None
                 ) -> List[torch.device]:
        """The distinct devices of `slots` (default: this process's), in
        slot order."""
        out: List[torch.device] = []
        for s in self.local_slots() if slots is None else slots:
            if self.devices[s] not in out:
                out.append(self.devices[s])
        return out


def process_rank() -> int:
    """This process's rank in the torch.distributed job, 0 without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _factor2d(n: int) -> Tuple[int, int]:
    """Squarest (r, c) with r * c == n."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 2-D ("r", "c") mesh over `devices` (default: every visible GPU of
    this process), owned by `ranks` (default: all by this process).  The
    shape defaults to the squarest factorisation; a shape that does not
    match the device count raises, as the JAX make_mesh does."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA GPU is visible; pass the "
                               "devices (e.g. ['cpu'] * 8)")
    devs = tuple(torch.device(d) for d in devices)
    if shape is None:
        shape = _factor2d(len(devs))
    r, c = shape
    if r * c != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devs)} devices")
    if ranks is None:
        ranks = [process_rank()] * len(devs)
    return Mesh((r, c), devs, tuple(int(q) for q in ranks))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def split_range(n: int, parts: int, i: int) -> slice:
    """Part i of n items split contiguously into `parts` equal parts (n a
    multiple of parts)."""
    if n % parts:
        raise ValueError(f"{n} items do not split into {parts} equal parts")
    per = n // parts
    return slice(i * per, (i + 1) * per)


def data_rows(mesh: Mesh, n: int, slot: int) -> slice:
    """The rows of an n-row leading genome axis that `slot` holds: the axis
    split contiguously over the flattened ("r", "c") slots (the JAX
    data_spec(), P(("r", "c")))."""
    return split_range(n, mesh.size, slot)


def replicated(mesh: Mesh, x: torch.Tensor) -> Dict[torch.device,
                                                      torch.Tensor]:
    """One copy of x on each distinct device of this process's slots."""
    return {d: x.to(d) for d in mesh.distinct()}
