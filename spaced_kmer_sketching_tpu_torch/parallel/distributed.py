"""Multi-process bring-up over torch.distributed, a job-wide mesh, and the
collectives the sharded paths use.

The counterpart of the JAX package's parallel/distributed.py.  Every
process calls `init_distributed()` (torchrun's environment, or explicit
arguments), then `global_mesh()` builds the ("r", "c") mesh over every
rank's devices; each rank runs the slots it owns and the collectives
below join the ranks' results.  Without a job (no environment, no
arguments) everything stays in one process, and the collectives are the
identity.

Backends: NCCL where each rank owns its own GPU, gloo on the CPU.  Gloo's
CUDA support covers broadcast and all-reduce only, so a collective over a
gloo group stages a CUDA tensor through host memory, and one over an NCCL
group stages a host tensor through the rank's GPU.  Two gloo ranks may
share one GPU, which NCCL refuses.
"""
from __future__ import annotations

import os
from typing import List, Optional, Set, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, data_rows, make_mesh, pad_to_multiple, process_rank


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None) -> None:
    """Join the torch.distributed job (idempotent).

    With no arguments it reads torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks an NCCL rank's GPU).
    Without such an environment the process stays single-process.  A
    coordinator ("host:port") that is named but cannot be reached raises.
    `backend` defaults to nccl when CUDA is available, else gloo."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:" \
                              f"{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        return                      # no job: one process
    if any(x is None for x in given):
        raise ValueError("a distributed job needs the coordinator address, "
                         "the number of processes and this process's id "
                         f"(got {given})")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's GPU index on its host: LOCAL_RANK, else the rank
    modulo the visible GPUs."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_rank() % max(1, torch.cuda.device_count())


def global_mesh(shape: Optional[Tuple[int, int]] = None,
                device="cuda") -> Mesh:
    """The ("r", "c") mesh over every rank's devices.  On CUDA: in one
    process every visible GPU, in a job each rank's cuda:LOCAL_RANK (one
    slot a rank); a shape whose slot count differs raises, so a GPU is
    never repeated.  On the CPU: R * C CPU slots split evenly over the
    ranks, or one slot a rank without a shape."""
    dev = torch.device(device)
    world = world_size()
    if dev.type == "cuda":
        if world == 1:
            return make_mesh(shape)
        devs: List[Optional[int]] = [None] * world
        dist.all_gather_object(devs, local_rank())
        return make_mesh(shape, [torch.device("cuda", i) for i in devs],
                         list(range(world)))
    n = shape[0] * shape[1] if shape is not None else world
    if n % world:
        raise ValueError(f"mesh shape {shape} does not split over {world} "
                         "ranks")
    return make_mesh(shape, [dev] * n,
                     [q for q in range(world) for _ in range(n // world)])


def process_shard(n_items: int) -> slice:
    """This process's contiguous ceil-division shard of n_items (coarse
    host-level splitting).  Ingest that feeds a sharded batch takes
    local_batch_rows instead: 5 genomes on 2 ranks of 4 slots pad to 8
    rows, rows 0-3 on rank 0, but the ceil split hands row 3 to rank 1."""
    p, n = process_rank(), world_size()
    per = (n_items + n - 1) // n
    return slice(p * per, min(n_items, (p + 1) * per))


def local_batch_rows(mesh: Mesh, n_items: int, pad_multiple: int) -> Set[int]:
    """The rows in [0, n_items) that THIS process's slots hold when an
    (n_items padded to pad_multiple)-row batch is split over the mesh
    (data_rows): the genomes a rank's ingest parses."""
    n_pad = pad_to_multiple(n_items, pad_multiple)
    local = set()
    for s in mesh.local_slots():
        rows = data_rows(mesh, n_pad, s)
        local.update(range(rows.start, min(rows.stop, n_items)))
    return local


# --- collectives --------------------------------------------------------

def _comm_device() -> torch.device:
    """Where the group's collectives run: NCCL on this rank's GPU, gloo on
    the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's t (equal shapes), in rank order, on t's device."""
    if world_size() == 1:
        return [t]
    d = _comm_device()
    src = t.to(d).contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    if d != t.device:
        parts = [p.to(t.device) for p in parts]
    return parts


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """t reduced over the ranks ("sum" or "max"), as a new tensor on t's
    device."""
    if world_size() == 1:
        return t
    d = _comm_device()
    src = t.to(d, copy=True)
    dist.all_reduce(src, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op])
    if d != t.device:
        src = src.to(t.device)
    return src
