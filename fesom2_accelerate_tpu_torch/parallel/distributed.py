"""Multi-process launch support (PyTorch port).

Counterpart of ``fesom2_accelerate_tpu/parallel/distributed.py``.  The
reference binds one GPU per MPI rank (``set_mpi_rank_``, reference
src/fesom2-accelerate.cu:206-228) and leaves the halo exchange to the
host's MPI.  Here the processes join one ``torch.distributed`` group, every
process learns the global list of part devices, and
:class:`~fesom2_accelerate_tpu_torch.parallel.step_sharded.
ShardedFctAleSolver` runs the parts of its own rank and exchanges halo
slabs with the other ranks point to point.

Launch (per process)::

    from fesom2_accelerate_tpu_torch.parallel import distributed as dist
    dist.init_distributed()                   # env:// (torchrun, mpirun)
    dev = dist.bind_device()                  # cuda:<local rank % cards>
    solver = ShardedFctAleSolver(mesh, cfg,
                                 devices=dist.global_devices([dev] * 2))
    state = solver.init_state(fields)         # this rank's parts only
    state = solver.run(state, 10)

Part p of the stripe partition goes on ``devices[p]``; the list is
process-contiguous (rank 0's parts first), as the JAX ``global_devices``
sorts by ``(process_index, id)``, so neighbouring parts share a process
wherever they can and one hop per adjacent pair of ranks crosses.

The default backend is gloo: it takes CPU tensors, so CUDA parts stage
their slabs through pinned host memory.  nccl sends device tensors, but
puts one rank on one card: :func:`init_distributed` refuses it where a
node has more ranks than cards.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class PartDevice(NamedTuple):
    """The device of one part and the rank of the process that holds it."""

    rank: int
    device: torch.device


def _env_int(name: str, default: int | None) -> int | None:
    value = os.environ.get(name)
    return int(value) if value is not None else default


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     backend: str = "gloo") -> None:
    """Join this process into a ``torch.distributed`` group.

    With no arguments the group comes from the ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) that
    ``torchrun`` and ``mpirun`` wrappers set, as ``jax.distributed.
    initialize()`` detects its cluster.  ``backend="nccl"`` raises before
    NCCL is touched where this node holds more ranks (``LOCAL_WORLD_SIZE``,
    else the world size) than cards: NCCL runs one rank a card."""
    if backend == "nccl":
        size = world_size if world_size is not None else _env_int(
            "WORLD_SIZE", 1)
        local = _env_int("LOCAL_WORLD_SIZE", size)
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local > cards:
            raise RuntimeError(
                f"backend='nccl' puts one rank on one card: {local} ranks on "
                f"this node, {cards} CUDA devices; use backend='gloo'")
    kwargs = {}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend=backend, **kwargs)


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def process_rank() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if is_multiprocess() else 0


def bind_device(rank: int | None = None, ranks_per_node: int | None = None,
                device: str = "cuda") -> torch.device:
    """The card of this rank, the reference's ``set_mpi_rank_``:
    ``cuda:{(rank % ranks_per_node) % torch.cuda.device_count()}``, made
    the current device.  ``rank`` defaults to the group rank and
    ``ranks_per_node`` to ``LOCAL_WORLD_SIZE``, else the world size.
    ``device="cpu"`` returns the CPU (the tests' parts); a CUDA binding
    with no card raises."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("bind_device: torch.cuda.is_available() is "
                           "False, no CUDA device to bind this rank to")
    if rank is None:
        rank = process_rank()
    if ranks_per_node is None:
        ranks_per_node = _env_int(
            "LOCAL_WORLD_SIZE",
            dist.get_world_size() if is_multiprocess() else 1)
    dev = torch.device("cuda",
                       (rank % ranks_per_node) % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def global_devices(local_devices: list) -> list[PartDevice]:
    """Every process's part devices, process-contiguous: rank 0's
    ``local_devices`` first, then rank 1's, ... (a collective every rank
    enters; one process alone gets its own list)."""
    local = [str(torch.device(d)) for d in local_devices]
    if not is_multiprocess():
        return [PartDevice(0, torch.device(d)) for d in local]
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, local)
    return [PartDevice(r, torch.device(d))
            for r, devs in enumerate(lists) for d in devs]
