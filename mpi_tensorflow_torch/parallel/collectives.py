"""Collectives over the ``data`` axis: the MPI roles the reference uses,
on ``torch.distributed``.

Counterpart of ``mpi_tensorflow_tpu/parallel/collectives.py``, the part
the CNN's data axis uses.  The JAX versions run inside ``shard_map`` on
a mesh axis; here the axis is the process group (``parallel.mesh``):

| MPI role (reference)         | here                                     |
|------------------------------|------------------------------------------|
| ``Allreduce`` (intended)     | ``allreduce_sum`` / ``allreduce_mean``   |
| ``Gather`` (to root)         | ``allgather`` / ``host_allgather``       |
| ``Bcast``                    | ``pbroadcast`` (root 0)                  |
| ``Barrier``                  | ``barrier``                              |

The tensor ops work in place on ``x`` and return it.  Without a process
group each is the identity (``allgather`` adds the axis of one), and
nothing is launched.  A CUDA tensor goes over NCCL and a host tensor
over gloo under the ``cpu:gloo,cuda:nccl`` group the CLI creates.
``reduce_scatter`` (ROADMAP Queue 1 item 12) and ``ppermute_shift``
(item 14) have no user yet and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mpi_tensorflow_torch.parallel.mesh import (active, process_count,
                                                process_index)


def allreduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The per-step gradient reduction (the reference's intended op)."""
    if active():
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def allreduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks divided by their count, as ``lax.pmean``
    computes it (the reference's ``np.mean(gathered, 0)``, mpipy.py:130-
    137, delivered to every rank)."""
    if active():
        allreduce_sum(x).div_(process_count())
    return x


def allreduce_max(x: torch.Tensor) -> torch.Tensor:
    if active():
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``(world, *x.shape)``."""
    if not active():
        return x[None]
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


def host_allgather(x: np.ndarray) -> np.ndarray:
    """``allgather`` of a host array, over gloo: ``(world, *x.shape)``."""
    return allgather(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def pbroadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """``MPI.Bcast`` from ``root``: ``x`` becomes ``root``'s."""
    if active():
        dist.broadcast(x, src=root)
    return x


def axis_index() -> int:
    """This rank's shard index."""
    return process_index()


def barrier() -> None:
    """Every rank waits here for the others.  A one-element all-reduce
    of a host tensor, so it runs over gloo under any of the port's
    groups (NCCL's ``barrier`` has to guess a card)."""
    if active():
        dist.all_reduce(torch.zeros(1))
