"""Collectives over the ``data`` axis: the MPI roles the reference uses,
on ``torch.distributed``.

Counterpart of ``mpi_tensorflow_tpu/parallel/collectives.py``, the part
the data axis uses.  The JAX versions run inside ``shard_map`` on a mesh
axis; here the axis is the process group (``parallel.mesh``):

| MPI role (reference)         | here                                     |
|------------------------------|------------------------------------------|
| ``Allreduce`` (intended)     | ``allreduce_sum`` / ``allreduce_mean``   |
| ``Gather`` (to root)         | ``allgather`` / ``host_allgather``       |
| ``Bcast``                    | ``pbroadcast`` (root 0)                  |
| ``Barrier``                  | ``barrier``                              |
| (ZeRO; absent from the MPI   | ``reduce_scatter`` (``psum_scatter``,    |
| script)                      | tiled) and ``allgather(x, tiled=True)``  |

The all-reduces and the broadcast work in place on ``x`` and return it;
``allgather`` and ``reduce_scatter`` return new tensors.  Without a
process group each is the identity (``allgather`` adds the axis of one
unless tiled), and nothing is launched.  A CUDA tensor goes over NCCL
and a host tensor over gloo under the ``cpu:gloo,cuda:nccl`` group the
CLI creates; a world made with ``backend="gloo"`` (the check-only world
of several ranks on one card) carries CUDA tensors over gloo.
``ppermute_shift`` (ROADMAP Queue 1 item 14) has no user yet and is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mpi_tensorflow_torch.parallel.mesh import (active, process_count,
                                                process_index)


# the one-tensor forms: torch 2.13 renamed them (and deprecated the old
# names, which earlier versions alone have)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


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


def allgather(x: torch.Tensor, *, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``(world, *x.shape)``;
    ``tiled``: concatenated along the leading dimension instead,
    ``(world * x.shape[0], *x.shape[1:])``, in one tensor."""
    if tiled:
        if not active():
            return x
        out = torch.empty((process_count() * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, x.contiguous())
        return out
    if not active():
        return x[None]
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


def reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, of which rank r keeps the r-th of
    ``world`` equal slices of the leading dimension (the reference's
    ``psum_scatter(tiled=True)``): the building block of the sharded
    optimizer states (``parallel.fsdp``, ``train.gspmd``)."""
    if not active():
        return x
    world = process_count()
    if x.shape[0] % world:
        raise ValueError(f"leading dimension {x.shape[0]} is not {world} "
                         f"equal slices")
    out = torch.empty((x.shape[0] // world, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _REDUCE_SCATTER(out, x.contiguous())
    return out


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
