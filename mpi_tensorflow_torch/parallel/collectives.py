"""Collectives over the mesh's axes: the MPI roles the reference uses,
and the tensor- and sequence-parallel operators, on
``torch.distributed``.

Counterpart of ``mpi_tensorflow_tpu/parallel/collectives.py``.  The JAX
versions run inside ``shard_map`` on a mesh axis name; here each takes
the axis as ``parallel.mesh.Axis`` (``mesh.group("model")``, or a set of
axes such as ``mesh.group("data", "seq")``); without one (``axis=None``)
the axis is the whole world, the data axis of the data-parallel paths:

| MPI role (reference)         | here                                     |
|------------------------------|------------------------------------------|
| ``Allreduce`` (intended)     | ``allreduce_sum`` / ``allreduce_mean``   |
| ``Gather`` (to root)         | ``allgather`` / ``host_allgather``       |
| ``Bcast``                    | ``pbroadcast`` (root 0)                  |
| ``Barrier``                  | ``barrier``                              |
| (ZeRO; absent from the MPI   | ``reduce_scatter`` (``psum_scatter``,    |
| script)                      | tiled) and ``allgather(x, tiled=True)``  |
| (ring attention)             | ``ppermute_shift``                       |
| (Ulysses)                    | ``all_to_all`` (tiled)                   |

The all-reduces and the broadcast work in place on ``x`` and return it;
the others return new tensors.  On an axis of one rank, and without a
process group, each is the identity (``allgather`` adds the axis of one
unless tiled) and nothing is launched; on an axis of several ranks each
launches its collective, never the identity.

The differentiable ones are ``torch.autograd.Function``s, each with the
backward GSPMD gives its JAX counterpart:

- ``ppermute_shift``: the backward shifts the gradient the other way;
- ``all_to_all``: the backward is the inverse all-to-all;
- ``copy_to`` (identity forward, all-reduce backward) and
  ``reduce_from`` (all-reduce forward, identity backward): Megatron's
  pair around a column- and a row-parallel product, for activations
  every rank of the axis holds whole (the residual stream under the
  ``model`` axis);
- ``gather_from``: the all-gather along a dimension whose backward is
  the reduce-scatter, for a gathered tensor of which each rank then
  computes a different part (the masked positions under ``seq``).

A CUDA tensor goes over NCCL and a host tensor over gloo under the
``cpu:gloo,cuda:nccl`` group the CLI creates.  A world made with
``backend="gloo"`` (the check-only world of several ranks on one card)
carries CUDA tensors over gloo.  gloo's point-to-point ``send``/``recv``
take host tensors only (on the card a CUDA one fails in the socket
write; its all-reduce, all-gather, reduce-scatter and all-to-all take
CUDA tensors as they are: ``scripts/torch_gloo_cuda_probe.py``), so
``ppermute_shift`` stages a CUDA tensor through host memory on a gloo
group, and on no other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpi_tensorflow_torch.parallel.mesh import (Axis, active, process_count,
                                                process_index)


# the one-tensor forms: torch 2.13 renamed them (and deprecated the old
# names, which earlier versions alone have)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _group(axis: Optional[Axis]):
    """``(runs, group, size)``: whether a collective over ``axis`` runs
    (a process group is up and the axis has several ranks), its process
    group (``None``: the default one) and its size."""
    if not active():
        return False, None, 1
    if axis is None:
        return True, None, process_count()
    return axis.size > 1, axis.group, axis.size


def allreduce_sum(x: torch.Tensor, axis: Optional[Axis] = None
                  ) -> torch.Tensor:
    """The per-step gradient reduction (the reference's intended op)."""
    runs, group, _ = _group(axis)
    if runs:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def allreduce_mean(x: torch.Tensor, axis: Optional[Axis] = None
                   ) -> torch.Tensor:
    """The sum over the ranks divided by their count, as ``lax.pmean``
    computes it (the reference's ``np.mean(gathered, 0)``, mpipy.py:130-
    137, delivered to every rank)."""
    runs, _, size = _group(axis)
    if runs:
        allreduce_sum(x, axis).div_(size)
    return x


def allreduce_max(x: torch.Tensor, axis: Optional[Axis] = None
                  ) -> torch.Tensor:
    runs, group, _ = _group(axis)
    if runs:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def allgather(x: torch.Tensor, *, tiled: bool = False,
              axis: Optional[Axis] = None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``(n, *x.shape)``;
    ``tiled``: concatenated along the leading dimension instead,
    ``(n * x.shape[0], *x.shape[1:])``, in one tensor."""
    runs, group, size = _group(axis)
    if not runs:
        return x if tiled else x[None]
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out if tiled else out.view(size, *x.shape)


def allgather_dim(x: torch.Tensor, dim: int, axis: Optional[Axis] = None
                  ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (not
    differentiable; ``gather_from`` is)."""
    if not _group(axis)[0]:
        return x
    parts = allgather(x.movedim(dim, 0), tiled=True, axis=axis)
    return parts.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, axis: Optional[Axis] = None
                   ) -> torch.Tensor:
    """The sum over the ranks, of which rank r keeps the r-th of ``n``
    equal slices of the leading dimension (the reference's
    ``psum_scatter(tiled=True)``): the building block of the sharded
    optimizer states (``parallel.fsdp``, ``train.gspmd``)."""
    runs, group, size = _group(axis)
    if not runs:
        return x
    if x.shape[0] % size:
        raise ValueError(f"leading dimension {x.shape[0]} is not {size} "
                         f"equal slices")
    out = torch.empty((x.shape[0] // size, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _REDUCE_SCATTER(out, x.contiguous(), group=group)
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


# ---------------------------------------------- the model-parallel ones

def _shift(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """``x`` of the rank ``shift`` places before this one on ``axis``
    (this rank's goes ``shift`` places on): ``lax.ppermute`` with
    ``perm = [(i, (i + shift) % n)]``."""
    n = axis.size
    if n == 1 or shift % n == 0 or not active():
        return x
    dst = axis.ranks[(axis.index + shift) % n]
    src = axis.ranks[(axis.index - shift) % n]
    # gloo sends host memory only (module note)
    staged = x.device.type == "cuda" \
        and dist.get_backend(axis.group) == "gloo"
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group=axis.group),
        dist.P2POp(dist.irecv, recv, src, group=axis.group)])
    for r in reqs:
        r.wait()
    return recv.to(x.device) if staged else recv


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _shift(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.shift), None, None


def ppermute_shift(x: torch.Tensor, axis: Axis, shift: int = 1
                   ) -> torch.Tensor:
    """Ring rotation by ``shift`` along ``axis`` (JAX
    ``collectives.py:66``): rank i's ``x`` goes to rank ``(i + shift) %
    n``; differentiable, the gradient going the other way."""
    return _Shift.apply(x, axis, int(shift))


def _all_to_all(x: torch.Tensor, axis: Axis, split: int,
                concat: int) -> torch.Tensor:
    n = axis.size
    if n == 1 or not active():
        return x
    if x.shape[split] % n:
        raise ValueError(f"dimension {split} of {tuple(x.shape)} is not "
                         f"{n} equal slices")
    # (n, ...): slice j to rank j; contiguous, and so is the buffer made
    # like it (a stack of strided slices can keep their strides)
    send = torch.stack(x.chunk(n, split)).contiguous()
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send, group=axis.group)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.axis, ctx.split, ctx.concat = axis, split, concat
        return _all_to_all(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.axis, ctx.concat, ctx.split), None, None,
                None)


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into ``n`` equal slices along ``split_dim``, slice j sent
    to rank j, the slices received concatenated along ``concat_dim`` in
    rank order; differentiable (the backward is the inverse
    all-to-all)."""
    return _AllToAll.apply(x, axis, int(split_dim), int(concat_dim))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return allreduce_sum(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return allreduce_sum(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward, all-reduce backward: the input of a
    column-parallel product, held whole by every rank of ``axis``."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product (or of a vocabulary-parallel lookup) made
    whole on every rank of ``axis``."""
    return _ReduceFrom.apply(x, axis)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return allgather_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        part = reduce_scatter(g.movedim(ctx.dim, 0).contiguous(), ctx.axis)
        return part.movedim(0, ctx.dim), None, None


def gather_from(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; the backward sums the
    ranks' gradients and keeps this rank's slice (a reduce-scatter)."""
    return _GatherFrom.apply(x, axis, int(dim))
