"""The port's train states as the reference's list of leaves, and back:
the one place the two packages' state layouts meet.

A checkpoint (``train.checkpoint``) holds a state as the leaves of the
reference's train-state pytree, in ``jax.tree.leaves`` order: a dict's
keys sorted, a list's items and a NamedTuple's fields in order.  The
port's trees keep their insertion order (``utils/tree.py``) and its
optimizer state is lists in parameter order, so ``parts`` walks the
reference's structure explicitly and ``load`` writes the restored
arrays back in place:

- the image families (``train.step.TrainState(model, opt:
  MomentumState, model_state)``) as the reference's
  ``TrainState(params, MomentumState(velocity, step), model_state)``:
  the parameters, the velocity (as the parameters' tree), the float32
  step counter, the model state (BatchNorm's running statistics).
  Conv weights (every 4-D leaf) are OIHW in the port and HWIO on disk,
  as ``models.convert`` turns them.  Under avg50 (``stacked``) the
  reference's state has a leading axis of one replica a rank
  (``step.stack_state``): every leaf is then ``(world, *shape)``, of
  which rank r holds and writes region r;
- the transformer family (``train.gspmd.TrainState(model, opt:
  AdamWState, step, sharding)``) as the reference's ``GspmdState(params,
  opt, model_state, step)`` with optax's chain state as ``opt``:
  ``clip_by_global_norm`` and the decay mask hold no leaves, so its
  leaves are adam's int32 ``count``, ``mu`` and ``nu`` (each as the
  parameters' tree), then the schedule's int32 ``count`` (the same
  number), then the int32 step; BERT's model state is empty.  Under
  zero1 the moments of each sharded leaf, and under fsdp its parameter
  too, are this rank's slice along ``fsdp.shard_dim`` over the data
  axis; under a model axis each model-sharded leaf (its parameter and
  moments) is this rank's block by the rules: the leaf is a grid of
  those blocks at their global offsets (``checkpoint.tiled``), each
  written by one of the ranks holding it (the one at index 0 of the
  other axes).  Every other leaf is whole, written by rank 0.  A state
  saved on one mesh restores on another.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpi_tensorflow_torch.parallel import mesh as meshlib
from mpi_tensorflow_torch.train import gspmd
from mpi_tensorflow_torch.train import step as step_lib
from mpi_tensorflow_torch.train.checkpoint import split, tiled, whole
from mpi_tensorflow_torch.utils import tree as tree_lib

# the port's OIHW conv weights <-> the reference's HWIO
_TO_HWIO, _FROM_HWIO = (2, 3, 1, 0), (3, 2, 0, 1)


def ref_order(tree) -> list:
    """The indices of ``tree``'s leaves (in the port's order) in the
    reference's ``jax.tree.leaves`` order: dict keys sorted."""
    numbered = tree_lib.unflatten(tree, range(len(tree_lib.leaves(tree))))

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from walk(v)
        else:
            yield node

    return list(walk(numbered))


# ------------------------------------------------------- image family

def _image_leaves(state: step_lib.TrainState) -> tuple[list, list, list]:
    """``(params, velocity, model state)`` tensors in the reference's
    order."""
    tree = state.model.param_tree()
    order = ref_order(tree)
    params = tree_lib.leaves(tree)
    ms = state.model_state
    ms_leaves = tree_lib.leaves(ms)
    return ([params[i] for i in order],
            [state.opt.velocity[i] for i in order],
            [ms_leaves[i] for i in ref_order(ms)])


def _to_disk(t: torch.Tensor) -> torch.Tensor:
    return t.detach().permute(_TO_HWIO) if t.dim() == 4 else t.detach()


def image_parts(state: step_lib.TrainState, stacked: bool = False,
                rank: Optional[int] = None,
                world: Optional[int] = None) -> list:
    """The reference ``TrainState``'s leaves of an image-family state;
    ``stacked``: avg50's replica-per-rank layout.  ``rank`` and ``world``
    are this process's unless given (one process laying out each rank's
    part)."""
    rank = meshlib.process_index() if rank is None else rank
    world = meshlib.process_count() if world is None else world
    params, velocity, ms = _image_leaves(state)
    step = np.asarray(state.opt.step, np.float32)

    def part(x):
        if not stacked:
            return whole(x, writes=rank == 0)
        return split(x, (world,) + tuple(x.shape), 0, rank, world)

    return ([part(_to_disk(p)) for p in params]
            + [part(_to_disk(v)) for v in velocity] + [part(step)]
            + [part(t.detach()) for t in ms])


@torch.no_grad()
def load_image(state: step_lib.TrainState, arrays: list,
               stacked: bool = False) -> step_lib.TrainState:
    """``image_parts``' arrays (this rank's regions) written into
    ``state`` in place: parameters, velocity, step counter, model
    state."""
    params, velocity, ms = _image_leaves(state)
    if stacked:
        arrays = [a[0] for a in arrays]
    n = len(params)
    if len(arrays) != 2 * n + 1 + len(ms):
        raise ValueError(f"{len(arrays)} arrays for a state of "
                         f"{2 * n + 1 + len(ms)} leaves")

    def fill(dst, a):
        src = torch.from_numpy(np.ascontiguousarray(a))
        if dst.dim() == 4:
            src = src.permute(_FROM_HWIO)
        dst.copy_(src)

    for dst, a in zip(params + velocity, arrays[:2 * n]):
        fill(dst, a)
    state.opt.step = np.float32(np.asarray(arrays[2 * n]).reshape(()))
    # the model state is replaced, not written in place: a step returns
    # new statistics tensors rather than updating the old ones
    ms_tree = state.model_state
    old = tree_lib.leaves(ms_tree)
    new = list(old)
    for i, a in zip(ref_order(ms_tree), arrays[2 * n + 1:]):
        new[i] = torch.from_numpy(np.array(a, copy=True)).to(old[i].device,
                                                              old[i].dtype)
    state.model_state = tree_lib.unflatten(ms_tree, new)
    return state


# ------------------------------------------------- transformer family

def _gspmd_leaves(state: gspmd.TrainState) -> tuple[list, list, list, list]:
    """``(order, params, dims, shapes)``: the reference order of the
    parameter leaves, each leaf as this rank holds it (whole, or under
    fsdp its slice), the shard dimension of each (None: whole), and the
    whole shapes."""
    tree = state.model.param_tree()
    params = tree_lib.leaves(tree)
    sh = state.sharding
    dims = [None] * len(params) if sh is None else list(sh.dims)
    shapes = [tuple(p.shape) for p in params] if sh is None \
        else list(sh.shapes)
    if sh is not None and sh.kind == "fsdp":
        views = sh.layout.views(sh.shards)
        params = [views.get(i, p) for i, p in enumerate(params)]
    return ref_order(tree), params, dims, shapes


def gspmd_parts(state: gspmd.TrainState) -> list:
    """The reference ``GspmdState``'s leaves of a transformer state."""
    order, params, dims, shapes = _gspmd_leaves(state)
    model, sh = state.model, state.sharding
    mesh = model.mesh
    rank = meshlib.process_index()
    specs = model.leaf_specs()
    fsdp_params = sh is not None and sh.kind == "fsdp"

    def part(x, i, sliced):
        # this rank's block: over the model axis by the rules, over the
        # data axis where zero1 / fsdp slice the leaf
        splits, used = [], set()
        shape = list(shapes[i])
        for d, ax in enumerate(specs[i]):
            if ax:
                splits.append((d, mesh.axis_size(ax), mesh.axis_index(ax)))
                shape[d] *= mesh.axis_size(ax)
                used.add(ax)
        if sliced and dims[i] is not None:
            splits.append((dims[i], sh.world, sh.rank))
            used.add("data")
        if not splits:
            return whole(x.detach(), writes=rank == 0)
        # of the ranks holding one region, the one at 0 on the other axes
        writes = mesh is None or all(
            c == 0 for a, c in mesh.coords.items() if a not in used)
        return tiled(x.detach(), shape, splits, writes)

    count = np.asarray(state.opt.count, np.int32)
    return ([part(params[i], i, fsdp_params) for i in order]
            + [whole(count, writes=rank == 0)]
            + [part(state.opt.mu[i], i, True) for i in order]
            + [part(state.opt.nu[i], i, True) for i in order]
            + [whole(count, writes=rank == 0),
               whole(np.asarray(state.step, np.int32), writes=rank == 0)])


@torch.no_grad()
def load_gspmd(state: gspmd.TrainState, arrays: list) -> gspmd.TrainState:
    """``gspmd_parts``' arrays (this rank's regions) written into
    ``state`` in place: parameters (or fsdp's slices of them), moments,
    counts."""
    order, params, _, _ = _gspmd_leaves(state)
    n = len(order)
    if len(arrays) != 3 * n + 3:
        raise ValueError(f"{len(arrays)} arrays for a state of "
                         f"{3 * n + 3} leaves")
    # params, count, mu, nu, count, step
    for base, dsts in ((0, params), (n + 1, state.opt.mu),
                       (2 * n + 1, state.opt.nu)):
        for j, i in enumerate(order):
            dsts[i].copy_(torch.from_numpy(np.ascontiguousarray(
                arrays[base + j])))
    if int(arrays[n]) != int(arrays[3 * n + 1]):
        raise ValueError(f"adam's count {int(arrays[n])} and the "
                         f"schedule's {int(arrays[3 * n + 1])} differ")
    state.opt.count = int(arrays[n])
    state.step = int(arrays[3 * n + 2])
    return state


# ---------------------------------------------------------- dispatch

def parts(state, stacked: bool = False) -> list:
    """The checkpoint leaves of either family's state."""
    if isinstance(state, gspmd.TrainState):
        return gspmd_parts(state)
    return image_parts(state, stacked)


def load(state, arrays: list, stacked: bool = False):
    """``arrays`` (``parts``' regions, restored) into ``state``."""
    if isinstance(state, gspmd.TrainState):
        return load_gspmd(state, arrays)
    return load_image(state, arrays, stacked)
