"""Logical-axis sharding rules: which block of each parameter a rank
holds.

Counterpart of ``mpi_tensorflow_tpu/parallel/sharding_rules.py``.  Models
name every parameter's dimensions with logical axes (``("embed",
"heads", "head_dim")``, ...); the rule table maps a logical axis to a
mesh axis.  ``DEFAULT_RULES`` is the Megatron layout: attention heads,
the MLP's hidden width and the vocabulary over ``model``, batch over
``data``, sequence over ``seq``.

- ``spec_for`` / ``tree_specs``: the reference's, a spec being a tuple
  of mesh axes (or None) per dimension, trailing Nones dropped; an axis
  the mesh lacks, or has at size 1, is replicated;
- ``shard_leaf`` / ``shard_tree``: a whole leaf sliced to this rank's
  block (``jax.device_put`` with the ``NamedSharding``, on one rank).
  A dimension its mesh axis does not divide raises, as ``device_put``
  does at that shape (BERT_BASE's vocabulary of 30522 splits evenly at
  ``model=2``);
- ``gather_leaf`` / ``gather_tree``: the inverse, each leaf gathered
  whole over its axes (a collective: every rank of the mesh calls it).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from mpi_tensorflow_torch.parallel import collectives

# logical axis -> mesh axis (None = replicate)
DEFAULT_RULES: dict = {
    "batch": "data",
    "seq": "seq",
    "embed": None,       # hidden/residual stream replicated
    "heads": "model",    # attention heads tensor-parallel
    "head_dim": None,
    "mlp": "model",      # MLP hidden tensor-parallel
    "vocab": "model",    # embedding/LM-head vocab-parallel
    "pos": None,
    "classes": None,
    "expert": "expert",  # MoE expert stacks (not ported: item 14c)
    "expert_classes": None,
    "capacity": None,
    "stage": "pipe",     # pipeline stages (not ported: item 14d)
    "layer": None,
    "vchunk": None,
}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def spec_for(logical_axes: tuple, rules: Optional[Mapping] = None,
             mesh: Optional[Mapping] = None) -> tuple:
    """The mesh axis of each dimension (None: replicated), dropping mesh
    axes the mesh lacks or has at size 1, trailing Nones removed."""
    rules = DEFAULT_RULES if rules is None else rules
    mesh = mesh or {}
    out = []
    for ax in logical_axes:
        mesh_ax = rules.get(ax)
        out.append(mesh_ax if mesh_ax is not None
                   and mesh.get(mesh_ax, 1) > 1 else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _map(fn, tree, logical):
    """``fn(leaf, logical axes)`` over a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, logical[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_axes(logical):
        return [_map(fn, v, a) for v, a in zip(tree, logical)]
    return fn(tree, logical)


def tree_specs(logical_tree, mesh: Mapping, rules: Optional[Mapping] = None):
    """The tree of logical-axis tuples -> the tree of specs."""
    if isinstance(logical_tree, dict):
        return {k: tree_specs(v, mesh, rules) for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [tree_specs(v, mesh, rules) for v in logical_tree]
    return spec_for(logical_tree, rules, mesh)


def shard_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` (a view)."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.axis_size(ax)
        if x.shape[d] % n:
            raise ValueError(
                f"a leaf of shape {tuple(x.shape)} with spec {spec} needs "
                f"dimension {d} ({x.shape[d]}) divisible by the {ax!r} axis "
                f"size {n}")
        rows = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(ax) * rows, rows)
    return x


def gather_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block ``x`` of it."""
    for d, ax in enumerate(spec):
        if ax is not None:
            x = collectives.allgather_dim(x, d, mesh.group(ax))
    return x


def shard_tree(tree, logical_tree, mesh, rules: Optional[Mapping] = None):
    """Each leaf of ``tree`` sliced to this rank's block (copies)."""
    return _map(lambda x, axes: shard_leaf(
        x, spec_for(axes, rules, mesh), mesh).clone(), tree, logical_tree)


def gather_tree(tree, logical_tree, mesh, rules: Optional[Mapping] = None):
    """The inverse of ``shard_tree``: every leaf whole (a collective)."""
    return _map(lambda x, axes: gather_leaf(
        x, spec_for(axes, rules, mesh), mesh), tree, logical_tree)
