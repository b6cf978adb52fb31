"""ZeRO/FSDP placement over the ``data`` axis: which dimension of each
parameter a rank holds a slice of.

Counterpart of ``mpi_tensorflow_tpu/parallel/fsdp.py``:

- ``shard_dim`` is ``augment_spec``: the largest dimension divisible by
  the data axis' size (and at least as long) among those no other axis
  shards (``taken``: the ``model`` axis' dimensions of the rules), the
  first of equals winning, as the reference's strict ``>`` picks;
  ``None`` (replicated) for a leaf under ``min_size`` elements or with
  no such dimension.  The shape is the whole leaf's;
- ``tree_shard_dims`` is ``fsdp_tree_specs``: that choice at every leaf
  of a parameter tree;
- ``shard`` takes rank r's slice of a leaf along its dimension;
- ``FlatLayout``: the sharded leaves of a tree laid out for one
  collective, ``world`` chunks of equal length back to back, chunk r
  holding rank r's slice of every sharded leaf with the shard dimension
  first.  ``collectives.reduce_scatter`` of a packed buffer leaves each
  rank its own chunk, ``collectives.allgather(..., tiled=True)`` of the
  chunks rebuilds the buffer, and ``whole`` / ``unpack`` rebuild the
  leaves from it (``train.gspmd``).

This is host logic: the dimension chosen is the reference's exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

# Parameters smaller than this stay replicated (biases, LayerNorm scales):
# the reference's threshold, below which a gather costs more than the
# memory a shard saves
DEFAULT_MIN_SIZE = 1024


def shard_dim(shape: Sequence[int], world: int,
              min_size: int = DEFAULT_MIN_SIZE,
              taken=()) -> Optional[int]:
    """The dimension of a leaf of ``shape`` that ``world`` ranks each
    hold a slice of, or None when the leaf stays replicated.  ``taken``:
    dimensions another mesh axis shards already (the rules' ``model``
    axis), which the data axis leaves alone."""
    if world <= 1 or math.prod(shape) < min_size:
        return None
    best = None
    for d, n in enumerate(shape):
        if d not in taken and n % world == 0 and n >= world:
            if best is None or n > shape[best]:
                best = d
    return best


def tree_shard_dims(tree, world: int, min_size: int = DEFAULT_MIN_SIZE):
    """``shard_dim`` at every leaf of a nested dict/list tree of tensors
    (or of anything with a ``shape``), in the tree's nesting."""
    if isinstance(tree, dict):
        return {k: tree_shard_dims(v, world, min_size)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_shard_dims(v, world, min_size) for v in tree]
    return shard_dim(tuple(tree.shape), world, min_size)


def shard(x: torch.Tensor, dim: Optional[int], rank: int,
          world: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` along ``dim`` (a view); ``x``
    itself when ``dim`` is None."""
    if dim is None:
        return x
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


@dataclasses.dataclass(frozen=True)
class _Entry:
    leaf: int           # index in the tree's leaf order
    dim: int            # the shard dimension
    rows: int           # the slice's length along it
    rest: tuple         # the leaf's other dimensions, in order
    offset: int         # where the slice starts in a chunk
    size: int           # the slice's elements


class FlatLayout:
    """The sharded leaves of one tree (``dims``: ``shard_dim`` per leaf,
    in leaf order, for leaves of ``shapes``) in ``world`` chunks of
    ``chunk`` elements: chunk r is rank r's slice of every sharded leaf,
    each with its shard dimension moved first."""

    def __init__(self, shapes: Sequence[Sequence[int]],
                 dims: Sequence[Optional[int]], world: int):
        self.world = world
        self.entries = []
        offset = 0
        for i, (shape, d) in enumerate(zip(shapes, dims)):
            if d is None:
                continue
            rows = shape[d] // world
            rest = tuple(shape[:d]) + tuple(shape[d + 1:])
            size = rows * math.prod(rest)
            self.entries.append(_Entry(i, d, rows, rest, offset, size))
            offset += size
        self.chunk = offset

    def _slots(self, flat: torch.Tensor):
        """``(entry, (world, rows, *rest) view of ``flat``)`` pairs."""
        grid = flat.view(self.world, self.chunk)
        for e in self.entries:
            yield e, grid[:, e.offset:e.offset + e.size].view(
                self.world, e.rows, *e.rest)

    def _split(self, e: _Entry, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a whole leaf) as (world, rows, *rest), a view."""
        return x.movedim(e.dim, 0).unflatten(0, (self.world, e.rows))

    @torch.no_grad()
    def pack(self, leaves: Sequence[torch.Tensor],
             out: torch.Tensor) -> torch.Tensor:
        """Every sharded leaf of ``leaves`` (whole leaves, in leaf
        order) copied into ``out`` (``world * chunk`` elements)."""
        for e, slot in self._slots(out):
            slot.copy_(self._split(e, leaves[e.leaf]))
        return out

    @torch.no_grad()
    def unpack(self, flat: torch.Tensor,
               leaves: Sequence[torch.Tensor]) -> None:
        """The inverse of ``pack``: ``flat`` copied into the whole
        leaves."""
        for e, slot in self._slots(flat):
            self._split(e, leaves[e.leaf]).copy_(slot)

    @torch.no_grad()
    def whole(self, flat: torch.Tensor) -> dict:
        """``{leaf index: the whole leaf}`` from a packed ``flat``, each
        a new contiguous tensor."""
        out = {}
        for e, slot in self._slots(flat):
            shape = list(e.rest)
            shape.insert(e.dim, self.world * e.rows)
            out[e.leaf] = flat.new_empty(shape)
            self._split(e, out[e.leaf]).copy_(slot)
        return out

    @torch.no_grad()
    def pack_own(self, leaves: Sequence[torch.Tensor], rank: int,
                 out: torch.Tensor) -> torch.Tensor:
        """Rank ``rank``'s slice of every sharded leaf copied into its
        chunk ``out`` (``chunk`` elements)."""
        for e in self.entries:
            self._view(e, out).copy_(
                shard(leaves[e.leaf], e.dim, rank, self.world))
        return out

    def _view(self, e: _Entry, chunk: torch.Tensor) -> torch.Tensor:
        return chunk[e.offset:e.offset + e.size].view(
            e.rows, *e.rest).movedim(0, e.dim)

    def views(self, chunk: torch.Tensor) -> dict:
        """``{leaf index: its slice in ``chunk``}``, each a view shaped
        as ``shard`` gives it (the shard dimension in its place)."""
        return {e.leaf: self._view(e, chunk) for e in self.entries}
