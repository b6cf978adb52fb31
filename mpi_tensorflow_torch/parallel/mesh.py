"""Process bootstrap and the mesh of named axes over ``torch.distributed``.

Counterpart of ``mpi_tensorflow_tpu/parallel/mesh.py``.  Where the JAX
package joins hosts with ``jax.distributed.initialize`` and lays the
devices out on a mesh of named axes, the port runs one process per card
(``torchrun --nproc_per_node N``) and lays the ``torch.distributed``
world out on the mesh: rank ``r`` is device ``r``.

- ``initialize_distributed`` joins the world that torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or explicit arguments describe.  Without either it
  does nothing: the world is one process with no process group, and no
  collective runs.  A launch that is configured but fails to join
  raises; it never degrades to one process, which would train on 1/N of
  the data with no error (the JAX package's rule, ``mesh.py:59-68``);
- the backend follows the device the caller names: ``cpu:gloo,cuda:nccl``
  for a card (NCCL carries CUDA tensors, gloo the host ones), ``gloo``
  for the CPU.  Nothing picks another backend on its own; a caller that
  wants gloo for CUDA tensors passes ``backend="gloo"``;
- ``rank_device``: ``cuda`` under a launch is the card ``cuda:LOCAL_RANK``,
  made the current device.  A local rank with no card of its own
  raises: NCCL refuses two ranks on one card, and wrapping would hide a
  launch with more ranks than cards;
- ``make_mesh`` lays named axes (``data``, ``model``, ``seq``) over the
  world, as the JAX package's does over its devices: the product must
  be the world size (its "mesh ... needs N devices"), rank ``r`` sits at
  ``np.unravel_index(r, sizes)``, and ``Mesh.group(*axes)`` is the line
  of ranks through this one along those axes, with its own process
  group (created on every rank, in one order, once a world: a later
  mesh over the same ranks reuses it, ``shutdown`` drops them with the
  world).  The collectives
  (``parallel.collectives``) take such an ``Axis``.  An ``expert`` or
  ``pipe`` axis is ROADMAP Queue 1 item 14c or 14d.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import socket
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

# torchrun sets all five for every worker
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")


def launched() -> bool:
    """Whether this process runs under a launcher (``WORLD_SIZE`` set)."""
    return "WORLD_SIZE" in os.environ


def active() -> bool:
    """Whether a process group is up in this process."""
    return dist.is_available() and dist.is_initialized()


def backend_for(device) -> str:
    """The process group's backend for ``device``'s tensors: NCCL for a
    card (gloo beside it for host tensors), gloo for the CPU."""
    if torch.device(device).type == "cuda":
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda`` with no index under a launch is
    ``cuda:LOCAL_RANK``, made the current device; any other value is
    returned as it is.  Raises when the local rank has no card of its
    own."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not launched():
        return dev
    local = int(os.environ.get("LOCAL_RANK", 0))
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(
            f"local rank {local} has no card of its own ({count} visible); "
            f"launch at most one rank per card")
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    return dev


def initialize_distributed(device="cuda", backend: Optional[str] = None, *,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout: datetime.timedelta = datetime.timedelta(
                               minutes=10)) -> bool:
    """Join the world (the ``mpiexec`` equivalent); True when this call
    created the process group.

    ``init_method``, ``rank`` and ``world_size`` describe the world
    explicitly (``tcp://host:port``); otherwise torchrun's environment
    does (``env://``).  With neither, and when a group is already up,
    this is a no-op that returns False.  ``backend`` defaults to
    ``backend_for(device)``."""
    if active():
        return False
    if init_method is None:
        if not launched():
            return False
        missing = [k for k in LAUNCH_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"a launch sets WORLD_SIZE but not {missing}")
        init_method = "env://"
        rank, world_size = int(os.environ["RANK"]), int(
            os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    backend = backend or backend_for(device)
    _SUBGROUPS.clear()
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    except (RuntimeError, ValueError, OSError) as e:
        # the mpiexec equivalent of a rank failing to join COMM_WORLD is a
        # launch failure, never a quiet fall back to one process
        raise RuntimeError(
            f"distributed initialization failed for a configured launch "
            f"(rank {rank} of {world_size}, {init_method}, backend "
            f"{backend}): {e}") from e
    return True


def shutdown() -> None:
    """Tear the process group down, if one is up, and every subgroup
    ``make_mesh`` made in it."""
    _SUBGROUPS.clear()
    if active():
        dist.destroy_process_group()


def process_index() -> int:
    """The ``comm.Get_rank()`` analogue (mpipy.py:209): 0 without a
    group."""
    return dist.get_rank() if active() else 0


def process_count() -> int:
    """The ``comm.Get_size()`` analogue (mpipy.py:210): 1 without a
    group."""
    return dist.get_world_size() if active() else 1


#: the mesh axes the port honours; ``expert`` and ``pipe`` are still to
#: port (ROADMAP Queue 1 items 14c and 14d)
AXES = ("data", "model", "seq")
NOT_PORTED = {"expert": "14c (the expert axis and tensor-parallel "
                        "experts)",
              "pipe": "14d (the pipe axis and its schedules)"}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One line of the mesh along ``names``: the ranks whose coordinates
    differ only on those axes.  ``index`` is this rank's place among
    ``ranks`` (row-major over ``names``, as the mesh orders them);
    ``group`` is their process group, ``None`` for the default group
    (the whole world) and for a line of one rank, where no collective
    runs."""
    names: tuple
    size: int
    index: int
    ranks: tuple
    group: object = None


class Mesh(dict):
    """Axis name -> size, in the order the spec names them (the JAX
    package's ``Mesh.shape``), with this rank's coordinates and one
    process group per line along each axis and each set of axes.

    Rank ``r``'s coordinates are ``np.unravel_index(r, sizes)``, so port
    rank ``r`` holds the shard JAX device ``r`` holds on the same mesh.
    """

    def __init__(self, sizes: Mapping[str, int], rank: int, lines: dict):
        super().__init__(sizes)
        self.rank = rank
        self.coords = dict(zip(sizes, (int(c) for c in np.unravel_index(
            rank, tuple(sizes.values()))))) if sizes else {}
        self._lines = lines

    def axis_size(self, axis: str) -> int:
        return int(self.get(axis, 1))

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, *axes: str) -> Axis:
        """The line through this rank along ``axes`` (axes the mesh lacks,
        or has at size 1, count for nothing)."""
        return self._lines[tuple(a for a in self if a in axes
                                 and self[a] > 1)]


#: the subgroups made in this world, by their ranks: every rank makes the
#: same meshes in one order, so every rank skips the same ``new_group``
_SUBGROUPS: dict = {}


def _subgroup(ranks: list):
    key = tuple(ranks)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_group(ranks)
    return _SUBGROUPS[key]


def _line_ranks(sizes: dict, coords: dict, names: tuple) -> list:
    """The global ranks of the line through ``coords`` along ``names``,
    row-major over ``names``."""
    axes = list(sizes)
    out = []
    for sub in itertools.product(*(range(sizes[a]) for a in names)):
        c = dict(coords, **dict(zip(names, sub)))
        out.append(int(np.ravel_multi_index([c[a] for a in axes],
                                            [sizes[a] for a in axes])))
    return out


def make_mesh(shape: Optional[Mapping[str, int]] = None) -> Mesh:
    """The mesh of named axes over the world (the JAX package's
    ``make_mesh``): ``shape`` maps axis -> size in the order it names
    them; one size of -1 absorbs the rest of the world; the product must
    equal the world size (default ``{"data": world}``).  The subgroups of
    every line along each set of axes larger than 1 are created here, on
    every rank in the same order, or taken from an earlier mesh of the
    same world; a world of one process needs none."""
    world = process_count()
    shape = dict(shape or {"data": world})
    for k, v in shape.items():
        if k in NOT_PORTED and v != 1:
            raise NotImplementedError(
                f"mesh axis {k!r} (mesh {shape}) is not ported yet: ROADMAP "
                f"Queue 1 item {NOT_PORTED[k]}")
        if k not in AXES and k not in NOT_PORTED:
            raise ValueError(f"unknown mesh axis {k!r}; the port's axes "
                             f"are {AXES}")
    sizes = {k: int(v) for k, v in shape.items() if k in AXES}
    if list(sizes.values()).count(-1) > 1:
        raise ValueError(f"mesh {shape}: at most one axis of size -1")
    if -1 in sizes.values():
        known = math.prod(v for v in sizes.values() if v != -1)
        sizes[next(k for k, v in sizes.items() if v == -1)] = world // known
    total = math.prod(sizes.values())
    if total != world:
        raise ValueError(f"mesh {shape} needs {total} processes (one rank "
                         f"per card), have {world}")
    rank = process_index()
    mesh = Mesh(sizes, rank, {(): Axis((), 1, 0, (rank,))})
    big = tuple(a for a in sizes if sizes[a] > 1)
    for n in range(1, len(big) + 1):
        for names in itertools.combinations(big, n):
            size = math.prod(sizes[a] for a in names)
            if size == world:          # the whole world: the default group
                mine = _line_ranks(sizes, mesh.coords, names)
                mesh._lines[names] = Axis(names, size, mine.index(rank),
                                          tuple(mine))
                continue
            # every rank creates every line's group, in one order
            others = [a for a in sizes if a not in names]
            for sub in itertools.product(*(range(sizes[a]) for a in others)):
                ranks = _line_ranks(sizes, dict(zip(others, sub)), names)
                group = _subgroup(ranks)
                if rank in ranks:
                    mesh._lines[names] = Axis(names, size, ranks.index(rank),
                                              tuple(ranks), group)
    return mesh


def data_axis_size(mesh: Mapping[str, int]) -> int:
    return int(mesh.get("data", 1))
