"""Process bootstrap and the ``data`` axis over ``torch.distributed``.

Counterpart of ``mpi_tensorflow_tpu/parallel/mesh.py``.  Where the JAX
package joins hosts with ``jax.distributed.initialize`` and lays the
devices of one process out on a ``data`` mesh axis, the port runs one
process per card (``torchrun --nproc_per_node N``) and the ``data`` axis
is the ``torch.distributed`` world: rank ``r`` is shard ``r``.

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
- ``make_mesh`` checks a ``{"data": n}`` shape against the world size
  (the JAX package's "mesh ... needs N devices"); a ``model``, ``seq`` or
  ``pipe`` axis is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Mapping, Optional

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
    """Tear the process group down, if one is up."""
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


def make_mesh(shape: Optional[Mapping[str, int]] = None) -> dict:
    """The mesh ``{"data": world size}``.  ``shape`` (axis -> size; -1
    absorbs the world) must give the ``data`` axis the world size."""
    world = process_count()
    shape = dict(shape or {"data": world})
    others = {k: v for k, v in shape.items() if k != "data" and v != 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {others} are not ported yet: ROADMAP Queue 1 item "
            f"14 (model parallelism)")
    data = shape.get("data", 1)
    data = world if data == -1 else int(data)
    if data != world:
        raise ValueError(f"mesh {shape} needs {data} processes (one rank "
                         f"per card), have {world}")
    return {"data": world}


def data_axis_size(mesh: Mapping[str, int]) -> int:
    return int(mesh.get("data", 1))
