#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors as they are, on the card.

    torchrun --nproc_per_node 2 scripts/torch_gloo_cuda_probe.py

Two ranks on ``cuda:0`` over gloo (the check-only worlds of
``chip_smoke.py`` phases 11, 12 and 22).  Each collective the port's
tensor and sequence parallelism runs is tried once on a CUDA tensor,
without the host staging of ``parallel/collectives.py``: the
all-reduce, the all-gather into one tensor and the reduce-scatter (the
data, model and seq axes' sums and gathers), the all-to-all (Ulysses)
and the point-to-point shift (the ring).  Rank 0 prints one JSON line:
each collective's ``ok`` (and whether the result was right) or the
error it raised.  A collective that waits past 30 s raises gloo's
timeout instead of hanging the probe.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import torch
import torch.distributed as dist


def _try(fn) -> str:
    try:
        return "ok" if fn() else "wrong result"
    except RuntimeError as e:           # gloo's refusal of a CUDA tensor
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def main() -> int:
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=30))
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.arange(4.0, device=dev) + 10 * rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y.cpu(), sum(torch.arange(4.0) + 10 * r
                                        for r in range(world)))

    def all_gather():
        y = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        return torch.equal(y.cpu(), torch.cat([torch.arange(4.0) + 10 * r
                                               for r in range(world)]))

    n = 4 // world                      # a rank's slice

    def reduce_scatter():
        y = torch.empty(n, device=dev)
        dist.reduce_scatter_tensor(y, x)
        want = sum(torch.arange(4.0) + 10 * r for r in range(world))
        return torch.equal(y.cpu(), want[rank * n:(rank + 1) * n])

    def all_to_all():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return torch.equal(y.cpu(), torch.cat([
            torch.arange(rank * n, (rank + 1) * n, dtype=torch.float32)
            + 10 * r for r in range(world)]))

    def shift():
        y = torch.empty_like(x)
        peer = (rank + 1) % world
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, peer),
                 dist.P2POp(dist.irecv, y, (rank - 1) % world)]):
            req.wait()
        return torch.equal(y.cpu(), torch.arange(4.0)
                           + 10 * ((rank - 1) % world))

    got = {name: _try(fn) for name, fn in (
        ("all_reduce", all_reduce), ("all_gather_into_tensor", all_gather),
        ("reduce_scatter_tensor", reduce_scatter),
        ("all_to_all_single", all_to_all), ("isend/irecv", shift))}
    if rank == 0:
        print(json.dumps({"torch": torch.__version__, "world": world,
                          "device": torch.cuda.get_device_name(0),
                          "gloo_cuda": got}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
