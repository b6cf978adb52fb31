"""Continuous-batching serving over a paged KV cache (PyTorch + CUDA).

Counterpart of ``mpi_tensorflow_tpu/serving``:

- ``paged_cache``  — the refcounted block allocator, the device pools,
                     the partial block copy and the host-RAM tier;
- ``prefix_cache`` — the radix trie of cached full blocks (LRU eviction,
                     demotion to and promotion from the host tier);
- ``scheduler``    — request queue, admit-on-free-blocks, eviction under
                     pressure, fault policy, one terminal status per
                     request (ported whole);
- ``iteration``    — the per-iteration body (submit stamping, deadline
                     sweep, latency cadence) and the drain state machine;
- ``speculative``  — the ngram and draft-model drafters;
- ``engine``       — chunked prefill + one-token decode at bucketed
                     shapes through ``models/gpt.CausalLm.forward_paged``,
                     with copy-on-write, mixed batching and the verify
                     step of speculation;
- ``loadgen``      — seeded synthetic traces, byte-identical to the
                     reference's for the same spec, and the goodput join;
- ``recovery``     — the replay journal and its supervisor;
- ``router``       — replicas behind one router: placement, health,
                     failover, fleet drain;
- ``tracing``      — request spans, step records, the Chrome trace;
- ``autoscale``    — the advisory scale decisions;
- ``tp``           — heads and MLP split over ``torch.distributed`` ranks;
- ``harness``      — the serving runs both entry points time.

``python -m mpi_tensorflow_torch.serving`` serves one such trace and
prints one JSON line (see ``__main__``).
"""

from mpi_tensorflow_torch.serving.engine import (  # noqa: F401
    PagedDecodeEngine, ServeConfig, pow2_ceil)
from mpi_tensorflow_torch.serving.loadgen import (  # noqa: F401
    Trace, WorkloadSpec, build_trace)
from mpi_tensorflow_torch.serving.paged_cache import (  # noqa: F401
    BlockAllocator, blocks_for, init_pools)
from mpi_tensorflow_torch.serving.scheduler import (  # noqa: F401
    Request, RejectedRequest, Scheduler, TERMINAL_STATUSES)
