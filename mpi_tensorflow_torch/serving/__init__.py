"""Continuous-batching serving over a paged KV cache (PyTorch + CUDA).

Counterpart of ``mpi_tensorflow_tpu/serving`` for its default path:

- ``paged_cache`` — the refcounted block allocator and the device pools;
- ``scheduler``   — request queue, admit-on-free-blocks, eviction under
                    pressure, fault policy, one terminal status per
                    request (ported whole);
- ``iteration``   — the per-iteration body (submit stamping, deadline
                    sweep, latency cadence) and the drain state machine;
- ``engine``      — chunked prefill + one-token decode at bucketed
                    shapes through ``models/gpt.CausalLm.forward_paged``;
- ``loadgen``     — seeded synthetic traces, byte-identical to the
                    reference's for the same spec.

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
