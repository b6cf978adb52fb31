"""Run configuration — the fields the ported serving path reads.

Counterpart of ``mpi_tensorflow_tpu/config.py``: the precision knob and
its compute dtype, plus the ``serve_*`` pool, kernel and fault-policy
knobs ``serving.engine.ServeConfig.from_config`` bridges to the engine.
Defaults equal the reference's.  Training fields arrive with the
training slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Config:
    # --- serving (continuous-batching decode engine, serving/) ---
    serve_pool_blocks: int = 128  # paged-KV pool size in blocks (block 0
                                  # reserved as the null/scratch block)
    serve_block_size: int = 16    # cache entries per pool block
    serve_max_slots: int = 8      # concurrent sequences (decode batch cap)
    serve_max_seq_len: int = 512  # per-request prompt+output cap; also
                                  # sizes the per-sequence block table
    serve_kernel: str = "auto"    # paged-attention lowering: auto (the
                                  # CUDA kernel for CUDA tensors, the
                                  # gather path on the CPU) | gather |
                                  # cuda
    # fault-tolerance policy (serving/engine.ServeConfig; None = off)
    serve_deadline_ms: Optional[float] = None  # default per-request TTL
    serve_queue_depth: Optional[int] = None    # bound on the waiting queue
    serve_max_evictions: Optional[int] = None  # preemption-livelock guard
    serve_drain_ms: Optional[float] = None     # graceful-drain budget
    serve_failover_backoff_ms: float = 50.0    # replica circuit breaker

    # --- precision ---
    precision: str = "fp32"       # "fp32" | "bf16": compute dtype of the
                                  # matmuls; parameters stay float32

    @property
    def compute_dtype(self) -> torch.dtype:
        """The torch dtype the forward matmuls run in."""
        if self.precision == "bf16":
            return torch.bfloat16
        if self.precision == "fp32":
            return torch.float32
        raise ValueError(f"unknown precision {self.precision!r}")
