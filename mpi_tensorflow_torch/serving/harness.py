"""Build the serving run the entry point and ``chip_smoke.py`` time.

The port's counterpart of the engine arm of the reference's
``bench.py --mode serving`` (``measure_serving``): the same model
geometry (``CausalLm`` at ``BERT_BASE``, or ``BERT_TINY``), the same
seeded Poisson trace (``loadgen``, vocabulary of the model), and the
same sizing rules — ``max_seq_len`` is the power of two at or above the
longest request, and the default pool holds every slot at full length
(no eviction churn).  Weights are random, drawn from seed 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import bert
from mpi_tensorflow_torch.models.gpt import CausalLm
from mpi_tensorflow_torch.serving import loadgen
from mpi_tensorflow_torch.serving.engine import (PagedDecodeEngine,
                                                 ServeConfig, pow2_ceil)
from mpi_tensorflow_torch.serving.paged_cache import blocks_for


def build_serving(*, num_requests: int = 24, rate_rps: float = 4.0,
                  prompt_max: int = 32, output_max: int = 128,
                  max_slots: Optional[int] = None,
                  precision: str = "fp32", tiny: bool = False,
                  kernel: Optional[str] = None,
                  block_size: Optional[int] = None,
                  pool_blocks: Optional[int] = None,
                  layers: Optional[int] = None, seed: int = 0,
                  device="cuda"):
    """-> ``(engine, trace)``.  Unset knobs resolve through ``Config``'s
    ``serve_*`` defaults; ``layers`` cuts the model's depth (widths stay
    the preset's)."""
    cfg = Config(precision=precision)
    max_slots = max_slots if max_slots is not None else cfg.serve_max_slots
    block_size = (block_size if block_size is not None
                  else cfg.serve_block_size)
    base = bert.BERT_TINY if tiny else bert.BERT_BASE
    bcfg = dataclasses.replace(base, dtype=cfg.compute_dtype,
                               layers=layers or base.layers)
    trace = loadgen.build_trace(loadgen.WorkloadSpec(
        num_requests=num_requests, rate_rps=rate_rps,
        prompt_max=prompt_max, output_max=output_max,
        vocab_size=bcfg.vocab_size, seed=seed))
    max_len = max(len(p) + o for p, o in zip(trace.prompts, trace.outputs))
    max_seq_len = pow2_ceil(max_len)
    if pool_blocks is None:
        pool_blocks = max_slots * blocks_for(max_seq_len, block_size) + 1
    serve = ServeConfig.from_config(
        cfg, num_blocks=pool_blocks, block_size=block_size,
        max_slots=max_slots, max_seq_len=max_seq_len, kernel=kernel)
    engine = PagedDecodeEngine(CausalLm.from_seed(bcfg, seed=0), serve,
                               device=device)
    return engine, trace
