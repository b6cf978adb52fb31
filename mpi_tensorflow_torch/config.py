"""Run configuration — the fields the ported paths read.

Counterpart of ``mpi_tensorflow_tpu/config.py``: the reference MPI
script's knobs and the image-family fields ``train.loop.train`` reads
(the CNN and the ResNets, the momentum optimizer and staircase decay,
the trace and early-stop cadence, the windowed loop), the training fields
``train.mlm_loop.train_mlm`` and ``cli`` read, the precision knob and
its compute dtype, and the ``serve_*`` pool, kernel, feature and
fault-policy knobs ``serving.engine.ServeConfig.from_config`` bridges to
the engine.
Defaults equal the reference's.  A value whose path is not ported yet
raises at construction and names its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Config:
    # --- training (the reference's defaults, mpipy.py:18-21) ---
    epochs: int = 2               # ``iteration`` at mpipy.py:18
    image_size: int = 28
    batch_size: int = 64          # per-shard batch; the global batch is
                                  # batch_size x shards
    num_classes: int = 10         # the reference's misnamed ``num_channel``
    log_every: int = 50           # trace and held-out eval cadence
    seed: int = 1                 # the reference seeds everything with 1
    model: str = "mnist_cnn"      # the trainer's model family
    dataset: str = "mnist"
    data_dir: str = "./data"      # the four MNIST IDX files (or, when
                                  # absent, the synthetic set written
                                  # there); cifar-10-batches-bin or
                                  # imagenet_npy (else their synthetic
                                  # sets, nothing written)

    # --- image family: optimizer, schedule, loop ---
    base_lr: float = 0.01         # staircase exponential decay of the LR,
    lr_decay: float = 0.95        # once per local epoch
    momentum: float = 0.9         # TF MomentumOptimizer
    weight_decay: float = 5e-4    # L2 on the fc weights and biases
    dropout_rate: float = 0.5     # after fc1, in training only
    early_stop_patience: int = 0  # >0: stop when the validation error has
                                  # not improved for N trace points
    sync: str = "psum"            # "psum": per-step gradient mean over
                                  # the shards; "avg50": per-rank SGD with
                                  # parameters averaged every log_every
    fused_steps: int = 1          # steps per window of the loop (batches
                                  # uploaded once per window; > 1: one
                                  # graph replay a window on the card);
                                  # the CLI defaults it to --log-every
                                  # for psum
    prefetch: str = "auto"        # window assembly: thread / auto on a
                                  # background thread, off inline
                                  # ("native", the C++ worker: item 15c)
    mesh_shape: Optional[dict] = None  # {"data": D, "model": M, "seq":
                                       # N}: the product must be the
                                       # torch.distributed world size
                                       # (checked when training starts);
                                       # model / seq for bert_base and
                                       # gpt_base
    checkpoint_dir: Optional[str] = None  # sharded checkpoints at each
                                          # trace point; SIGTERM saves
                                          # and stops
    resume: bool = False          # restart from checkpoint_dir's latest
    metrics_dir: Optional[str] = None   # metrics.jsonl (rank 0)
    optimizer: str = "adamw"      # transformer-family optimizer: adamw
                                  # or lamb (layer-wise trust ratios)
    remat: bool = False           # recompute each transformer layer's
                                  # (ResNet block's) activations in the
                                  # backward
    grad_accum: int = 1           # microbatches per optimizer step: the
                                  # gradients accumulate before the one
                                  # reduction and update
    param_sharding: str = "replicated"  # transformer state layout:
                                        # replicated, zero1 (moments
                                        # sharded over the ranks) or fsdp
                                        # (parameters and moments)
    text_file: Optional[str] = None     # real-text corpus (None: synthetic)
    vocab_file: Optional[str] = None    # WordPiece vocabulary for
                                        # text_file (None: byte-level)

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
    serve_kv_dtype: str = "fp32"  # paged-pool storage: fp32 (the compute
                                  # dtype) | int8 (row-scaled codes) |
                                  # int4 (group-scaled nibbles + the
                                  # fp-residual self lane)
    serve_kv_group: int = 32      # int4 scale-group size along head_dim
                                  # (clamped to head_dim, must divide it)
    serve_kv_tier: str = "off"    # host-RAM block tier: "host" demotes
                                  # evicted prefix-cache blocks to host
                                  # memory and promotes them back on a
                                  # later match (needs the prefix cache)
    serve_prefix_cache: str = "off"  # radix prefix cache: "on" shares
                                  # cached full prompt blocks across
                                  # requests (copy-on-write, LRU trie
                                  # eviction)
    serve_prefix_gen: str = "off"  # prefix cache v2: "on" also caches a
                                  # finished request's generated blocks
                                  # and copies partial tail blocks
    serve_prefix_route: str = "off"  # "on": the replica router places a
                                  # request on the replica whose trie
                                  # holds its first block, load allowing
    serve_speculative: str = "off"  # speculative decoding: "ngram" or
                                  # "draft-model"; greedy outputs stay
                                  # those of "off"
    serve_draft_k: int = 4        # tokens proposed per verify forward
                                  # (its width is draft_k + 1)
    serve_draft_auto: str = "off"  # "on" tunes the draft window by an
                                  # EWMA of the accepted length, within
                                  # [1, serve_draft_k]
    serve_mixed_batch: str = "off"  # "on" fuses budget-capped prefill
                                  # chunks of several sequences into the
                                  # decode dispatch: one forward a step
    serve_prefill_budget: int = 64  # mixed batching: prefill tokens a
                                  # step may fuse across all sequences
    serve_tp: int = 1             # tensor-parallel ranks: heads and MLP
                                  # split over a torch.distributed world
                                  # of this size (serving/tp)
    serve_workload: str = "poisson"  # trace shape: poisson | bursty |
                                  # diurnal | multi-tenant (loadgen)
    serve_slo_ms: Optional[float] = None  # per-request latency budget
                                  # (stamped as its deadline; goodput)
    serve_trace: str = "off"      # "on": request spans and step records
                                  # (serving/tracing)
    serve_trace_out: Optional[str] = None  # Chrome trace-event JSON path
                                  # (needs serve_trace on)
    # fault-tolerance policy (serving/engine.ServeConfig; None = off)
    serve_deadline_ms: Optional[float] = None  # default per-request TTL
    serve_queue_depth: Optional[int] = None    # bound on the waiting queue
    serve_max_evictions: Optional[int] = None  # preemption-livelock guard
    serve_drain_ms: Optional[float] = None     # graceful-drain budget
    serve_failover_backoff_ms: float = 50.0    # replica circuit breaker

    # --- precision ---
    precision: str = "fp32"       # "fp32" | "bf16": compute dtype of the
                                  # matmuls; parameters stay float32

    def __post_init__(self):
        mesh = self.mesh_shape or {}
        big = {k for k, v in mesh.items() if v != 1}
        tp_sp = big & {"model", "seq"}
        not_ported = (
            ("expert" in big, f"mesh_shape={mesh} (the expert axis)",
             "14c (the expert axis and tensor-parallel experts)"),
            ("pipe" in big, f"mesh_shape={mesh} (the pipe axis)",
             "14d (the pipe axis and its schedules)"),
            (self.model == "moe_bert" and bool(tp_sp),
             f"moe_bert under mesh_shape={mesh}",
             "14c (the expert axis and tensor-parallel experts)"),
            (self.model == "encdec_t5" and "model" in big,
             f"encdec_t5 under mesh_shape={mesh}",
             "14e (encdec_t5 under the model axis)"),
            (self.prefetch == "native", "prefetch='native'",
             "15c (the C++ window worker)"),
        )
        for bad, what, item in not_ported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet: ROADMAP Queue 1 item {item}")
        if self.model == "encdec_t5" and "seq" in big:
            # the reference's refusal (mlm_loop.py:82-88)
            raise ValueError(
                f"the encoder-decoder family supports data x model "
                f"(Megatron TP) meshes only (mesh {mesh}); drop the other "
                f"axes rather than silently ignoring them")
        if tp_sp and self.model not in ("bert_base", "gpt_base",
                                        "moe_bert", "encdec_t5"):
            raise ValueError(
                f"the model and seq mesh axes apply to the transformer "
                f"families; --model {self.model} trains over the data axis "
                f"(mesh {mesh})")
        if self.optimizer not in ("adamw", "lamb"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.sync not in ("psum", "avg50"):
            raise ValueError(f"unknown sync mode {self.sync!r}")
        if self.prefetch not in ("auto", "native", "thread", "off"):
            raise ValueError(f"unknown prefetch mode {self.prefetch!r}")
        if self.param_sharding not in ("replicated", "zero1", "fsdp"):
            raise ValueError(
                f"unknown param_sharding {self.param_sharding!r} "
                f"(replicated, zero1 or fsdp)")
        if int(self.grad_accum) < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")
        if self.sync == "avg50" and self.grad_accum > 1:
            # the reference's refusal (train/loop.py:132-137)
            raise ValueError(
                "grad_accum applies to the psum (sync-SGD) and transformer "
                "paths; the avg50 fidelity mode reproduces the reference's "
                "per-rank batch-64 stepping, where microbatching has no "
                "counterpart")

    @property
    def num_channels(self) -> int:
        """Input channels (1 for MNIST)."""
        return 1

    @property
    def compute_dtype(self) -> torch.dtype:
        """The torch dtype the forward matmuls run in."""
        if self.precision == "bf16":
            return torch.bfloat16
        if self.precision == "fp32":
            return torch.float32
        raise ValueError(f"unknown precision {self.precision!r}")
