"""mpi_tensorflow_torch — the PyTorch + CUDA port of mpi_tensorflow_tpu.

The JAX package beside this one is the reference; this package does the
same jobs in PyTorch on an NVIDIA H100, with a hand-written Hopper
kernel wherever the JAX package had a Pallas kernel.  It imports
``torch`` and numpy only — never ``jax``, and nothing of
``mpi_tensorflow_tpu`` (whose package ``__init__`` imports JAX).

Layout mirrors the reference so each counterpart is easy to find:

- ``config``   — the run-config fields the ported paths read;
- ``cli``      — ``python -m mpi_tensorflow_torch``, the trainer;
- ``data``     — the synthetic MLM stream;
- ``models``   — the transformer layer math and ``BertMlm`` (``bert``),
                 the causal LM with its paged forward (``gpt``), and the
                 parameter-tree converter (``convert``);
- ``ops``      — the CUDA paged-attention and flash-attention kernels
                 with their plain PyTorch twins, paged KV-cache ops, and
                 the MLM head's masked-position packing;
- ``parallel`` — dense attention (the path below ``flash_min_seq``);
- ``serving``  — block allocator, scheduler, per-iteration loop,
                 continuous-batching engine, trace generator and the
                 ``python -m mpi_tensorflow_torch.serving`` entry point;
- ``train``    — adamw with the warmup schedule, the train/eval steps
                 and the MLM host loop ``train_mlm``;
- ``utils``    — device resolution, step timing and profile summaries,
                 the console trace, model-FLOP accounting, and the
                 metrics blocks the engine returns.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises instead of falling back.
"""

__version__ = "0.1.0"
