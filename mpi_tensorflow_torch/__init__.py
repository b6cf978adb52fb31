"""mpi_tensorflow_torch — the PyTorch + CUDA port of mpi_tensorflow_tpu.

The JAX package beside this one is the reference; this package does the
same jobs in PyTorch on an NVIDIA H100, with a hand-written Hopper
kernel wherever the JAX package had a Pallas kernel.  It imports
``torch`` and numpy only — never ``jax``, and nothing of
``mpi_tensorflow_tpu`` (whose package ``__init__`` imports JAX).

Layout mirrors the reference so each counterpart is easy to find:

- ``config``  — the run-config fields the ported paths read;
- ``models``  — the transformer layer math (``bert``), the causal LM
                with its paged forward (``gpt``), and the JAX-pytree
                converter (``convert``);
- ``ops``     — paged KV-cache ops and the CUDA paged-attention kernel
                with its plain PyTorch twin;
- ``serving`` — block allocator, scheduler, per-iteration loop,
                continuous-batching engine, trace generator and the
                ``python -m mpi_tensorflow_torch.serving`` entry point;
- ``utils``   — device resolution and the metrics blocks the engine
                returns.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises instead of falling back.
"""

__version__ = "0.1.0"
