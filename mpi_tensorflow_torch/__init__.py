"""mpi_tensorflow_torch — the PyTorch + CUDA port of mpi_tensorflow_tpu.

The JAX package beside this one is the reference; this package does the
same jobs in PyTorch on an NVIDIA H100, with a hand-written Hopper
kernel wherever the JAX package had a Pallas kernel.  It imports
``torch`` and numpy only — never ``jax``, and nothing of
``mpi_tensorflow_tpu`` (whose package ``__init__`` imports JAX).

Layout mirrors the reference so each counterpart is easy to find:

- ``config``   — the run-config fields the ported paths read;
- ``cli``      — ``python -m mpi_tensorflow_torch``, the trainer;
- ``data``     — MNIST, CIFAR-10 (its local archive extracted) and the
                 ImageNet-shaped set (each with its synthetic stand-in;
                 a JPEG tree ingested once, ``imagenet_jpeg``), the
                 synthetic MLM stream and reversal pairs, real-text
                 corpora (``corpus``), and the windows of the image loop
                 assembled inline or on a thread (``prefetch``);
- ``models``   — the MNIST CNN (``cnn``), ResNet-20/50 (``resnet``),
                 the transformer layer math, remat and ``BertMlm``
                 (``bert``), the MoE BERT (``moe``), the
                 encoder-decoder LM (``encdec``), the causal LM with its
                 paged forward (``gpt``), and the parameter-tree
                 converter (``convert``);
- ``ops``      — the CUDA paged-attention, flash-attention and fused
                 kernels with their plain PyTorch twins, paged KV-cache
                 ops, the MLM head's masked-position packing, and the
                 ResNet's SAME conv, pooling and BatchNorm (``nn``);
- ``parallel`` — dense attention (the path below ``flash_min_seq``);
- ``serving``  — block allocator, scheduler, per-iteration loop,
                 continuous-batching engine, trace generator and the
                 ``python -m mpi_tensorflow_torch.serving`` entry point;
- ``train``    — TF momentum, adamw and LAMB, the image family's train/eval
                 steps and loop (``step``, ``loop``), the transformer's
                 (``gspmd``) and the MLM host loop ``train_mlm``;
                 checkpoints in the reference's formats (``checkpoint``,
                 ``state_io``), resume and preemption (``ckpt_hooks``,
                 ``preemption``);
- ``utils``    — device resolution, step timing and profile summaries,
                 the console trace, model-FLOP accounting, the trainers'
                 metrics sink and the metrics blocks the engine returns.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises instead of falling back.
"""

__version__ = "0.1.0"
