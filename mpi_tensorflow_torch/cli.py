"""Command-line entry point of the trainer: ``python -m mpi_tensorflow_torch``.

Counterpart of ``mpi_tensorflow_tpu/cli.py`` with the flags the ported
training paths read, the reference's defaults, plus ``--device``.  With
no flags it trains the reference CNN (``mnist_cnn``) for 2 epochs at
batch 64 on MNIST from ``--data-dir`` (the synthetic set when the
directory holds no MNIST files), sync ``psum``, on the card, through
``train.loop.train``; ``--model resnet20 --dataset cifar10`` and
``--model resnet50 --dataset imagenet_synthetic --num-classes 1000``
train the ResNets through the same loop (CIFAR-10's binary files when
``--data-dir`` holds ``cifar-10-batches-bin``, else the synthetic set of
its shapes; ``imagenet_npy`` shards when present, else the synthetic
224x224 set), and ``--model vit`` the ViT (on ``mnist``, ``cifar10`` or
``imagenet_synthetic``: 7, 4 or 16 px patches); the transformer path
runs with ``--model bert_base --dataset mlm_synthetic`` (or ``--model
gpt_base``: the causal LM's
next-token training on the same stream; ``--model moe_bert``: routed
expert MLPs on every other layer; ``--model encdec_t5``: the
encoder-decoder on the synthetic reversal task).  ``--remat``
recomputes each layer in the backward, ``--optimizer lamb`` swaps adamw
for LAMB, and ``--text-file`` (with ``--vocab-file``, a WordPiece
vocabulary) trains bert_base, moe_bert or gpt_base on a local text:

    python -m mpi_tensorflow_torch                     # on the card
    python -m mpi_tensorflow_torch --device cpu --epochs 1 \\
        --data-dir /tmp/mnist
    python -m mpi_tensorflow_torch --model resnet20 --dataset cifar10 \\
        --batch-size 128 [--precision bf16]            # on the card
    python -m mpi_tensorflow_torch --model resnet50 \\
        --dataset imagenet_synthetic --num-classes 1000 --precision bf16
    python -m mpi_tensorflow_torch --model resnet20 --dataset cifar10 \\
        --device cpu --epochs 1 --data-dir /tmp/c10
    python -m mpi_tensorflow_torch --model vit --dataset cifar10 \\
        --batch-size 128 [--precision bf16] [--remat]  # on the card
    python -m mpi_tensorflow_torch --model vit --dataset cifar10 \\
        --device cpu --epochs 1 --data-dir /tmp/c10
    python -m mpi_tensorflow_torch --model bert_base \\
        --dataset mlm_synthetic --precision bf16 --seq-len 4096 \\
        --batch-size 4                                 # on the card
    python -m mpi_tensorflow_torch --model bert_base \\
        --dataset mlm_synthetic --device cpu --tiny --epochs 1 \\
        --batch-size 4 --seq-len 32 --train-n 64 --test-n 16 --log-every 4
    python -m mpi_tensorflow_torch --model gpt_base \
        --dataset mlm_synthetic --precision bf16 --seq-len 4096 \
        --batch-size 4                                 # on the card
    python -m mpi_tensorflow_torch --model moe_bert --precision bf16 \
        --seq-len 4096 --batch-size 4                  # on the card
    python -m mpi_tensorflow_torch --model encdec_t5 --precision bf16 \
        --seq-len 4096 --batch-size 4 --remat          # on the card
    python -m mpi_tensorflow_torch --model encdec_t5 --device cpu \
        --tiny --epochs 1 --batch-size 4 --seq-len 32 --train-n 64 \
        --test-n 16 --log-every 4 [--remat] [--optimizer lamb]
    python -m mpi_tensorflow_torch --model bert_base --device cpu --tiny \
        --epochs 1 --batch-size 4 --seq-len 32 --log-every 4 \
        --text-file corpus.txt [--vocab-file vocab.txt]

Under ``torchrun`` the trainer runs one rank per card over
``torch.distributed`` (NCCL for the card's tensors, gloo for the host's;
gloo alone with ``--device cpu``), ``--device cuda`` meaning the rank's
own card ``cuda:LOCAL_RANK``; without a launcher there is no process
group:

    torchrun --nproc_per_node N -m mpi_tensorflow_torch [--sync avg50]
    torchrun --nproc_per_node 2 -m mpi_tensorflow_torch --device cpu \\
        --epochs 1 --sync avg50
    torchrun --nproc_per_node N -m mpi_tensorflow_torch --model bert_base \\
        --seq-len 4096 --batch-size 4 --precision bf16 [--grad-accum A] \\
        [--param-sharding replicated|zero1|fsdp]
    torchrun --nproc_per_node 2 -m mpi_tensorflow_torch --model bert_base \\
        --device cpu --tiny --epochs 1 --batch-size 2 --seq-len 32 \\
        --train-n 64 --test-n 16 --log-every 4 --param-sharding fsdp

A long run checkpoints at every trace point, survives a SIGTERM (it
checkpoints the step it is in and exits 0) and resumes; ``--metrics-dir``
streams its scalars to ``metrics.jsonl``.  A class-per-directory JPEG
tree in ``--data-dir`` is decoded once into ``imagenet_npy`` (rank 0
writes, the other ranks wait):

    python -m mpi_tensorflow_torch --model resnet50 \\
        --dataset imagenet_synthetic --num-classes 1000 \\
        --data-dir /data/imagenet --checkpoint-dir ckpt --metrics-dir m
    python -m mpi_tensorflow_torch ... --checkpoint-dir ckpt --resume

``--batch-size`` is per rank (the global batch is it times the ranks);
``--grad-accum`` splits each step's global batch into that many
microbatches, and ``--param-sharding`` zero1/fsdp shards the
transformer's state over the ranks (``train.gspmd``; a world of one
rank raises, as the reference does without a data axis).

``--remat`` also recomputes each residual block of the ResNets.
``--image-size`` defaults to the dataset's own (28 for MNIST, 32 for
CIFAR-10, 224 for ``imagenet_synthetic``): the reference's default is 28
whatever the dataset, so its ViT on CIFAR-10 fails at the patch reshape
without ``--image-size 32``; the CNN and the ResNets do not read it.
``--fused-steps`` defaults to ``--log-every`` under psum and to 1 under
avg50, as in the reference: a window of ``fused_steps + 1`` steps is one
dispatch, on the card one CUDA graph replay (``train/graphs.py``), on
the CPU its steps one after another; ``--fused-steps 1`` steps one step
at a time everywhere.  ``--tiny``, ``--seq-len``, ``--train-n``
and ``--test-n`` have no counterpart in the reference's CLI: they size
a transformer run (BERT_TINY geometry, ``train_mlm``'s sequence length
and split sizes).  ``--mesh data=D,model=M,seq=N`` under
``torchrun --nproc_per_node D*M*N`` trains bert_base or gpt_base with
tensor and sequence parallelism (``models/bert.py``; ring attention over
``seq``, as ``BertConfig.sp_impl`` defaults).
A ``--seq-len`` past the geometry's 512 positions raises
``max_positions`` to it; at ``flash_min_seq`` (4096) and above, the card
runs the flash kernels.  Values whose path is not ported yet raise
through ``Config``, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses

from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.parallel import mesh as meshlib

TRANSFORMER_MODELS = ("bert_base", "moe_bert", "gpt_base", "encdec_t5")


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(
        prog="mpi_tensorflow_torch",
        description="Data-parallel trainer, PyTorch + CUDA port")
    p.add_argument("--epochs", type=int, default=d.epochs,
                   help="the reference's `iteration` (mpipy.py:18)")
    p.add_argument("--batch-size", type=int, default=d.batch_size,
                   help="per-device batch size (mpipy.py:20)")
    p.add_argument("--image-size", type=int, default=None,
                   help="input size (default: the dataset's, 28 for "
                        "mnist, 32 for cifar10, 224 for "
                        "imagenet_synthetic)")
    p.add_argument("--num-classes", type=int, default=d.num_classes,
                   help="the reference's `num_channel` (mpipy.py:21)")
    p.add_argument("--base-lr", type=float, default=d.base_lr)
    p.add_argument("--lr-decay", type=float, default=d.lr_decay)
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--weight-decay", type=float, default=d.weight_decay)
    p.add_argument("--log-every", type=int, default=d.log_every)
    p.add_argument("--early-stop-patience", type=int,
                   default=d.early_stop_patience,
                   help="stop when the validation error has not improved "
                        "for N trace points (0 = off)")
    p.add_argument("--sync", choices=["psum", "avg50"], default=d.sync,
                   help="psum: per-step gradient mean; avg50: per-rank "
                        "SGD, parameters averaged every --log-every steps")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--data-dir", default=d.data_dir,
                   help="MNIST's four IDX files (written synthetic when "
                        "absent), cifar-10-batches-bin or imagenet_npy "
                        "(synthetic when absent)")
    p.add_argument("--mesh", default=None,
                   help="mesh spec, e.g. 'data=4' or 'data=2,model=2,"
                        "seq=2': the product must equal the number of "
                        "ranks; model (tensor parallel) and seq (sequence "
                        "parallel) for bert_base and gpt_base")
    p.add_argument("--fused-steps", type=int, default=None,
                   help="train steps per window (one upload each; one "
                        "CUDA graph replay on the card). Default: "
                        "--log-every for psum, 1 for avg50. Pass 1 for "
                        "the one-dispatch-per-step shape")
    p.add_argument("--param-sharding",
                   choices=["replicated", "fsdp", "zero1"],
                   default=d.param_sharding,
                   help="transformer-family state layout: replicated "
                        "(default), fsdp (params+moments sharded over "
                        "'data', ZeRO-3-style), or zero1 (optimizer "
                        "moments sharded, params keep their layout)")
    p.add_argument("--grad-accum", type=int, default=d.grad_accum,
                   help="microbatches accumulated per optimizer step "
                        "(activation-memory / batch-size trade)")
    p.add_argument("--prefetch", choices=["auto", "native", "thread", "off"],
                   default=d.prefetch,
                   help="image loop's window assembly: thread and auto "
                        "assemble ahead on a background thread, off "
                        "inline (native, the C++ worker: not ported yet)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write a sharded checkpoint at every trace point; "
                        "on SIGTERM checkpoint and exit cleanly")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest committed checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--metrics-dir", default=None,
                   help="write scalar metrics to <dir>/metrics.jsonl "
                        "(rank 0)")
    p.add_argument("--model", default=d.model,
                   choices=["mnist_cnn", "resnet20", "resnet50", "vit",
                            *TRANSFORMER_MODELS])
    p.add_argument("--dataset", default=d.dataset,
                   choices=["mnist", "cifar10", "imagenet_synthetic",
                            "mlm_synthetic"])
    p.add_argument("--precision", choices=["fp32", "bf16"],
                   default=d.precision,
                   help="compute dtype of the matmuls (parameters, "
                        "optimizer state and loss stay float32)")
    p.add_argument("--optimizer", choices=["adamw", "lamb"],
                   default=d.optimizer,
                   help="transformer-family optimizer (lamb = layer-wise "
                        "trust ratios)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer layer (ResNet block) "
                        "in the backward: compute for peak memory")
    p.add_argument("--text-file", default=None,
                   help="train bert_base, moe_bert or gpt_base on a local "
                        "text file instead of the synthetic stream")
    p.add_argument("--vocab-file", default=None,
                   help="WordPiece vocabulary for --text-file (one token "
                        "per line); default: byte-level (vocab 261)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the rank's own card under "
                        "torchrun) or cpu; cuda without a card fails")
    p.add_argument("--tiny", action="store_true",
                   help="BERT_TINY geometry instead of BERT_BASE")
    p.add_argument("--seq-len", type=int, default=128,
                   help="tokens per sequence (train_mlm's seq_len)")
    p.add_argument("--train-n", type=int, default=4096,
                   help="synthetic train sequences")
    p.add_argument("--test-n", type=int, default=512,
                   help="synthetic held-out sequences")
    return p


def parse_mesh(spec: str | None):
    """``"data=4,model=2"`` -> ``{"data": 4, "model": 2}``."""
    if spec is None:
        return None
    out = {}
    for part in spec.split(","):
        k, v = part.split("=")
        out[k.strip()] = int(v)
    return out


#: each image dataset's own input size, ``--image-size``'s default
DATASET_IMAGE_SIZE = {"cifar10": 32, "imagenet_synthetic": 224}


def config_from_args(args) -> Config:
    image_size = (args.image_size if args.image_size is not None
                  else DATASET_IMAGE_SIZE.get(args.dataset,
                                              Config.image_size))
    return Config(
        epochs=args.epochs, image_size=image_size,
        batch_size=args.batch_size, num_classes=args.num_classes,
        base_lr=args.base_lr, lr_decay=args.lr_decay,
        momentum=args.momentum, weight_decay=args.weight_decay,
        log_every=args.log_every,
        early_stop_patience=args.early_stop_patience, sync=args.sync,
        seed=args.seed, data_dir=args.data_dir, model=args.model,
        dataset=args.dataset, mesh_shape=parse_mesh(args.mesh),
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        metrics_dir=args.metrics_dir, precision=args.precision,
        optimizer=args.optimizer, prefetch=args.prefetch,
        remat=args.remat, text_file=args.text_file,
        vocab_file=args.vocab_file,
        grad_accum=args.grad_accum, param_sharding=args.param_sharding,
        fused_steps=(args.fused_steps if args.fused_steps is not None
                     else (args.log_every if args.sync == "psum" else 1)))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    # the reference's flag checks, before any device is touched
    if config.text_file and config.model not in ("bert_base", "moe_bert",
                                                 "gpt_base"):
        raise SystemExit(
            f"--text-file applies to the language-model families "
            f"(bert_base, moe_bert, gpt_base); --model {config.model} "
            f"would silently ignore it")
    if config.vocab_file and not config.text_file:
        raise SystemExit("--vocab-file only applies with --text-file")
    if config.optimizer != "adamw" and config.model not in TRANSFORMER_MODELS:
        raise SystemExit(
            f"--optimizer {config.optimizer} applies to the transformer "
            f"families; the image families train with the reference's "
            f"momentum SGD (mpipy.py:65) and would silently ignore it")
    if config.param_sharding != "replicated" \
            and config.model not in TRANSFORMER_MODELS:
        raise SystemExit(
            f"--param-sharding {config.param_sharding} applies to the "
            f"transformer families (GSPMD step); the image loop keeps "
            f"the reference's replicated layout and would silently "
            f"ignore it")
    device = meshlib.rank_device(args.device)
    joined = meshlib.initialize_distributed(device)
    try:
        _run(config, args, device)
    finally:
        if joined:
            meshlib.shutdown()
    return 0


def _run(config: Config, args, device) -> None:
    if config.model not in TRANSFORMER_MODELS:
        from mpi_tensorflow_torch.train import loop

        loop.train(config, device=device)
        return
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import mlm_loop

    base = bert.BERT_TINY if args.tiny else bert.BERT_BASE
    # a sequence longer than the geometry's positions gets its own, as
    # bench.py does for its long-sequence runs
    bert_cfg = dataclasses.replace(
        base, dtype=config.compute_dtype, remat=config.remat,
        max_positions=max(base.max_positions, args.seq_len))
    mlm_loop.train_mlm(config, bert_cfg, seq_len=args.seq_len,
                       train_n=args.train_n, test_n=args.test_n,
                       device=device)
