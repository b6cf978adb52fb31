"""Command-line entry point of the trainer: ``python -m mpi_tensorflow_torch``.

Counterpart of ``mpi_tensorflow_tpu/cli.py`` with the flags the ported
training path reads, the reference's defaults, plus ``--device``.  The
zero-flag default model is the reference's ``mnist_cnn``, whose path is
not ported yet and raises; the transformer path runs with
``--model bert_base --dataset mlm_synthetic``:

    python -m mpi_tensorflow_torch --model bert_base \\
        --dataset mlm_synthetic --precision bf16 --seq-len 4096 \\
        --batch-size 4                                 # on the card
    python -m mpi_tensorflow_torch --model bert_base \\
        --dataset mlm_synthetic --device cpu --tiny --epochs 1 \\
        --batch-size 4 --seq-len 32 --train-n 64 --test-n 16 --log-every 4

``--tiny``, ``--seq-len``, ``--train-n`` and ``--test-n`` have no
counterpart in the reference's CLI: they size a run (BERT_TINY geometry,
``train_mlm``'s sequence length and split sizes).  A ``--seq-len`` past
the geometry's 512 positions raises ``max_positions`` to it; at
``flash_min_seq`` (4096) and above, the card runs the flash kernels.
"""

from __future__ import annotations

import argparse
import dataclasses

from mpi_tensorflow_torch.config import Config

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
    p.add_argument("--log-every", type=int, default=d.log_every)
    p.add_argument("--seed", type=int, default=d.seed)
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
                   help="transformer-family optimizer (lamb: not ported "
                        "yet)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card fails")
    p.add_argument("--tiny", action="store_true",
                   help="BERT_TINY geometry instead of BERT_BASE")
    p.add_argument("--seq-len", type=int, default=128,
                   help="tokens per sequence (train_mlm's seq_len)")
    p.add_argument("--train-n", type=int, default=4096,
                   help="synthetic train sequences")
    p.add_argument("--test-n", type=int, default=512,
                   help="synthetic held-out sequences")
    return p


def config_from_args(args) -> Config:
    return Config(epochs=args.epochs, batch_size=args.batch_size,
                  log_every=args.log_every, seed=args.seed,
                  model=args.model, dataset=args.dataset,
                  precision=args.precision, optimizer=args.optimizer)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    if config.model not in TRANSFORMER_MODELS:
        raise NotImplementedError(
            f"model {config.model!r} is not ported yet (ROADMAP Queue 1 "
            f"items 7-10 for mnist_cnn, item 14 for the other image "
            f"families); the port trains --model bert_base")
    from mpi_tensorflow_torch.models import bert
    from mpi_tensorflow_torch.train import mlm_loop

    base = bert.BERT_TINY if args.tiny else bert.BERT_BASE
    # a sequence longer than the geometry's positions gets its own, as
    # bench.py does for its long-sequence runs
    bert_cfg = dataclasses.replace(
        base, dtype=config.compute_dtype,
        max_positions=max(base.max_positions, args.seq_len))
    mlm_loop.train_mlm(config, bert_cfg, seq_len=args.seq_len,
                       train_n=args.train_n, test_n=args.test_n,
                       device=args.device)
    return 0
