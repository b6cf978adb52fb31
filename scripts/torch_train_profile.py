#!/usr/bin/env python3
"""Where the port's training step time goes, on one NVIDIA card.

    python3 scripts/torch_train_profile.py                  # BERT_BASE
    python3 scripts/torch_train_profile.py --one-rank-world # its DP step
    python3 scripts/torch_train_profile.py --model mnist_cnn [--precision bf16]

``bert_base`` (the default): builds ``BertMlm`` at the configuration
``chip_smoke.py`` trains (``BERT_BASE`` widths, bfloat16, S = 4096,
batch 4, dropout 0.1, ``attention="auto"``, which takes the flash
kernels at this length) with ``transformer_tx`` (adamw, warmup-linear,
clipping at 1.0), runs two warmup steps, times three steps (host clock
around synchronised steps), then profiles one more step.  With
``--one-rank-world`` it first joins a world of one rank over NCCL, so
the step is the data-parallel one (the gradients packed into one flat
buffer and all-reduced).

``mnist_cnn``: the zero-flag CNN's train step (batch 64, dropout 0.5,
the momentum step of ``train/step.py``) over one window of the windowed
loop (51 steps, batches already on the card, as ``train/loop.py`` feeds
them): two warmup windows, three timed windows, then one profiled
window.

Each profile is taken by ``torch.profiler`` after one window it records
and discards; the script prints one JSON line: step ms, the rate
(tokens/s or images/s), model-FLOP utilisation against the precision's
peak, peak device memory, device time by kernel category with each
category's share, the top kernels, kernels per step, and the device's
idle share of the profiled window; for ``mnist_cnn`` also the host's
time per step by operator (``torch.profiler``'s CPU activity over one
more window) and the cost of one dropout generator.  The flash kernels' times alone are
``chip_smoke.py``'s (phase 6).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpi_tensorflow_torch.data import synthetic  # noqa: E402
from mpi_tensorflow_torch.models import bert  # noqa: E402
from mpi_tensorflow_torch.train import gspmd, optimizer  # noqa: E402
from mpi_tensorflow_torch.utils import flops  # noqa: E402
from mpi_tensorflow_torch.utils.device import resolve_device  # noqa: E402
from mpi_tensorflow_torch.utils.profiling import (  # noqa: E402
    device_summary, profiled_kernels)

SEQ, BATCH, STEPS = 4096, 4, 3
CNN_BATCH, CNN_WINDOW = 64, 51       # the zero-flag loop's window: 50 + 1


def profile_cnn(dev, card: str, precision: str) -> dict:
    """The zero-flag CNN's step, timed and profiled by window."""
    import numpy as np

    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.train import loop, step as step_lib

    config = Config(precision=precision)
    model = loop.build_model(config).to(dev)
    state = step_lib.init_state(model)
    train_step = step_lib.make_train_step(model, config, 1,
                                          decay_steps=50000)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(CNN_WINDOW, CNN_BATCH, 28, 28, 1))
                          * 0.3).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, size=(CNN_WINDOW, CNN_BATCH))
                         ).to(dev)
    count = [0]

    def window():
        for j in range(CNN_WINDOW):
            t = count[0]
            count[0] += 1
            loss = train_step(state, x[j], y[j], gspmd.step_generator(
                config.seed + 1, t, dev))[1]["loss"]
        return loss

    for _ in range(2):
        window()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loss = window()
    torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t0) / (STEPS * CNN_WINDOW)
    kernels = profiled_kernels(window, window)
    model_flops = flops.image_train_flops("mnist_cnn", CNN_BATCH)
    summary = device_summary(kernels)
    t0 = time.perf_counter()
    for t in range(1000):
        gspmd.step_generator(config.seed + 1, t, dev)
    generator_us = (time.perf_counter() - t0) * 1e3
    return {
        "card": card, "config": f"mnist_cnn {precision} B={CNN_BATCH} "
                                f"dropout 0.5, window {CNN_WINDOW}",
        "steps_timed": STEPS * CNN_WINDOW, "step_ms": step_s * 1e3,
        "images_per_sec": CNN_BATCH / step_s,
        "model_flops_per_step": model_flops,
        "mfu_pct": 100.0 * flops.mfu(model_flops, step_s, precision),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "last_loss": float(loss),
        "kernels_per_step": summary["kernel_events"] / CNN_WINDOW,
        "device_busy_ms_per_step": summary["device_busy_ms"] / CNN_WINDOW,
        "dropout_generator_us": generator_us,
        "host_ms_per_step_by_op": host_ops(window, CNN_WINDOW),
        **summary}


def host_ops(fn, steps: int, top: int = 15) -> list:
    """``[op, host ms per step (self), calls per step]`` for the ``top``
    operators by self CPU time over one call of ``fn`` (``steps`` steps),
    from ``torch.profiler``'s CPU activity (which adds its own cost to
    each op: the shares, not the sum, are what it tells)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [[e.key[:60], e.self_cpu_time_total / 1e3 / steps,
             e.count / steps] for e in rows[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["bert_base", "mnist_cnn"],
                    default="bert_base")
    ap.add_argument("--precision", choices=["fp32", "bf16"], default=None,
                    help="mnist_cnn only (default fp32); bert_base runs "
                         "bf16")
    ap.add_argument("--one-rank-world", action="store_true",
                    help="bert_base: join a world of one rank over NCCL "
                         "first, so the step takes the data-parallel path "
                         "(the flat all-reduce of train/gspmd.py)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    dev = resolve_device("cuda")
    if args.model == "mnist_cnn":
        print(json.dumps(profile_cnn(dev, card, args.precision or "fp32")),
              flush=True)
        return 0
    if args.one_rank_world:
        from mpi_tensorflow_torch.parallel import mesh

        mesh.initialize_distributed(
            dev, init_method=f"tcp://127.0.0.1:{mesh.free_port()}", rank=0,
            world_size=1)
    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                              max_positions=SEQ)
    model = bert.BertMlm.from_seed(cfg, 0).to(dev)
    total = 2 + STEPS + 2
    tx = optimizer.transformer_tx(1e-4, total)
    state = gspmd.init_state(model, tx)
    step = gspmd.make_train_step(tx)
    tokens, targets, mask = synthetic.mlm_batches(
        BATCH * total, seq_len=SEQ, vocab_size=cfg.vocab_size, seed=1)

    def run(t):
        sl = slice(t * BATCH, (t + 1) * BATCH)
        batch = {"tokens": torch.from_numpy(tokens[sl]).to(dev),
                 "mask": torch.from_numpy(mask[sl]).to(dev)}
        return step(state, batch, torch.from_numpy(targets[sl]).to(dev),
                    gspmd.step_generator(3, t, dev))[1]["loss"]

    for t in range(2):
        run(t)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for t in range(2, 2 + STEPS):
        loss = run(t)
    torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t0) / STEPS

    kernels = profiled_kernels(lambda: run(total - 2),
                               lambda: run(total - 1))
    model_flops = flops.transformer_train_flops(cfg, BATCH, SEQ)
    print(json.dumps({
        "card": card, "config": "BERT_BASE bf16 S=4096 B=4 dropout 0.1",
        "one_rank_world": args.one_rank_world,
        "steps_timed": STEPS, "step_ms": step_s * 1e3,
        "tokens_per_sec": BATCH * SEQ / step_s,
        "model_flops_per_step": model_flops,
        "mfu_bf16": flops.mfu(model_flops, step_s, "bf16"),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "last_loss": float(loss),
        **device_summary(kernels)}), flush=True)
    if args.one_rank_world:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
