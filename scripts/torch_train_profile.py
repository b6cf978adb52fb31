#!/usr/bin/env python3
"""Where the port's training step time goes, on one NVIDIA card.

    python3 scripts/torch_train_profile.py                  # BERT_BASE
    python3 scripts/torch_train_profile.py --one-rank-world # its DP step
    python3 scripts/torch_train_profile.py --model moe_bert
    python3 scripts/torch_train_profile.py --model encdec_t5 --remat full
    python3 scripts/torch_train_profile.py --remat dots    # or full
    python3 scripts/torch_train_profile.py --model mnist_cnn [--precision bf16]
    python3 scripts/torch_train_profile.py --model resnet50 [--precision bf16]
    python3 scripts/torch_train_profile.py --model resnet50 --loop

``bert_base`` (the default): builds ``BertMlm`` at the configuration
``chip_smoke.py`` trains (``BERT_BASE`` widths, bfloat16, S = 4096,
batch 4, dropout 0.1, ``attention="auto"``, which takes the flash
kernels at this length) with ``transformer_tx`` (adamw, warmup-linear,
clipping at 1.0), runs two warmup steps, times three steps (host clock
around synchronised steps), then profiles one more step.  With
``--one-rank-world`` it first joins a world of one rank over NCCL, so
the step is the data-parallel one (the gradients packed into one flat
buffer and all-reduced).  ``moe_bert`` and ``encdec_t5`` (the reversal
pairs, S = T = 4096) step the same way at the same widths, and
``--remat full|dots`` recomputes each layer in the backward.

``mnist_cnn``: the zero-flag CNN's train step (batch 64, dropout 0.5,
the momentum step of ``train/step.py``) over one window of the windowed
loop (51 steps, batches already on the card, as ``train/loop.py`` feeds
them): two warmup windows, three timed windows, then one profiled
window.

``resnet20`` / ``resnet50``: the ResNet's psum train step
(``train/step.py``, the momentum update, BatchNorm's state carried) at
the trainer's batch (128 x 32x32x3, 10 classes; 64 x 224x224x3, 1000
classes), batches already on the card in 4 rotating banks: warmup steps,
``RESNET_TIMED`` timed steps (host clock around synchronised steps),
then ``RESNET_PROFILED`` profiled steps; device time by kind (the
``conv``, ``batch_norm`` and ``optimizer`` update categories among the
others), kernels per step and the idle share.

With ``--loop`` a ResNet's steps run as ``train/loop.py`` runs them
between two trace points of ``chip_smoke.py``'s 13b runs (``--log-every
10`` under psum: ``--fused-steps`` 10, windows of K = 11 rows holding
10 steps): each window assembled on the host
(``data/prefetch.assemble_window`` over a ``LOOP_STEPS``-step float32
train split), uploaded from pageable memory in one copy, then stepped,
with no synchronisation inside or between windows.  It prints the
host's time per step in each part (assembly; upload, which waits for
the stream's queued work first; the steps' launches), the step ms, and
the device's busy ms and idle share over two profiled windows (the gap
between them included), beside the same steps on batches already on
the card, in the same process.

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
# the ResNets: (batch, image side, classes) of the trainer's runs
RESNET = {"resnet20": (128, 32, 10), "resnet50": (64, 224, 1000)}
RESNET_WARMUP, RESNET_TIMED, RESNET_PROFILED = 5, 20, 5
LOOP_STEPS = 24                      # --loop: the train split's batches
LOOP_W, LOOP_K = 10, 11              # steps a window, rows allocated


def profile_resnet(dev, card: str, name: str, precision: str) -> dict:
    """A ResNet's psum train step, timed and profiled."""
    import numpy as np

    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.train import loop, step as step_lib

    batch, side, classes = RESNET[name]
    config = Config(model=name, batch_size=batch, precision=precision,
                    num_classes=classes)
    torch.cuda.reset_peak_memory_stats(dev)
    model = loop.build_model(config).to(dev)
    state = step_lib.init_state(model)
    train_step = step_lib.make_train_step(model, config, 1,
                                          decay_steps=50000)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy((rng.normal(size=(batch, side, side, 3)) * 0.3)
                           .astype(np.float32)).to(dev) for _ in range(4)]
    ys = [torch.from_numpy(rng.integers(0, classes, size=batch)).to(dev)
          for _ in range(4)]
    count = [0]

    def steps(n):
        for _ in range(n):
            i = count[0] % 4
            count[0] += 1
            loss = train_step(state, xs[i], ys[i])[1]["loss"]
        return loss

    steps(RESNET_WARMUP)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    loss = steps(RESNET_TIMED)
    torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t0) / RESNET_TIMED
    kernels = profiled_kernels(lambda: steps(RESNET_PROFILED),
                               lambda: steps(RESNET_PROFILED))
    summary = device_summary(kernels)
    model_flops = flops.image_train_flops(name, batch)
    return {
        "card": card, "config": f"{name} {precision} B={batch} "
                                f"{side}x{side}x3, {classes} classes",
        "steps_timed": RESNET_TIMED, "step_ms": step_s * 1e3,
        "images_per_sec": batch / step_s,
        "model_flops_per_step": model_flops,
        "mfu_pct": 100.0 * flops.mfu(model_flops, step_s, precision),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "last_loss": float(loss),
        "kernels_per_step": summary["kernel_events"] / RESNET_PROFILED,
        "device_busy_ms_per_step": summary["device_busy_ms"]
        / RESNET_PROFILED,
        "device_ms_per_step_by_category": {
            k: v / RESNET_PROFILED
            for k, v in summary["device_ms_by_category"].items()},
        **summary}


def profile_resnet_loop(dev, card: str, name: str, precision: str) -> dict:
    """A ResNet's step as the trainer feeds it (``--loop``), beside the
    step on batches already on the card."""
    import numpy as np

    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.data import prefetch
    from mpi_tensorflow_torch.train import loop, step as step_lib

    batch, side, classes = RESNET[name]
    config = Config(model=name, batch_size=batch, precision=precision,
                    num_classes=classes)
    model = loop.build_model(config).to(dev)
    state = step_lib.init_state(model)
    local_n = batch * LOOP_STEPS + 1
    train_step = step_lib.make_train_step(model, config, 1,
                                          decay_steps=local_n)
    rng = np.random.default_rng(0)
    tr_d = rng.standard_normal((1, local_n, side, side, 3),
                               dtype=np.float32)
    tr_l = rng.integers(0, classes, size=(1, local_n))
    parts = dict.fromkeys(("assemble", "upload", "step"), 0.0)
    count = [0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def fed(n):
        for _ in range(n // LOOP_W):
            t = count[0]
            count[0] += LOOP_W
            t0 = time.perf_counter()
            bs, ls = prefetch.assemble_window(tr_d, tr_l, t, LOOP_W, LOOP_K,
                                              batch)
            t1 = time.perf_counter()
            x, y = put(bs[:LOOP_W]), put(ls[:LOOP_W])
            t2 = time.perf_counter()
            for j in range(LOOP_W):
                loss = train_step(state, x[j], y[j])[1]["loss"]
            t3 = time.perf_counter()
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k] += dt
        return loss

    on_card = [(put(tr_d[0, i * batch:(i + 1) * batch]),
                put(tr_l[0, i * batch:(i + 1) * batch])) for i in range(4)]

    def resident(n):
        for _ in range(n):
            x, y = on_card[count[0] % 4]
            count[0] += 1
            loss = train_step(state, x, y)[1]["loss"]
        return loss

    out = {"card": card, "config": f"{name} {precision} B={batch} "
                                   f"{side}x{side}x3, {classes} classes"}
    timed, profiled = 2 * LOOP_W, 2 * LOOP_W
    arms = {"loop": fed, "on_card": resident}

    def time_steps(run):
        run(LOOP_W)
        torch.cuda.synchronize(dev)
        for k in parts:
            parts[k] = 0.0
        t0 = time.perf_counter()
        loss = run(timed)
        torch.cuda.synchronize(dev)
        step_s = (time.perf_counter() - t0) / timed
        return step_s, {k: v * 1e3 / timed for k, v in parts.items()}, loss

    # both arms timed before any profile, then profiled, then timed again
    # (a profile may leave the process's launches slower)
    for arm, run in arms.items():
        step_s, host_ms, loss = time_steps(run)
        out[arm] = {"steps_timed": timed, "step_ms": step_s * 1e3,
                    "images_per_sec": batch / step_s,
                    "last_loss": float(loss)}
        if arm == "loop":
            out[arm]["host_ms_per_step"] = host_ms
            out[arm]["upload_mb_per_window"] = LOOP_W * (
                batch * side * side * 3 * 4 + batch * 4) / 1e6
    for arm, run in arms.items():
        summary = device_summary(profiled_kernels(
            lambda: run(profiled), lambda: run(profiled)))
        out[arm].update({
            "device_busy_ms_per_step": summary["device_busy_ms"] / profiled,
            "window_ms_per_step": summary["window_ms"] / profiled,
            "device_idle_share": summary["device_idle_share"],
            "kernels_per_step": summary["kernel_events"] / profiled})
    for arm, run in arms.items():
        step_s, host_ms, _ = time_steps(run)
        out[arm]["step_ms_after_profile"] = step_s * 1e3
        if arm == "loop":
            out[arm]["host_ms_per_step_after_profile"] = host_ms
    return out


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
    ap.add_argument("--model", choices=["bert_base", "moe_bert",
                                        "encdec_t5", "mnist_cnn", *RESNET],
                    default="bert_base")
    ap.add_argument("--remat", choices=["full", "dots"], default=None,
                    help="the transformers: recompute each layer in the "
                         "backward under this policy")
    ap.add_argument("--precision", choices=["fp32", "bf16"], default=None,
                    help="the image models (default fp32); bert_base runs "
                         "bf16")
    ap.add_argument("--loop", action="store_true",
                    help="resnet20/resnet50: the step as the trainer feeds "
                         "it (batches assembled and uploaded each step), "
                         "beside the step on batches already on the card")
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
    if args.model in RESNET:
        run = profile_resnet_loop if args.loop else profile_resnet
        print(json.dumps(run(dev, card, args.model,
                             args.precision or "fp32")), flush=True)
        return 0
    if args.one_rank_world:
        from mpi_tensorflow_torch.parallel import mesh

        mesh.initialize_distributed(
            dev, init_method=f"tcp://127.0.0.1:{mesh.free_port()}", rank=0,
            world_size=1)
    from mpi_tensorflow_torch.train import mlm_loop

    cfg = dataclasses.replace(bert.BERT_BASE, dtype=torch.bfloat16,
                              max_positions=SEQ,
                              remat=args.remat is not None,
                              remat_policy=args.remat or "full")
    model = mlm_loop.FAMILIES[args.model].from_seed(cfg, 0).to(dev)
    enc_dec = args.model == "encdec_t5"
    total = 2 + STEPS + 2
    tx = optimizer.transformer_tx(1e-4, total)
    state = gspmd.init_state(model, tx)
    step = gspmd.make_train_step(tx)
    if enc_dec:
        tokens, targets = synthetic.seq2seq_batches(
            BATCH * total, src_len=SEQ, tgt_len=SEQ,
            vocab_size=cfg.vocab_size, seed=1)
    else:
        tokens, targets, mask = synthetic.mlm_batches(
            BATCH * total, seq_len=SEQ, vocab_size=cfg.vocab_size, seed=1)

    def run(t):
        sl = slice(t * BATCH, (t + 1) * BATCH)
        put = lambda a: torch.from_numpy(a[sl]).to(dev)
        batch = ({"src": put(tokens), "tgt": put(targets)} if enc_dec
                 else {"tokens": put(tokens), "mask": put(mask)})
        return step(state, batch, put(targets),
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
    model_flops = (flops.encdec_train_flops(cfg, model.n_dec, BATCH, SEQ, SEQ)
                   if enc_dec else flops.transformer_train_flops(cfg, BATCH,
                                                                 SEQ))
    print(json.dumps({
        "card": card, "model": args.model, "remat": args.remat,
        "config": "BERT_BASE bf16 S=4096 B=4 dropout 0.1",
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
