#!/usr/bin/env python3
"""Where the port's training step time goes, on one NVIDIA card.

    python3 scripts/torch_train_profile.py

Builds ``BertMlm`` at the configuration ``chip_smoke.py`` trains
(``BERT_BASE`` widths, bfloat16, S = 4096, batch 4, dropout 0.1,
``attention="auto"``, which takes the flash kernels at this length) with
``transformer_tx`` (adamw, warmup-linear, clipping at 1.0), runs two
warmup steps, times three steps (host clock around synchronised steps),
then profiles one more step with ``torch.profiler`` (after one step it
records and discards) and prints one JSON line: step ms, tokens/s,
model-FLOP utilisation against the bf16 peak, peak device memory, device
time by kernel category with each category's share, the top kernels,
and the device's idle share of the profiled step.  The kernels' times
alone are ``chip_smoke.py``'s (phase 6).
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    dev = resolve_device("cuda")
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
        "steps_timed": STEPS, "step_ms": step_s * 1e3,
        "tokens_per_sec": BATCH * SEQ / step_s,
        "model_flops_per_step": model_flops,
        "mfu_bf16": flops.mfu(model_flops, step_s, "bf16"),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "last_loss": float(loss),
        **device_summary(kernels)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
