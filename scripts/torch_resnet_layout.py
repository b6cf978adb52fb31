#!/usr/bin/env python3
"""Channels-last against NCHW memory for the ResNets' step, on one card.

    python3 scripts/torch_resnet_layout.py

The port keeps the ResNets' activations and conv weights channels-last
(``models/resnet.py``: the NHWC input permuted to NCHW already is).  This
times the psum train step (``train/step.py``, float32 parameters, the
momentum update, the BatchNorm state carried) of ResNet-50 at batch 64
(224x224, 1000 classes) and ResNet-20 at batch 128 (32x32, 10 classes),
fp32 (TF32 off) and bf16, with that layout and with NCHW-contiguous
weights and activations, in turns (channels-last, NCHW, NCHW,
channels-last) in one process: 5 untimed steps, then the mean of 20
(host clock around a synchronised run).  Prints one JSON line per model
and precision, and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpi_tensorflow_torch.config import Config  # noqa: E402
from mpi_tensorflow_torch.train import loop, step as step_lib  # noqa: E402
from mpi_tensorflow_torch.utils.device import resolve_device  # noqa: E402

CASES = (("resnet50", 64, 224, 1000), ("resnet20", 128, 32, 10))
WARMUP, TIMED = 5, 20


def step_ms(dev, name, batch, side, classes, precision, layout) -> tuple:
    """``(mean step ms, last loss)`` of ``name``'s step in ``layout``."""
    cfg = Config(model=name, batch_size=batch, precision=precision,
                 num_classes=classes)
    model = loop.build_model(cfg).to(dev)
    if layout == "nchw":
        for p in model.parameters():
            if p.ndim == 4:
                p.data = p.data.contiguous()
    state = step_lib.init_state(model)
    train = step_lib.make_train_step(model, cfg, 1, 50000)
    rng = np.random.default_rng(0)
    xs, ys = [], []
    for _ in range(4):
        x = torch.from_numpy((rng.normal(size=(batch, side, side, 3)) * 0.3)
                             .astype(np.float32)).to(dev)
        if layout == "nchw":   # the model's permute then yields NCHW
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        xs.append(x)
        ys.append(torch.from_numpy(rng.integers(0, classes, size=batch))
                  .to(dev))
    for i in range(WARMUP):
        train(state, xs[i % 4], ys[i % 4])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(TIMED):
        _, m = train(state, xs[i % 4], ys[i % 4])
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / TIMED * 1e3, float(m["loss"])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_resnet_layout: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    for name, batch, side, classes in CASES:
        for precision in ("fp32", "bf16"):
            runs = [step_ms(dev, name, batch, side, classes, precision, lay)
                    for lay in ("channels_last", "nchw", "nchw",
                                "channels_last")]
            print(json.dumps({
                "model": name, "precision": precision, "batch": batch,
                "channels_last_ms": [runs[0][0], runs[3][0]],
                "nchw_ms": [runs[1][0], runs[2][0]],
                "losses": [r[1] for r in runs], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
