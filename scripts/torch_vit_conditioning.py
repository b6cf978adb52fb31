#!/usr/bin/env python3
"""How far a float32 ViT step lies from a float64 one, on the CPU.

    python3 scripts/torch_vit_conditioning.py [--steps 2]

``VIT_TINY_CIFAR`` (12 layers, width 192) at batch 128 of 32x32x3
rows of the synthetic CIFAR-10, from the seed-0 weights, dropout off:
``--steps`` momentum steps of the image step (``train/step.py``), each
taken from the float64 trajectory's state (rounded to float32) in
float32 at the process's threads and in float64 (the yardstick: the
products and the attention's scores in float64; the head's LayerNorm
stays float32, as the model casts it).  Prints per step the loss's
distance and the whole update's (the velocity the step leaves, |Δ| / |v| over
every parameter at once).  Then, from the state after the last step,
the bf16 evaluation logits' distance from the float32 ones on the first
batch: |bf16 - float32| / |float32| over the whole (batch, classes)
block (the measure held), and the largest difference over max|logit|
(printed: at this state the logits are small, max ~0.46, and one
row's error sets it).  Then the same two readings of two controls, bf16
paths that drop precision: the head's LayerNorm in bf16 (the model
keeps it float32), and every parameter rounded through float8 e4m3
first.  ``chip_smoke.py`` phase 20a holds the card's float32 step to
the CPU's, and the card's bf16 logits to its float32 ones, within a few
times these distances, and the controls outside.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpi_tensorflow_torch.config import Config  # noqa: E402
from mpi_tensorflow_torch.data import synthetic  # noqa: E402
from mpi_tensorflow_torch.models import bert, vit  # noqa: E402
from mpi_tensorflow_torch.train import optimizer, step  # noqa: E402
from mpi_tensorflow_torch.utils import tree as tree_lib  # noqa: E402

BATCH = 128


def attention64(q, k, v, *, causal=False, scale=None):
    """``dense_attention`` with its scores in the inputs' dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def one_step(params, velocity, count, x, y, dtype):
    """One step from ``params`` (a float32 tree), ``velocity`` (float64
    leaves) and ``count`` in ``dtype``: ``(loss, params, velocity)``
    after it, leaves in the tree's order, in float64."""
    cfg = dataclasses.replace(vit.VIT_TINY_CIFAR, dropout=0.0, dtype=dtype)
    model = vit.VisionTransformer(cfg, params).to(dtype)
    state = step.init_state(model)
    state.opt = optimizer.MomentumState(
        [v.to(dtype, copy=True) for v in velocity], count)
    train = step.make_train_step(model, Config(batch_size=BATCH), 1,
                                 decay_steps=50000)
    state, m = train(state, x, y)
    return (float(m["loss"]),
            [p.detach().double() for p in tree_lib.leaves(
                model.param_tree())],
            [v.double() for v in state.opt.velocity])


def rel(a, b) -> float:
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    return float((flat(a) - flat(b)).norm() / flat(b).norm())


class Bf16HeadNorm(torch.nn.Module):
    """A control: the head's LayerNorm in bf16 (its input, statistics and
    affine), the result cast back to float32."""

    def __init__(self, norm):
        super().__init__()
        self.norm = norm

    def forward(self, x):
        n = self.norm
        x = x.to(torch.bfloat16)
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + n.eps)
        return (y * n.scale.to(torch.bfloat16)
                + n.bias.to(torch.bfloat16)).to(torch.float32)


def bf16_logits(params, x) -> dict:
    """The bf16 evaluation logits of ``params`` (a float32 tree) on ``x``
    against the float32 ones, and the two controls': for each, the
    norm-relative distance (``*_rel``) and max|diff| / max|logit|
    (``*_maxrel``); ``max_abs_logit``.  ``x`` may lie on the card."""
    def run(dt, tree=params, head_bf16=False):
        cfg = dataclasses.replace(vit.VIT_TINY_CIFAR, dropout=0.0, dtype=dt)
        model = vit.VisionTransformer(cfg, tree).to(x.device)
        if head_bf16:
            model.head_ln = Bf16HeadNorm(model.head_ln)
        with torch.no_grad():
            return model(x).double()

    fp8 = tree_lib.map_leaves(
        lambda _, p: p.to(torch.float8_e4m3fn).to(torch.float32), params)
    want = run(torch.float32)
    out = {"max_abs_logit": float(want.abs().max())}
    for name, got in (("bf16", run(torch.bfloat16)),
                      ("control_head_ln_bf16",
                       run(torch.bfloat16, head_bf16=True)),
                      ("control_fp8_weights", run(torch.bfloat16, fp8))):
        out[f"{name}_rel"] = float((got - want).norm() / want.norm())
        out[f"{name}_maxrel"] = float((got - want).abs().max()
                                      / want.abs().max())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    data = synthetic.image_classification(
        BATCH * args.steps * 12 // 11 + 12, 1, size=32, channels=3,
        num_classes=10, seed=7)
    tree = vit.VisionTransformer.from_seed(vit.VIT_TINY_CIFAR,
                                           0).param_tree()
    params = tree_lib.map_leaves(lambda _, p: p.detach().clone(), tree)
    velocity = [torch.zeros(p.shape, dtype=torch.float64)
                for p in tree_lib.leaves(params)]
    real = bert.dense_attention
    out = []
    try:
        for t in range(args.steps):
            rows = slice(t * BATCH, (t + 1) * BATCH)
            x = torch.from_numpy(data.train_data[rows])
            y = torch.from_numpy(data.train_labels[rows])
            count = torch.tensor(float(t))
            bert.dense_attention = attention64
            l64, p64, v64 = one_step(params, velocity, count, x, y,
                                     torch.float64)
            bert.dense_attention = real
            l32, _, v32 = one_step(params, velocity, count, x, y,
                                   torch.float32)
            out.append({
                "step": t, "loss_fp64": l64, "loss_fp32": l32,
                "loss_diff": abs(l32 - l64),
                "update_rel": rel(v32, v64)})
            print(json.dumps(out[-1]), flush=True)
            # on along the float64 trajectory, rounded to float32
            params = tree_lib.unflatten(params, [p.float() for p in p64])
            velocity = v64
    finally:
        bert.dense_attention = real
    x = torch.from_numpy(data.train_data[:BATCH])
    logits = bf16_logits(params, x)
    print(json.dumps({
        "threads": torch.get_num_threads(),
        "max_loss_diff": max(o["loss_diff"] for o in out),
        "max_update_rel": max(o["update_rel"] for o in out),
        **logits}))

if __name__ == "__main__":
    main()
