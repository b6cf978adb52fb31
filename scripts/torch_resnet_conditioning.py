#!/usr/bin/env python3
"""How far float32 ResNet gradients lie from float64 ones, on the CPU.

    python3 scripts/torch_resnet_conditioning.py

One training-mode gradient (loss with the L2 term) of ResNet-20 at
batch 128 (32x32) and of ResNet-50 at batch 4 (224x224), from the
seed-0 weights on the synthetic sets, in float64 (the yardstick), in
float32, and in float32 with every convolution's operands and output
gradients rounded to TF32's 10-bit mantissa (an emulation of the card's
TF32 path).  Prints, per model and arm: the relative norm of the whole
gradient's difference from float64, the worst parameter's, and the
worst BatchNorm statistic's.  BatchNorm's backward subtracts two means
from the upstream gradient and the convolutions' weight gradients sum
over N x H x W positions, so float32 alone leaves the gradient far from
float64 (ResNet-50 at batch 4 most), and the card's float32 gradient
cannot be held closer to the CPU's than that: ``chip_smoke.py`` phase
13a sizes its bounds from these numbers.

Then the same cases in bf16 (``bf16/...``): the logits, relative to
their max|logit|, and the whole gradient, of bf16 at the process's
threads against bf16 at one thread (the same arithmetic summed in
another order) and against float32, in training mode (BatchNorm on the
batch's statistics) and, for the logits, in evaluation (on the initial
running statistics).  In training, a channel whose spread lies below
the bf16 resolution of its mean is renormalised by the batch's
statistics, so the order of the sums alone moves bf16 about as far as
float32 lies from it: why 13a holds bf16 by evaluation-mode logits and
a descent, not by single steps.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpi_tensorflow_torch.data import synthetic  # noqa: E402
from mpi_tensorflow_torch.models import resnet  # noqa: E402
from mpi_tensorflow_torch.ops import nn as ops  # noqa: E402
from mpi_tensorflow_torch.utils import tree as tree_lib  # noqa: E402

# (name, classes, batch, side): chip_smoke.py 13a's cases
CASES = (("resnet20", 10, 128, 32), ("resnet50", 1000, 4, 224))
WEIGHT_DECAY = 5e-4


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 ``t`` to TF32 (10 mantissa bits, to nearest)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return tf32(t)

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


def gradient(name, classes, batch, side, dtype, emulate_tf32=False):
    """The gradient (float64 copies) and the new BatchNorm state."""
    data = synthetic.image_classification(
        batch * 12 // 11 + 12, 1, size=side, channels=3,
        num_classes=classes, seed=7)
    x = torch.from_numpy(data.train_data[:batch]).to(dtype)
    y = torch.from_numpy(data.train_labels[:batch])
    model = resnet.build(name, classes)
    if dtype == torch.float64:
        model = model.double()
        model.compute_dtype = dtype
    conv = ops.conv2d
    if emulate_tf32:
        ops.conv2d = lambda a, w, s=1: conv(_Tf32.apply(a), _Tf32.apply(w), s)
    try:
        logits, state = model.apply_with_state(model.init_state(), x,
                                               train=True)
    finally:
        ops.conv2d = conv
    loss = F.cross_entropy(logits.to(dtype), y) + WEIGHT_DECAY * sum(
        torch.sum(torch.square(p.to(dtype))) / 2 for p in model.l2_params())
    params = tree_lib.leaves(model.param_tree())
    grads = torch.autograd.grad(loss, params)
    return ([g.double() for g in grads],
            [t.double() for t in tree_lib.leaves(state)])


def bf16_spread(name, classes, batch, side) -> dict:
    """bf16 at the process's threads against bf16 at one thread and
    against float32 (see the module note)."""
    data = synthetic.image_classification(
        batch * 12 // 11 + 12, 1, size=side, channels=3,
        num_classes=classes, seed=7)
    x = torch.from_numpy(data.train_data[:batch])
    y = torch.from_numpy(data.train_labels[:batch])
    params = resnet.build(name, classes).param_tree()
    threads = torch.get_num_threads()

    def run(dtype, n_threads, train):
        torch.set_num_threads(n_threads)
        try:
            model = resnet.ResNet(resnet.geometry(name, classes), params,
                                  compute_dtype=dtype)
            logits, _ = model.apply_with_state(model.init_state(), x,
                                               train=train)
            loss = F.cross_entropy(logits, y) + WEIGHT_DECAY * sum(
                torch.sum(torch.square(p)) / 2 for p in model.l2_params())
            grads = torch.autograd.grad(
                loss, tree_lib.leaves(model.param_tree()))
        finally:
            torch.set_num_threads(threads)
        return logits.detach().double(), torch.cat(
            [g.reshape(-1).double() for g in grads])

    out = {}
    for mode, train in (("train", True), ("eval", False)):
        want, want_g = run(torch.bfloat16, threads, train)
        scale = float(want.abs().max())
        for arm, dtype, n in (("one_thread", torch.bfloat16, 1),
                              ("fp32", torch.float32, threads)):
            got, got_g = run(dtype, n, train)
            out[f"{mode}_logits_{arm}"] = float(
                (got - want).abs().max()) / scale
            if train:
                out[f"gradient_{arm}"] = rel(got_g, want_g)
    return out


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def main() -> int:
    torch.manual_seed(0)
    out = {"threads": torch.get_num_threads()}
    for case in CASES:
        ref, ref_state = gradient(*case, torch.float64)
        flat = torch.cat([g.reshape(-1) for g in ref])
        for arm, kw in (("fp32", {}), ("tf32_emulated",
                                       {"emulate_tf32": True})):
            got, state = gradient(*case, torch.float32, **kw)
            out[f"{case[0]}/{arm}"] = {
                "gradient_rel": rel(torch.cat([g.reshape(-1) for g in got]),
                                    flat),
                "worst_parameter_rel": max(rel(a, b)
                                           for a, b in zip(got, ref)),
                "worst_state_rel": max(rel(a, b)
                                       for a, b in zip(state, ref_state))}
        out[f"{case[0]}/bf16"] = bf16_spread(*case)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
