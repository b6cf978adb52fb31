"""The ResNet family as an ``nn.Module``: ResNet-20 (CIFAR-10) and
ResNet-50 (ImageNet), BASELINE configs 3 and 4.

Counterpart of ``ResNet`` and ``build`` in
``mpi_tensorflow_tpu/models/resnet.py``:

- ``resnet20``: 3x3 stem of 16, 3 stages of 3 basic blocks, widths
  16/32/64; ``resnet50``: 7x7/2 stem of 64 + 3x3/2 max-pool, stages
  [3, 4, 6, 3] of bottleneck blocks, widths 256/512/1024/2048;
- the first block of every stage after the first strides by 2, on
  ``conv1`` of a basic block and on ``conv2`` (the 3x3) of a
  bottleneck; a block has a 1x1 projection (and its BatchNorm) where
  its stride is 2 or its input width differs from its own, so
  ResNet-50's first block (64 -> 256 at stride 1) has one;
- the trees are the reference's: parameters ``stem.{w, bn}``,
  ``stages[s][b].{conv1.., bn1.., proj, bn_proj}``, ``fc.{w, b}``
  (``param_tree``), running statistics ``stem`` and ``stages[s][b].{bn1..,
  bn_proj}`` of ``{mean, var}`` (``init_state``); conv weights OIHW (the
  reference's HWIO transposed, ``models/convert.resnet_params_from_jax``)
  in channels-last memory, like the activations: the NHWC input
  permuted to NCHW is channels-last already, cuDNN's layout of choice
  on the card;
- He-normal init (``sqrt(2 / fan_in)``) of every conv, the fc weight
  normal x 0.01 and its bias 0, BatchNorm scale 1 and offset 0, from an
  explicit ``torch.Generator`` (the two packages' random streams
  differ: parity runs carry the reference's parameters across);
- ``apply_with_state(model_state, x, train=, generator=, shards=)``
  returns ``(float32 logits, new_state)`` and never changes
  ``model_state`` in place; ``shards`` is the in-process data axis of
  ``ops.nn.batch_norm``;
- ``l2_params``: the conv, projection and fc weights, not BatchNorm's
  parameters and not the fc bias;
- ``compute_dtype`` bf16 rounds where the reference does: the input
  and the weights cast at each conv, BatchNorm's output, the ReLUs and
  the residual add in bf16, the global mean accumulated in float32 and
  returned in bf16, the fc a bf16 product cast to float32, then
  ``+ b``.  Parameters, gradients and statistics stay float32;
- ``remat``: each residual block runs under ``torch.utils.checkpoint``
  (non-reentrant), its activations recomputed in the backward.  The
  block returns its BatchNorm statistics and changes none in place, so
  the recomputation's statistics are dropped and the state is the
  forward's, as without remat.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpi_tensorflow_torch.ops import nn as ops
from mpi_tensorflow_torch.utils import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class Geometry:
    stage_sizes: Sequence[int]
    widths: Sequence[int]
    bottleneck: bool
    num_classes: int = 10
    cifar_stem: bool = True       # 3x3/1 stem of 16; else 7x7/2 of 64 +
                                  # the 3x3/2 max-pool
    bn_momentum: float = 0.9

    @property
    def stem_width(self) -> int:
        return 16 if self.cifar_stem else 64

    def blocks(self):
        """``(stage, block, in_width, width, stride)`` in order."""
        in_w = self.stem_width
        for s, (n, width) in enumerate(zip(self.stage_sizes, self.widths)):
            for b in range(n):
                yield s, b, in_w, width, 2 if (b == 0 and s > 0) else 1
                in_w = width

    def mid(self, width: int) -> int:
        return width // 4 if self.bottleneck else width

    def block_convs(self, in_w: int, width: int, stride: int) -> list:
        """``[(name, bn name or None, OIHW shape)]`` of one block."""
        mid = self.mid(width)
        if self.bottleneck:
            convs = [("conv1", "bn1", (mid, in_w, 1, 1)),
                     ("conv2", "bn2", (mid, mid, 3, 3)),
                     ("conv3", "bn3", (width, mid, 1, 1))]
        else:
            convs = [("conv1", "bn1", (mid, in_w, 3, 3)),
                     ("conv2", "bn2", (width, mid, 3, 3))]
        if stride != 1 or in_w != width:
            convs.append(("proj", "bn_proj", (width, in_w, 1, 1)))
        return convs


def geometry(name: str, num_classes=None) -> Geometry:
    """``resnet20`` or ``resnet50`` (``num_classes`` None or 0: 10 and
    1000), as the reference's ``build``."""
    if name == "resnet20":
        return Geometry((3, 3, 3), (16, 32, 64), False,
                        num_classes or 10, True)
    if name == "resnet50":
        return Geometry((3, 4, 6, 3), (256, 512, 1024, 2048), True,
                        num_classes or 1000, False)
    raise ValueError(f"unknown resnet variant {name!r}")


def param_shapes(geo: Geometry) -> dict:
    """The parameter tree's shapes (conv weights OIHW)."""
    def bn(c):
        return {"scale": (c,), "offset": (c,)}

    stem = (geo.stem_width, 3) + ((3, 3) if geo.cifar_stem else (7, 7))
    stages = [[] for _ in geo.stage_sizes]
    for s, _, in_w, width, stride in geo.blocks():
        block = {}
        for conv, bn_name, shape in geo.block_convs(in_w, width, stride):
            block[conv] = shape
            block[bn_name] = bn(shape[0])
        stages[s].append(block)
    return {"stem": {"w": stem, "bn": bn(geo.stem_width)},
            "stages": stages,
            "fc": {"w": (geo.widths[-1], geo.num_classes),
                   "b": (geo.num_classes,)}}


def init_params(geo: Geometry, generator: torch.Generator) -> dict:
    """Fresh parameters in the port's layout, drawn in tree order."""
    def draw(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape)
        if path[-1] in ("offset", "b"):
            return torch.zeros(shape)
        std = 0.01 if path[0] == "fc" else math.sqrt(
            2.0 / (shape[1] * shape[2] * shape[3]))
        return torch.randn(shape, generator=generator) * std

    return tree_lib.map_leaves(draw, param_shapes(geo))


def _attr(path) -> str:
    return "__".join(str(p) for p in path)


class ResNet(nn.Module):
    """The ResNet of ``geo`` over float32 parameters ``params`` (the
    port's layout; fresh ones from ``from_seed``)."""

    def __init__(self, geo: Geometry, params: dict, *,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.geo = geo
        self.remat = remat
        self.num_classes = geo.num_classes
        self.compute_dtype = compute_dtype
        shapes = param_shapes(geo)
        got = tree_lib.map_leaves(lambda _, x: tuple(x.shape), params)
        if got != shapes:
            raise ValueError(f"parameter tree {got} is not {geo}'s")

        def register(path, _):
            t = torch.as_tensor(tree_lib.at(params, path)).detach().to(
                torch.float32).clone()
            if t.ndim == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            self.register_parameter(_attr(path), nn.Parameter(t))
            return _attr(path)

        # the geometry's order, whatever order ``params``' dicts hold
        self._layout = tree_lib.map_leaves(register, shapes)

    @classmethod
    def from_seed(cls, geo: Geometry, seed: int = 0, **kw) -> "ResNet":
        """Random weights from ``seed`` (a CPU ``torch.Generator``)."""
        return cls(geo, init_params(geo, torch.Generator().manual_seed(seed)),
                   **kw)

    def param_tree(self) -> dict:
        """The parameters in the reference's tree and order."""
        return tree_lib.map_leaves(lambda _, name: getattr(self, name),
                                   self._layout)

    def init_state(self) -> dict:
        """Running statistics: mean 0, variance 1, on the parameters'
        device."""
        dev = self.stem__w.device
        state = {"stem": ops.bn_state_init(self.geo.stem_width)}
        stages = [[] for _ in self.geo.stage_sizes]
        for s, _, in_w, width, stride in self.geo.blocks():
            stages[s].append({bn: ops.bn_state_init(shape[0]) for _, bn, shape
                              in self.geo.block_convs(in_w, width, stride)})
        state["stages"] = stages
        return tree_lib.map_leaves(lambda _, t: t.to(dev), state)

    def _conv(self, x, w, stride: int = 1):
        dt = self.compute_dtype
        return ops.conv2d(x.to(dt), w.to(dt), stride)

    def apply_with_state(self, model_state: dict, inputs: torch.Tensor, *,
                         train: bool = False, generator=None,
                         shards: int = 1):
        """``(logits (N, classes) float32, new_state)`` of NHWC
        ``inputs``; BatchNorm uses the batch's statistics in training
        (per shard) and ``model_state``'s otherwise."""
        del generator                       # no dropout in the family
        p = self.param_tree()
        mom = self.geo.bn_momentum

        def bn(x, params, state):
            return ops.batch_norm(x, params, state, train=train,
                                  momentum=mom, shards=shards)

        x = inputs.permute(0, 3, 1, 2)                  # NHWC -> NCHW
        h = self._conv(x, p["stem"]["w"], 1 if self.geo.cifar_stem else 2)
        h, stem_state = bn(h, p["stem"]["bn"], model_state["stem"])
        h = F.relu(h)
        if not self.geo.cifar_stem:
            h = ops.max_pool(h, window=3, stride=2)
        stages = [[] for _ in self.geo.stage_sizes]
        block = self._block
        if self.remat and torch.is_grad_enabled():
            from torch.utils import checkpoint as ckpt

            def block(*args):
                return ckpt.checkpoint(self._block, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        for s, b, in_w, width, stride in self.geo.blocks():
            h, ns = block(p["stages"][s][b], model_state["stages"][s][b], h,
                          stride, bn)
            stages[s].append(ns)
        h = ops.global_avg_pool(h)
        dt = self.compute_dtype
        logits = (h.to(dt) @ p["fc"]["w"].to(dt)).to(torch.float32) \
            + p["fc"]["b"]
        # init_state's order (utils/tree.py)
        return logits, {"stem": stem_state, "stages": stages}

    def _block(self, p, s, x, stride, bn):
        ns = {}
        shortcut = x
        if "proj" in p:
            shortcut, proj_state = bn(self._conv(x, p["proj"], stride),
                                      p["bn_proj"], s["bn_proj"])
        if self.geo.bottleneck:
            h, ns["bn1"] = bn(self._conv(x, p["conv1"]), p["bn1"], s["bn1"])
            h, ns["bn2"] = bn(self._conv(F.relu(h), p["conv2"], stride),
                              p["bn2"], s["bn2"])
            h, ns["bn3"] = bn(self._conv(F.relu(h), p["conv3"]), p["bn3"],
                              s["bn3"])
        else:
            h, ns["bn1"] = bn(self._conv(x, p["conv1"], stride), p["bn1"],
                              s["bn1"])
            h, ns["bn2"] = bn(self._conv(F.relu(h), p["conv2"]), p["bn2"],
                              s["bn2"])
        if "proj" in p:
            ns["bn_proj"] = proj_state
        return F.relu(h + shortcut), ns

    def l2_params(self) -> list:
        """Conv, projection and fc weights (not BatchNorm's parameters,
        not the fc bias), in the reference's order."""
        p = self.param_tree()
        out = [p["stem"]["w"], p["fc"]["w"]]
        for blocks in p["stages"]:
            for block in blocks:
                out.extend(v for k, v in block.items()
                           if k.startswith("conv") or k == "proj")
        return out


def build(name: str, num_classes=None, seed: int = 0,
          compute_dtype: torch.dtype = torch.float32,
          remat: bool = False) -> ResNet:
    """``resnet20`` or ``resnet50`` with random weights from ``seed``;
    ``remat`` recomputes each residual block in the backward."""
    return ResNet.from_seed(geometry(name, num_classes), seed,
                            compute_dtype=compute_dtype, remat=remat)
