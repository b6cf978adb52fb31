"""The Vision Transformer: BERT's encoder stack on image patches.

Counterpart of ``mpi_tensorflow_tpu/models/vit.py``: ``VitConfig`` with
its ``VIT_TINY_CIFAR`` and ``VIT_S16_IMAGENET`` presets, and
``VisionTransformer``, which the image loop and step
(``train/loop.py``, ``train/step.py``) train like the CNN and the
ResNets: momentum SGD under the reference's staircase decay, no L2 term
(``l2_params`` is empty, as the reference's is).

- The patch embedding is a reshape and a permute of the NHWC images
  into (B, N, P*P*C) rows, then one (N, P*P*C) x (P*P*C, E) product
  (``_patchify``), as the reference's; no convolution.
- A CLS row is prepended, ``pos_emb`` (N + 1 rows) added, then the
  embedding LayerNorm and, in training, dropout.
- The layers are ``models/bert.EncoderLayer`` run through
  ``bert.run_layer`` (its remat and its dropout generator), the encoder
  configured as ``BERT_TINY`` with the ViT's widths and ``max_positions
  = N + 1`` (``encoder_config``, the reference's ``_bert_cfg``).  Their
  attention is ``bert.attend``'s "auto" rule: at N + 1 = 17, 65 or 197
  tokens it is below ``flash_min_seq`` (4096), so ViT takes dense
  attention and launches no hand kernel.
- The head: the CLS row's LayerNorm in float32, then ``head_w`` and
  ``head_b``; the logits are float32.

Parameters are float32 leaves in the reference's tree (``layers`` a
list of BERT's layer dicts), each matmul weight cast to ``cfg.dtype``
at use.  Dropout draws its masks from a ``torch.Generator`` in the
reference's site order (the embedding, then each layer's attention and
MLP outputs); the reference keys each site by ``fold_in``, so the two
agree in distribution.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from mpi_tensorflow_torch.models import bert as bert_lib
from mpi_tensorflow_torch.models.base import dropout_mask


@dataclasses.dataclass(frozen=True)
class VitConfig:
    image_size: int = 32
    patch: int = 4
    channels: int = 3
    num_classes: int = 10
    hidden: int = 192         # ViT-Tiny geometry for CIFAR by default
    layers: int = 12
    heads: int = 3
    mlp: int = 768
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch:
            raise ValueError(f"image_size {self.image_size} not divisible "
                             f"by patch {self.patch}")
        return (self.image_size // self.patch) ** 2


VIT_TINY_CIFAR = VitConfig()
VIT_S16_IMAGENET = VitConfig(image_size=224, patch=16, num_classes=1000,
                             hidden=384, layers=12, heads=6, mlp=1536)


def encoder_config(cfg: VitConfig) -> bert_lib.BertConfig:
    """The shared encoder's configuration: ``BERT_TINY`` with the ViT's
    widths, dropout, dtype and remat, and one position a patch plus the
    CLS row."""
    return dataclasses.replace(
        bert_lib.BERT_TINY, hidden=cfg.hidden, layers=cfg.layers,
        heads=cfg.heads, mlp=cfg.mlp, dropout=cfg.dropout, dtype=cfg.dtype,
        remat=cfg.remat, max_positions=cfg.num_patches + 1)


def init_params(cfg: VitConfig, generator: torch.Generator) -> dict:
    """Seeded float32 parameters in the reference's tree: weights, the
    CLS row and ``pos_emb`` normal x 0.02, biases zero, LayerNorm scales
    one; the layers are BERT's (``bert.init_params``' layer dicts)."""
    c = cfg

    def normal(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    def ln():
        return {"scale": torch.ones(c.hidden), "bias": torch.zeros(c.hidden)}

    pdim = c.patch * c.patch * c.channels
    return {
        "patch_w": normal(pdim, c.hidden),
        "patch_b": torch.zeros(c.hidden),
        "cls": normal(1, 1, c.hidden),
        "pos_emb": normal(c.num_patches + 1, c.hidden),
        "emb_ln": ln(),
        "layers": bert_lib.init_params(encoder_config(c),
                                       generator)["layers"],
        "head_ln": ln(),
        "head_w": normal(c.hidden, c.num_classes),
        "head_b": torch.zeros(c.num_classes),
    }


class VisionTransformer(nn.Module):
    """ViT over float32 parameters ``params`` (the reference's tree;
    fresh ones from ``from_seed``)."""

    def __init__(self, cfg: VitConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder_cfg = encoder_config(cfg)
        self.num_classes = cfg.num_classes
        self.dropout_rate = cfg.dropout     # the image loop's dropout test
        f32 = torch.float32
        for name in ("patch_w", "patch_b", "cls", "pos_emb", "head_w",
                     "head_b"):
            setattr(self, name, bert_lib._param(params[name], f32, True))
        self.emb_ln = bert_lib.LayerNorm(params["emb_ln"], trainable=True)
        self.layers = nn.ModuleList(
            bert_lib.EncoderLayer(lp, cfg.dtype, trainable=True)
            for lp in params["layers"])
        self.head_ln = bert_lib.LayerNorm(params["head_ln"], trainable=True)

    @classmethod
    def from_seed(cls, cfg: VitConfig, seed: int = 0) -> "VisionTransformer":
        """Random weights from ``seed`` (a CPU ``torch.Generator``)."""
        return cls(cfg, init_params(cfg, torch.Generator().manual_seed(seed)))

    def param_tree(self) -> dict:
        """The parameters in the reference's pytree layout."""
        return {"patch_w": self.patch_w, "patch_b": self.patch_b,
                "cls": self.cls, "pos_emb": self.pos_emb,
                "emb_ln": self.emb_ln.tree(),
                "layers": [layer.tree() for layer in self.layers],
                "head_ln": self.head_ln.tree(),
                "head_w": self.head_w, "head_b": self.head_b}

    def _patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, N, P*P*C) by reshape and permute."""
        P = self.cfg.patch
        B, H, W, C = images.shape
        g = H // P
        x = images.reshape(B, g, P, g, P, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, P * P * C)

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        """float32 logits (B, num_classes) of NHWC ``images``.  In
        training with ``cfg.dropout > 0``, dropout draws from
        ``generator`` (required)."""
        c, ecfg = self.cfg, self.encoder_cfg
        dt = c.dtype
        gen = None
        if train and c.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout needs a generator in train mode")
            gen = generator
        x = self._patchify(images.to(dt))
        h = x @ self.patch_w.to(dt) + self.patch_b.to(dt)
        B = h.shape[0]
        cls = self.cls.to(dt).expand(B, 1, c.hidden)
        h = torch.cat([cls, h], 1) + self.pos_emb[None].to(dt)
        h = self.emb_ln(h)
        if gen is not None:
            h = dropout_mask(h, c.dropout, gen)
        h = h.to(dt)
        attention = functools.partial(bert_lib.attend, cfg=ecfg)

        def layer_fn(layer):
            def fn(h, g):
                drop = None if g is None else functools.partial(
                    dropout_mask, rate=c.dropout, generator=g)
                return layer.forward(h, attention, dt, drop)
            return fn

        for layer in self.layers:
            h = bert_lib.run_layer(ecfg, layer_fn(layer), h, gen)
        cls_out = self.head_ln(h[:, 0].to(torch.float32))
        logits = cls_out @ self.head_w + self.head_b
        return logits.to(torch.float32)

    def l2_params(self) -> list:
        """None: the transformer families take no L2 term."""
        return []
