"""The reference MNIST CNN as an ``nn.Module``.

Counterpart of ``MnistCnn`` in ``mpi_tensorflow_tpu/models/cnn.py``:
[conv 5x5 SAME -> bias -> relu -> max-pool 2x2 SAME] x2 (32 then 64
channels) -> flatten -> fc 512 + relu -> dropout (training only) -> fc
``num_classes``.  Its conv, pool and matmuls were XLA's in the JAX
package and are PyTorch's here (``F.conv2d``, ``F.max_pool2d``,
``torch.matmul``); no hand kernel lies on this model.

Layouts and numerics against the reference:

- inputs are NHWC ``(N, H, W, C)`` float32, as the data path gives them;
  the convolutions run NCHW with OIHW weights (the reference's HWIO
  transposed; ``models/convert.cnn_params_from_jax``), the fc weights
  keep the reference's ``(in, out)``;
- 5x5 SAME at stride 1 is symmetric padding 2;
- 2x2 stride-2 SAME max-pooling pads at the end with -inf, which is
  ``ceil_mode=True``: no padding at 28 -> 14 -> 7, one row and column at
  odd sizes;
- the flatten is the reference's NHWC row-major one: the activations
  are permuted NCHW -> NHWC first, so ``fc1_w``'s rows line up;
- ``compute_dtype`` casts the inputs and every parameter at each use
  (bf16 keeps float32 parameters and gradients); logits come back
  float32.  Each bias is its own add after the convolution or matmul,
  as in the reference, so bf16 rounds at the reference's points (a
  bias folded into the convolution or matmul rounds once fewer and
  put the bf16 weight gradients 10-20x further from the reference's);
- init: TF truncated normal on [-2, 2] x 0.1 for the weights, from an
  explicit ``torch.Generator``; ``conv1_b`` 0, the other biases 0.1;
- ``flat_dim`` is ``ceil(image_size / 4)^2 * 64``, the size the two
  SAME pools really give.  The reference's ``(image_size // 4)^2 * 64``
  equals it at multiples of 4 and is one row short otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpi_tensorflow_torch.models.base import dropout_mask

NAMES = ("conv1_w", "conv1_b", "conv2_w", "conv2_b",
         "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def truncated_normal(shape, generator: torch.Generator,
                     stddev: float = 0.1) -> torch.Tensor:
    """TF ``truncated_normal``: N(0, 1) truncated to [-2, 2], times
    ``stddev``."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * stddev


def max_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 SAME max-pooling of NCHW ``x``."""
    return F.max_pool2d(x, kernel_size=2, stride=2, ceil_mode=True)


def flat_dim(image_size: int) -> int:
    return (-(-image_size // 4)) ** 2 * 64


def init_params(generator: torch.Generator, image_size: int = 28,
                num_channels: int = 1, num_classes: int = 10,
                hidden: int = 512) -> dict:
    """Fresh parameters in the port's layout (conv weights OIHW)."""
    c = num_channels
    return {
        "conv1_w": truncated_normal((32, c, 5, 5), generator),
        "conv1_b": torch.zeros(32),
        "conv2_w": truncated_normal((64, 32, 5, 5), generator),
        "conv2_b": torch.full((64,), 0.1),
        "fc1_w": truncated_normal((flat_dim(image_size), hidden), generator),
        "fc1_b": torch.full((hidden,), 0.1),
        "fc2_w": truncated_normal((hidden, num_classes), generator),
        "fc2_b": torch.full((num_classes,), 0.1),
    }


class MnistCnn(nn.Module):
    """The CNN over float32 parameters ``params`` (port layout; fresh
    ones from ``from_seed``)."""

    def __init__(self, params: dict, *, image_size: int = 28,
                 num_channels: int = 1, num_classes: int = 10,
                 hidden: int = 512, dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size = image_size
        self.num_channels = num_channels
        self.num_classes = num_classes
        self.hidden = hidden
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        for name in NAMES:
            setattr(self, name, nn.Parameter(
                torch.as_tensor(params[name]).to(torch.float32).clone()))
        if self.fc1_w.shape[0] != flat_dim(image_size):
            raise ValueError(f"fc1_w has {self.fc1_w.shape[0]} rows; image "
                             f"size {image_size} gives "
                             f"{flat_dim(image_size)} features")

    @classmethod
    def from_seed(cls, seed: int = 0, **kw) -> "MnistCnn":
        """Random weights from ``seed`` (a CPU ``torch.Generator``)."""
        gen = torch.Generator().manual_seed(seed)
        geometry = {k: kw[k] for k in ("image_size", "num_channels",
                                       "num_classes", "hidden") if k in kw}
        return cls(init_params(gen, **geometry), **kw)

    def param_tree(self) -> dict:
        """The parameters by the reference's names, in its order."""
        return {name: getattr(self, name) for name in NAMES}

    def forward(self, inputs: torch.Tensor, *, train: bool = False,
                generator=None) -> torch.Tensor:
        """float32 logits ``(N, num_classes)`` of NHWC ``inputs``.  In
        training, dropout draws its mask from ``generator`` (required
        when ``dropout_rate > 0``)."""
        dt = self.compute_dtype
        x = inputs.to(dt).permute(0, 3, 1, 2)            # NHWC -> NCHW
        x = F.relu(F.conv2d(x, self.conv1_w.to(dt), padding=2)
                   + self.conv1_b.to(dt)[:, None, None])
        x = max_pool_2x2_same(x)
        x = F.relu(F.conv2d(x, self.conv2_w.to(dt), padding=2)
                   + self.conv2_b.to(dt)[:, None, None])
        x = max_pool_2x2_same(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(x @ self.fc1_w.to(dt) + self.fc1_b.to(dt))
        if train and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("dropout needs a generator in train mode")
            x = dropout_mask(x, self.dropout_rate, generator)
        logits = x @ self.fc2_w.to(dt) + self.fc2_b.to(dt)
        return logits.to(torch.float32)

    def l2_params(self) -> list:
        """The parameters under L2: the fc weights AND biases."""
        return [self.fc1_w, self.fc1_b, self.fc2_w, self.fc2_b]
