"""What every model family of the port shares.

Counterpart of ``mpi_tensorflow_tpu/models/base.py``.  A port model is
an ``nn.Module`` that holds its float32 parameters; where the reference
passes ``params`` to a pure ``apply``, the port calls the module.

- ``l2_loss``: ``tf.nn.l2_loss``, ``sum(x**2) / 2``;
- ``run_model``: the uniform forward, ``(outputs, model_state)``,
  whether or not the model carries state (the ResNet's BatchNorm
  statistics, with ``shards`` equal shards of the batch normalised each
  on its own; the CNN and BERT carry none and give back ``{}``);
- ``dropout_mask``: inverted dropout from an explicit
  ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any

import torch


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """``sum(x**2) / 2``."""
    return torch.sum(torch.square(x)) / 2.0


def init_model_state(model) -> Any:
    """A model's mutable, untrained state (``model.init_state()``), or
    ``{}`` for a stateless model."""
    if hasattr(model, "init_state"):
        return model.init_state()
    return {}


def run_model(model, model_state, inputs, *, train: bool, generator=None,
              shards: int = 1):
    """``(outputs, new_model_state)`` of one forward of ``model``;
    ``shards`` reaches a stateful model only (a stateless one computes
    each row on its own)."""
    if hasattr(model, "apply_with_state"):
        return model.apply_with_state(model_state, inputs, train=train,
                                      generator=generator, shards=shards)
    return model(inputs, train=train, generator=generator), model_state


def dropout_mask(x, rate: float, generator: torch.Generator):
    """Inverted dropout: zero with probability ``rate``, scale survivors
    by 1/keep.  The mask is drawn from ``generator`` (on x's device):
    torch cannot reproduce the reference's keyed ``jax.random`` masks, so
    the two agree in distribution, not bit for bit."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)
