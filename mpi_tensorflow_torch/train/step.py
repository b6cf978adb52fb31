"""The image-family train and eval steps: synchronous SGD (``psum``).

Counterpart of the psum path of ``mpi_tensorflow_tpu/train/step.py``:
the loss (mean sparse-softmax cross-entropy plus ``weight_decay`` times
the L2 of the model's regularised subset), its gradients, then the TF
momentum update under the reference's staircase schedule.

Shards in one process.  The reference runs one shard per device:
every shard takes the mean loss of its own batch window, the gradients
are summed over the ``data`` axis and divided by its size.  Here the
global batch is the ``num_shards`` windows concatenated in shard order
(the layout ``train.loop`` builds), and one ``backward`` of the mean
loss over it gives that same gradient: with equal shards the mean of
the per-shard mean losses IS the global mean, and the L2 term, the same
on every shard, survives the division unchanged.  Only the order of the
float32 sums differs.  The data axis over ``torch.distributed`` and the
``avg50`` mode (per-shard SGD with periodic averaging) are ROADMAP
Queue 1 items 7-10, slice B.

The reference folds its dropout key with the shard index and the step;
the port draws one mask over the global batch from a generator seeded
by ``(seed + 1, step)`` (``train.gspmd.step_generator``), equal in
distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from mpi_tensorflow_torch.models import base
from mpi_tensorflow_torch.train.optimizer import (MomentumState,
                                                  momentum_apply,
                                                  momentum_init,
                                                  named_leaves,
                                                  reference_schedule)


@dataclasses.dataclass
class TrainState:
    """Parameters (in ``model``), the momentum state with its float32
    step counter, and the model's untrained state.  A step updates the
    parameters and ``opt`` in place."""
    model: Any
    opt: MomentumState
    model_state: Any = dataclasses.field(default_factory=dict)


def _params(model) -> list:
    return [p for _, p in named_leaves(model.param_tree())]


def init_state(model) -> TrainState:
    return TrainState(model, momentum_init(_params(model)),
                      base.init_model_state(model))


def make_loss_fn(model, config):
    """``loss_fn(model_state, batch, labels, generator) -> (loss,
    new_model_state)``: mean sparse-softmax CE of the training forward
    plus ``config.weight_decay`` x the L2 of ``model.l2_params()``."""

    def loss_fn(model_state, batch, labels, generator=None):
        logits, new_state = base.run_model(model, model_state, batch,
                                           train=True, generator=generator)
        ce = F.cross_entropy(logits, labels)
        reg = config.weight_decay * sum(base.l2_loss(p)
                                        for p in model.l2_params())
        return ce + reg, new_state

    return loss_fn


def make_train_step(model, config, num_shards: int, decay_steps: int):
    """``train_step(state, batch, labels, generator) -> (state, {"loss":
    float32 scalar tensor, "lr": float32})`` for ``state.model is
    model``: ``batch`` (num_shards x batch_size, H, W, C) holds the
    shards' windows in shard order, ``labels`` their int64 labels;
    ``generator`` feeds dropout (None when the model has none).  The LR
    is read at the step counter before the update, as the reference
    reads it; the loss stays on the device."""
    schedule = reference_schedule(config, decay_steps)
    loss_fn = make_loss_fn(model, config)
    params = _params(model)

    def train_step(state: TrainState, batch, labels, generator=None):
        if batch.shape[0] % num_shards:
            raise ValueError(f"global batch {batch.shape[0]} is not "
                             f"{num_shards} equal shards")
        loss, new_state = loss_fn(state.model_state, batch, labels,
                                  generator)
        grads = torch.autograd.grad(loss, params)
        lr = schedule(state.opt.step)
        momentum_apply(params, grads, state.opt, lr, config.momentum)
        state.model_state = new_state
        return state, {"loss": loss.detach(), "lr": lr}

    return train_step


def make_eval_step(model, config):
    """``eval_step(state, batch) -> softmax probabilities (N, classes)``:
    the forward without dropout, without gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        logits, _ = base.run_model(model, state.model_state, batch,
                                   train=False)
        return torch.softmax(logits, dim=-1)

    return eval_step

