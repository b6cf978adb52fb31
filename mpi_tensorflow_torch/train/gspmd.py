"""The transformer train and eval steps on one device.

Counterpart of ``make_gspmd_train_step`` / ``make_gspmd_eval_step`` in
``mpi_tensorflow_tpu/train/gspmd.py``.  On one card there is no sharding:
the reference's GSPMD placement, its FSDP/zero1 layouts and its
microbatch accumulation have nothing to place, and data parallelism
over NCCL is a later slice (ROADMAP Queue 1 item 12).  What remains is
the step itself: loss, ``backward``, then the optimizer update.

Where the reference folds its rng with the step (``fold_in(rng,
state.step)``), the port draws each step's dropout masks from a
``torch.Generator`` seeded by ``(seed, step)`` and, on a data axis across
ranks, the rank (``step_generator``).
"""

from __future__ import annotations

import dataclasses

import torch

from mpi_tensorflow_torch.models.bert import BertMlm
from mpi_tensorflow_torch.train.optimizer import (AdamWState, TransformerTx,
                                                  named_leaves)


@dataclasses.dataclass
class TrainState:
    """Parameters (in ``model``), optimizer state and step count.  The
    step updates the model's parameters and ``opt`` in place."""
    model: BertMlm
    opt: AdamWState
    step: int = 0


def init_state(model: BertMlm, tx: TransformerTx) -> TrainState:
    return TrainState(model, tx.init(model.param_tree()))


def step_generator(seed: int, step: int, device,
                   rank: int = 0) -> torch.Generator:
    """The dropout generator of one train step of one rank, on
    ``device``, seeded by ``(seed, rank, step)``; rank 0's is the
    one-process run's."""
    return torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + int(step) + (int(rank) << 40))


def make_train_step(tx: TransformerTx):
    """``train_step(state, batch, labels, generator) -> (state, {"loss":
    float32 scalar tensor})``: ``BertMlm.loss`` in train mode, its
    gradients by ``backward``, then ``tx``'s update of every leaf.
    ``batch`` holds ``tokens`` and ``mask`` (B, S); ``labels`` (B, S);
    ``generator`` feeds dropout (None when ``cfg.dropout == 0``).  The
    loss stays on the device: nothing here waits for the card."""

    def train_step(state: TrainState, batch: dict, labels,
                   generator=None):
        model = state.model
        tree = model.param_tree()
        params = [p for _, p in named_leaves(tree)]
        for p in params:
            p.grad = None
        loss = model.loss(batch, labels, train=True, generator=generator)
        loss.backward()
        # a leaf the loss does not read (pos_emb under rope) has a zero
        # gradient, as jax.grad gives it
        tx.update(tree, [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in params], state.opt)
        for p in params:
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_eval_step():
    """``eval_step(state, tokens) -> float32 logits (B, S, V)``: the
    forward in eval mode (no dropout), without gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, tokens):
        return state.model.apply(tokens, train=False)

    return eval_step
