"""The image-family train and eval steps: synchronous SGD (``psum``) and
the reference's periodic averaging (``avg50``).

Counterpart of ``mpi_tensorflow_tpu/train/step.py``: the loss (mean
sparse-softmax cross-entropy plus ``weight_decay`` times the L2 of the
model's regularised subset), its gradients, then the TF momentum update
under the reference's staircase schedule.

``psum``, across ranks (``across_ranks=True``, one shard per rank of
the ``torch.distributed`` world): each rank takes the mean loss of its
own batch window and its gradients, then ONE all-reduce sums the eight
gradients and the loss, packed back to back in one preallocated float32
buffer, and divides by the world size (the reference's ``psum`` then
``/ axis_size``, ``step.py:138-143``).  The L2 term's gradient is the
same on every rank, so the division keeps it.

``psum``, shards in one process (``num_shards`` > 1, no process group):
the global batch is the ``num_shards`` windows concatenated in shard
order, and one ``backward`` of the mean loss over it gives that same
gradient: with equal shards the mean of the per-shard mean losses IS
the global mean.  Only the order of the float32 sums differs.

``grad_accum`` = A > 1 (psum only; the config refuses it under avg50,
as the reference does): each shard's batch splits into A microbatches,
whose gradients are summed and divided by A before the one reduction.

``avg50``: each rank steps its own replica with no communication
(``make_local_train_step``), and ``make_average_step`` replaces the
parameters and momentum velocity of every rank with their mean at the
loop's trace points (the reference's ``bcast_parameters`` with its
missing broadcast supplied).  One process is one card here, so the JAX
package's virtual shards of a stacked state have no counterpart: avg50
runs one replica per rank.

BatchNorm statistics (the ResNet's ``model_state``) follow the JAX
step (``step.py:125-146``): each shard normalises with its own batch's
statistics (in one process, ``shards`` of ``models.base.run_model``),
the microbatches of ``grad_accum`` chain the state one after another,
and psum's new state is the mean over the shards; across ranks the
state's leaves ride in the step's one all-reduce, between the gradients
and the loss.  avg50's average takes the state with the parameters and
the velocity, as the JAX package averages its whole ``TrainState``.

The reference folds its dropout key with the shard index and the step;
the port draws each rank's mask from a generator seeded by ``(seed + 1,
rank, step)`` and the microbatch (``train.graphs.step_generator``),
equal in distribution.

The scanned arm (``make_multi_train_step``, ``make_multi_eval_step``):
K steps, or every eval window, in one call, on the card one CUDA graph
replay (``train.graphs``), on the CPU the steps one after another.  The
LR comes from a ``StepTable`` read at a device step counter, so a replay
reads each step's own rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from mpi_tensorflow_torch.models import base
from mpi_tensorflow_torch.parallel import collectives
from mpi_tensorflow_torch.train import graphs as graphs_lib
from mpi_tensorflow_torch.train.optimizer import (MomentumState, StepTable,
                                                  momentum_apply,
                                                  momentum_init,
                                                  reference_schedule)
from mpi_tensorflow_torch.utils import tree as tree_lib


@dataclasses.dataclass
class TrainState:
    """Parameters (in ``model``), the momentum state with its float32
    step counter, and the model's untrained state.  A step updates the
    parameters and ``opt`` in place."""
    model: Any
    opt: MomentumState
    model_state: Any = dataclasses.field(default_factory=dict)


def _params(model) -> list:
    return tree_lib.leaves(model.param_tree())


def init_state(model) -> TrainState:
    return TrainState(model, momentum_init(_params(model)),
                      base.init_model_state(model))


def make_loss_fn(model, config, shards: int = 1):
    """``loss_fn(model_state, batch, labels, generator) -> (loss,
    new_model_state)``: mean sparse-softmax CE of the training forward
    plus ``config.weight_decay`` x the L2 of ``model.l2_params()``; the
    batch is ``shards`` equal shards for the model's statistics."""

    def loss_fn(model_state, batch, labels, generator=None):
        logits, new_state = base.run_model(model, model_state, batch,
                                           train=True, generator=generator,
                                           shards=shards)
        ce = F.cross_entropy(logits, labels)
        reg = config.weight_decay * sum(base.l2_loss(p)
                                        for p in model.l2_params())
        return ce + reg, new_state

    return loss_fn


def flat_buffer(tensors: list, extra: int = 0):
    """``(buffer, views)``: one float32 buffer on the tensors' device
    holding their elements back to back, then ``extra`` more, and a
    view of it shaped like each tensor."""
    sizes = [t.numel() for t in tensors]
    buf = torch.empty(sum(sizes) + extra, dtype=torch.float32,
                      device=tensors[0].device)
    return buf, [v.view_as(t) for v, t in zip(
        buf[:sum(sizes)].split(sizes), tensors)]


def make_train_step(model, config, num_shards: int, decay_steps: int,
                    across_ranks: bool = False):
    """``train_step(state, batch, labels, generator) -> (state, {"loss":
    float32 scalar tensor, "lr": float32})`` for ``state.model is
    model``: ``batch`` (num_shards x batch_size, H, W, C) holds the
    shards' windows in shard order, ``labels`` their int64 labels;
    ``generator`` feeds dropout (None when the model has none; with
    ``config.grad_accum`` > 1 one generator a microbatch, in a list).
    With ``across_ranks`` the batch is this rank's one shard and the
    gradients, the new model state and the loss are averaged over the
    process group.  The LR is read at the step counter before the
    update, as the reference reads it; the loss stays on the device.

    ``config.grad_accum`` = A > 1 splits each SHARD's batch into A
    microbatches, as the reference does (``step.py:104-125``):
    microbatch i is rows ``[i*b/A, (i+1)*b/A)`` of every shard's window,
    their gradients are summed and divided by A, then reduced once."""
    if across_ranks and num_shards != 1:
        raise ValueError(f"a rank holds one shard; num_shards={num_shards} "
                         f"is the in-process data axis")
    accum = int(config.grad_accum)
    table = StepTable([reference_schedule(config, decay_steps)],
                      next(model.parameters()).device)
    loss_fn = make_loss_fn(model, config, num_shards)
    params = _params(model)
    if across_ranks:
        # the gradients, the model state, then the loss, in one buffer:
        # one all-reduce
        state_size = sum(t.numel() for t in tree_lib.leaves(
            base.init_model_state(model)))
        buf, grad_views = flat_buffer(params, extra=state_size + 1)
        n_grads = buf.numel() - state_size - 1

    def grads_of(model_state, batch, labels, generator):
        if accum == 1:
            loss, new_state = loss_fn(model_state, batch, labels, generator)
            return loss.detach(), torch.autograd.grad(loss, params), new_state
        b = batch.shape[0] // num_shards
        if b % accum:
            raise ValueError(f"per-shard batch {b} not divisible by "
                             f"grad_accum {accum}")
        gens = [None] * accum if generator is None else list(generator)
        # (shard, microbatch, rows): microbatch i of every shard
        xs = batch.reshape(num_shards, accum, b // accum, *batch.shape[1:])
        ys = labels.reshape(num_shards, accum, b // accum)
        grads, loss = None, 0.0
        for i in range(accum):
            part, model_state = loss_fn(
                model_state, xs[:, i].reshape(-1, *batch.shape[1:]),
                ys[:, i].reshape(-1), gens[i])
            g = torch.autograd.grad(part, params)
            grads = g if grads is None else torch._foreach_add(grads, g)
            loss = loss + part.detach()
        return loss / accum, torch._foreach_div(grads, accum), model_state

    def train_step(state: TrainState, batch, labels, generator=None):
        if batch.shape[0] % num_shards:
            raise ValueError(f"global batch {batch.shape[0]} is not "
                             f"{num_shards} equal shards")
        loss, grads, new_state = grads_of(state.model_state, batch, labels,
                                          generator)
        if across_ranks:
            leaves = tree_lib.leaves(new_state)
            torch.cat([g.reshape(-1) for g in grads]
                      + [t.reshape(-1) for t in leaves] + [loss.reshape(1)],
                      out=buf)
            collectives.allreduce_mean(buf)
            grads, loss = grad_views, buf[-1].clone()
            # the state outlives this step's buffer: one copy of its span
            span = buf[n_grads:-1].clone()
            new_state = tree_lib.unflatten(new_state, [
                v.view_as(t) for v, t in zip(
                    span.split([t.numel() for t in leaves]), leaves)])
        lr, = table.read(int(state.opt.step))
        momentum_apply(params, grads, state.opt, lr, config.momentum)
        state.model_state = new_state
        return state, {"loss": loss, "lr": lr}

    train_step.table = table
    return train_step


def make_multi_train_step(model, config, num_shards: int, decay_steps: int,
                          across_ranks: bool = False, rank: int = 0,
                          horizon: int = 0):
    """``multi_step(state, batches, labels, n_valid=None, stop=None) ->
    (state, {"loss": (K,), "lr": (K,)})``: the first ``n_valid`` (default
    K) of the K windows of ``batches`` (K, num_shards x batch_size, H, W,
    C) and ``labels`` (K, ...) as ``n_valid`` steps of
    ``make_train_step``'s function, the counterpart of the reference's
    masked ``make_multi_train_step`` (``step.py:171-221``): the padded
    steps' metrics are 0.  Step t's dropout draws from
    ``step_generator(config.seed + 1, t, rank, microbatch)``, t read
    from ``state.opt.step``, as the image loop seeds its one-step path.

    On the CPU the steps run one after another, each through the
    function ``make_train_step`` returns (the module attribute, so a
    wrapper installed there sees every step), and ``stop(t)``, called
    after step t, ends the window early.  On a CUDA device
    (``graphs.use_graphs``) the window is one replay of a graph of
    ``n_valid`` steps, captured at the width's first call or by
    ``prepare``; ``stop`` is not called, the window runs to its end.
    ``horizon``: the steps of the run, the LR rows a graph reads."""
    one = make_train_step(model, config, num_shards, decay_steps,
                          across_ranks)
    dev = next(model.parameters()).device
    dropout = getattr(model, "dropout_rate", 0.0) > 0.0
    accum = int(config.grad_accum)
    seed = config.seed + 1

    def padded(loss, lr, K):
        z = torch.zeros(K - loss.shape[0], dtype=torch.float32, device=dev)
        return {"loss": torch.cat([loss, z]), "lr": torch.cat([lr, z])}

    def eager(state, batches, labels, n, stop):
        losses, lrs = [], []
        for j in range(n):
            t = int(state.opt.step)
            gen = None
            if dropout:
                gen = [graphs_lib.step_generator(seed, t, dev, rank, i)
                       for i in range(accum)]
                gen = gen[0] if accum == 1 else gen
            state, m = one(state, batches[j], labels[j], gen)
            losses.append(m["loss"])
            lrs.append(m["lr"])
            if stop is not None and stop(t):
                break
        return state, padded(torch.stack(losses).float(),
                             torch.stack(lrs).float(), batches.shape[0])

    graphs, replays, bufs = None, {}, []

    def capture(state, batches, labels, n):
        nonlocal graphs
        if graphs is None:
            graphs = graphs_lib.Graphs(dev)
            bufs.extend([torch.zeros_like(batches), torch.zeros_like(labels)])
        gens = [torch.Generator(device=dev) for _ in range(n * accum)] \
            if dropout else []
        own = tree_lib.leaves(state.model_state)

        def window(xs, ys):
            losses, lrs = [], []
            for j in range(n):
                g = gens[j * accum:(j + 1) * accum] or None
                _, m = one(state, xs[j], ys[j],
                           g[0] if g and accum == 1 else g)
                losses.append(m["loss"])
                lrs.append(m["lr"])
                # the next step (and replay) reads the model state in
                # the storage it was captured on
                new = tree_lib.leaves(state.model_state)
                if any(a is not b for a, b in zip(own, new)):
                    with torch.no_grad():
                        torch._foreach_copy_(own, new)
                    state.model_state = tree_lib.unflatten(
                        state.model_state, own)
            return torch.stack(losses).float(), torch.stack(lrs).float()

        def set_step(s):
            state.opt.step = s

        one.table.freeze(max(horizon, int(state.opt.step) + n))
        return graphs.capture(
            window, [bufs[0][:n], bufs[1][:n]], generators=gens,
            preserve=graphs_lib.snapshot(
                _params(model) + state.opt.velocity + own,
                lambda: state.opt.step, set_step))

    def graphed(state, batches, labels, n):
        if n not in replays:
            replays[n] = capture(state, batches, labels, n)
        r = replays[n]
        t0 = int(state.opt.step)
        one.table.seek(t0)
        seeds = [graphs_lib.step_seed(seed, t0 + j, rank, i)
                 for j in range(n) for i in range(accum)] if dropout else []
        loss, lr = r.replay(batches[:n], labels[:n], seeds=seeds)
        for _ in range(n):
            state.opt.step = np.float32(state.opt.step + np.float32(1.0))
        return state, padded(loss, lr, batches.shape[0])

    def multi_step(state, batches, labels, n_valid=None, stop=None):
        n = batches.shape[0] if n_valid is None else int(n_valid)
        if not 0 < n <= batches.shape[0]:
            raise ValueError(f"n_valid {n} outside 1..{batches.shape[0]}")
        if graphs_lib.use_graphs(dev):
            return graphed(state, batches, labels, n)
        return eager(state, batches, labels, n, stop)

    def prepare(state, batches, labels, widths) -> list:
        """Capture the graph of every width in ``widths`` now (on the
        card; nothing on the CPU): the distinct widths, in order."""
        done = sorted(set(int(w) for w in widths))
        if graphs_lib.use_graphs(dev):
            for w in done:
                if w not in replays:
                    replays[w] = capture(state, batches, labels, w)
        return done

    multi_step.prepare = prepare
    multi_step.replays = replays
    return multi_step


def make_local_train_step(model, config, decay_steps: int):
    """avg50's step: this rank's replica alone, no communication, as
    each MPI rank of the reference steps between syncs (mpipy.py:79-91).
    """
    return make_train_step(model, config, 1, decay_steps)


def make_average_step(state: TrainState):
    """``average(state) -> state``: the mean over the ranks of the
    parameters, the momentum velocity and the model state (BatchNorm's
    running statistics), given to every rank (the corrected
    ``bcast_parameters``, mpipy.py:95-153), as one all-reduce of the
    three packed in one preallocated buffer, divided by the world size.
    The JAX package ``pmean``s the float32 step counter too; it is the
    same number on every rank (every rank takes every step of the
    schedule), so its mean is itself and the port leaves it."""
    def tensors_of(state):
        return (_params(state.model) + state.opt.velocity
                + tree_lib.leaves(state.model_state))

    buf, views = flat_buffer(tensors_of(state))

    @torch.no_grad()
    def average(state: TrainState) -> TrainState:
        tensors = tensors_of(state)
        torch.cat([t.reshape(-1) for t in tensors], out=buf)
        collectives.allreduce_mean(buf)
        torch._foreach_copy_(tensors, views)
        return state

    return average


def broadcast_params(model) -> None:
    """Every rank's parameters become rank 0's, so the replicas start
    identical by construction (the JAX package's replicated ``P()``
    state)."""
    with torch.no_grad():
        for p in _params(model):
            collectives.pbroadcast(p)


def make_eval_step(model, config):
    """``eval_step(state, batch) -> softmax probabilities (N, classes)``:
    the forward without dropout, without gradients, BatchNorm on the
    running statistics.  Each rank predicts with its own replica (its
    parameters and statistics), so under avg50 this is also the
    reference's ``make_stacked_eval_step``;
    ``train.evaluation.eval_sharded`` gives each rank its rows."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        logits, _ = base.run_model(model, state.model_state, batch,
                                   train=False)
        return torch.softmax(logits, dim=-1)

    return eval_step


def make_multi_eval_step(model, config):
    """``multi_eval(state, windows (K, B, ...)) -> (K, B, classes)``
    softmax probabilities: every eval window in one call, the
    counterpart of the reference's ``make_multi_eval_step``
    (``step.py:242-258``).  On the CPU the windows run one after
    another; on a CUDA device (``graphs.use_graphs``) as one replay of a
    graph captured at the first call, whose windows buffer is the first
    call's ``windows`` tensor: pass the same tensor again (uploaded
    once) or one of its shape, copied in.  The graph reads the
    parameters and the model state in place, so the train step must
    keep them in their storage (``make_multi_train_step``'s graphs
    do)."""
    one = make_eval_step(model, config)
    replays = {}

    @torch.no_grad()
    def window(state, windows):
        return torch.stack([one(state, windows[k])
                            for k in range(windows.shape[0])])

    def multi_eval(state, windows):
        if not graphs_lib.use_graphs(windows.device):
            return window(state, windows)
        key = (windows.data_ptr(), tuple(windows.shape))
        if key not in replays:
            g = graphs_lib.Graphs(windows.device)
            replays[key] = g.capture(lambda w: window(state, w), [windows])
        return replays[key].replay(windows).clone()

    return multi_eval

