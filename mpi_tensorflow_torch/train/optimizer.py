"""The port's optimizers: TF momentum under the reference's staircase
decay (the image families), and adamw or LAMB under a warmup schedule
with global-norm clipping (the transformer family).

Counterpart of ``mpi_tensorflow_tpu/train/optimizer.py``.

The image families (``exponential_decay``, ``reference_schedule``,
``momentum_apply``) follow the reference MPI script's TF v1 graph:

- the step counter is a float32 (``MomentumState.step``), advanced by
  one per update;
- LR = ``base_lr * rate ** floor(step * batch_size / decay_steps)``,
  every operation in float32 as the JAX package computes it in-graph.
  The power is taken in float64 and rounded to float32: that equals
  XLA's float32 power on the CPU at every exponent below 58 at rate
  0.95 (58 decays: epoch 58 of a run), and differs by an ulp at some
  exponents past it;
- ``tf.train.MomentumOptimizer``: ``v = m*v + g; p -= lr*v``, the LR
  applied at update time.  ``torch.optim.SGD`` folds its LR and
  dampening differently, so the update is written out.

The transformer family (``warmup_linear``, ``warmup_cosine``,
``decay_mask``, ``transformer_tx``) is written out to match optax rather than
``torch.optim.AdamW`` — the two differ in where the schedule is read
and in how clipping scales:

- ``clip_by_global_norm(1.0)``: gradients are scaled by ``max / |g|``
  only when ``|g| >= max`` (not ``clip_grad_norm_``'s ``max / (|g| +
  1e-6)``);
- adamw: b1 0.9, b2 0.999, eps 1e-8, bias correction at ``count + 1``,
  ``u = m_hat / (sqrt(v_hat) + eps) + wd * p`` with the decay only on
  ``decay_mask`` leaves, then ``p -= lr * u``;
- lamb (``optax.lamb``): the same moments with eps 1e-6, the masked
  decay added, then each leaf's update scaled by its trust ratio
  ``|p| / |u|`` (1 where either norm is 0, as on a zero-initialised
  bias at step 0), on every leaf, LayerNorm and biases included;
- the learning rate is read at ``count`` BEFORE the increment, so step 0
  runs at LR 0 under the warmup schedules.

Both update in place on the parameter tensors (optax returns new
arrays; here the parameters live in an ``nn.Module``), with ``torch``'s
multi-tensor ops, and read nothing back to the host.

Every per-step scalar a step reads (the LR, adamw's bias corrections)
comes from a ``StepTable``: the host schedule evaluated once per step by
the functions above, uploaded, and read inside the step at a device step
counter.  A captured CUDA graph (``train.graphs``) then reads each
replay's own values, where a host float would be frozen at the capture's;
the values are the host schedule's by construction.  The host counters
(``MomentumState.step``, ``AdamWState.count``) stay the record a
checkpoint saves.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from mpi_tensorflow_torch.parallel import collectives
from mpi_tensorflow_torch.utils import tree as tree_lib

_F32 = np.float32
# bias-like leaf names across the families (the reference's regex)
_BIAS_NAME = re.compile(r"^x?(b[a-z0-9]?|eb\d)$")
B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults
LAMB_EPS = 1e-6                         # optax.lamb's


class StepTable:
    """Per-step float32 values of host functions, on ``device``.

    Row i holds ``[fn(i) for fn in fns]``, computed on the host by the
    schedules themselves.  ``read(step)`` returns step ``step``'s row as
    0-d tensors and advances the device counter ``index``: outside a
    graph capture it first sets the counter to ``step``; inside one the
    counter is what the replay's ``seek`` made it, advanced by the steps
    before it in the graph.  The rows grow on the host as steps need
    them, until a capture ``freeze``s the table: a graph reads the
    storage it was captured on."""

    def __init__(self, fns, device):
        self.fns = tuple(fns)
        self.device = torch.device(device)
        self.values = torch.empty((0, len(self.fns)), dtype=torch.float32,
                                  device=self.device)
        self.index = torch.zeros((), dtype=torch.long, device=self.device)
        self.frozen = False

    def ensure(self, steps: int) -> None:
        """Rows for steps ``[0, steps)``."""
        have = self.values.shape[0]
        if steps <= have:
            return
        if self.frozen:
            raise RuntimeError(f"step {steps - 1} is past the {have} steps "
                               f"of a table a captured graph reads")
        n = max(steps, 2 * have, 64)
        rows = np.array([[fn(i) for fn in self.fns] for i in range(n)],
                        dtype=np.float32)
        self.values = torch.from_numpy(rows).to(self.device)

    def freeze(self, steps: int) -> None:
        self.ensure(steps)
        self.frozen = True

    def seek(self, step: int) -> None:
        self.ensure(int(step) + 1)
        self.index.fill_(int(step))

    def read(self, step: int) -> tuple:
        if not capturing(self.device):
            self.seek(step)
        # index_select: indexing by a 0-d tensor would read it on the host
        row = self.values.index_select(0, self.index.view(1))[0]
        self.index.add_(1)
        return row.unbind()


def capturing(device) -> bool:
    """Whether the current stream of ``device`` is capturing a graph."""
    return torch.device(device).type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


def constant(base_lr: float):
    """A flat learning rate, in float32."""
    return lambda step: _F32(base_lr)


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int,
                  end_fraction: float = 0.0):
    """BERT's schedule: 0 -> ``base_lr`` linearly over ``warmup_steps``,
    then linearly to ``end_fraction * base_lr`` at ``total_steps`` (flat
    after).  Computed in float32 with the reference's operation order, so
    the values are the reference's to the bit."""
    def schedule(step):
        step = _F32(step)
        warm = step / np.maximum(_F32(warmup_steps), _F32(1.0))
        frac = (step - _F32(warmup_steps)) \
            / np.maximum(_F32(total_steps - warmup_steps), _F32(1.0))
        decay = _F32(1.0) - _F32(1.0 - end_fraction) \
            * np.clip(frac, _F32(0.0), _F32(1.0))
        return _F32(base_lr) * (warm if step < warmup_steps else decay)
    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  end_fraction: float = 0.0):
    """Linear warmup to ``base_lr``, then a cosine decay to ``end_fraction
    * base_lr`` at ``total_steps`` (flat after), in float32 with the
    reference's operation order.  The cosine is the float64 one rounded
    to float32; XLA's float32 cosine is not correctly rounded, so the
    two differ by an ulp at some steps."""
    def schedule(step):
        step = _F32(step)
        warm = step / np.maximum(_F32(warmup_steps), _F32(1.0))
        frac = np.clip((step - _F32(warmup_steps))
                       / np.maximum(_F32(total_steps - warmup_steps),
                                    _F32(1.0)), _F32(0.0), _F32(1.0))
        decay = _F32(end_fraction) + _F32((1.0 - end_fraction) * 0.5) \
            * (_F32(1.0) + _F32(np.cos(np.float64(_F32(np.pi) * frac))))
        return _F32(base_lr) * (warm if step < warmup_steps else decay)
    return schedule


def exponential_decay(base_lr, step, batch_size, decay_steps, rate,
                      staircase=True):
    """``tf.train.exponential_decay(base_lr, step * batch_size,
    decay_steps, rate, staircase)`` in float32 (see the module note on
    the power)."""
    progress = _F32(step) * _F32(batch_size) / _F32(decay_steps)
    if staircase:
        progress = np.floor(progress)
    power = np.power(np.float64(_F32(rate)), np.float64(progress))
    return _F32(base_lr) * _F32(power)


def reference_schedule(config, local_train_size: int):
    """The reference's LR schedule, ``step -> float32 LR``, over a run's
    local train size (one decay per local epoch)."""
    def schedule(step):
        return exponential_decay(config.base_lr, step, config.batch_size,
                                 local_train_size, config.lr_decay,
                                 staircase=True)
    return schedule


@dataclasses.dataclass
class MomentumState:
    velocity: list                # one per parameter, in parameter order
    step: np.float32 = _F32(0.0)  # the reference's float32 ``iter_``


def momentum_init(params: list) -> MomentumState:
    return MomentumState([torch.zeros_like(p) for p in params], _F32(0.0))


@torch.no_grad()
def momentum_apply(params: list, grads: list, state: MomentumState, lr,
                   momentum: float = 0.9) -> None:
    """One TF ``MomentumOptimizer`` update in place: ``v = m*v + g; p -=
    lr*v`` (each product rounded before its sum, as in the reference),
    then ``state.step += 1``.  ``lr``: a float32 number, or a 0-d tensor
    on the parameters' device (a ``StepTable`` read)."""
    torch._foreach_mul_(state.velocity, momentum)
    torch._foreach_add_(state.velocity, grads)
    torch._foreach_sub_(params, torch._foreach_mul(
        state.velocity, lr if torch.is_tensor(lr) else float(lr)))
    state.step = _F32(state.step + _F32(1.0))


def _decayable(name: str, leaf) -> bool:
    if name in ("scale", "bias") or name.endswith("_b") \
            or _BIAS_NAME.match(name):
        return False
    return leaf.ndim >= 2


def decay_mask(tree):
    """The BERT-recipe weight-decay mask, by leaf NAME: decay weight
    matrices; skip LayerNorm ``scale``/``bias``, every bias (``b``,
    ``bq`` ... ``b2``, ``eb1``, ``xbq``, ``*_b``) and every leaf under 2
    dimensions.  Returns the tree with a bool at each leaf."""
    return tree_lib.map_leaves(
        lambda path, leaf: _decayable(tree_lib.leaf_name(path), leaf), tree)


@dataclasses.dataclass
class AdamWState:
    count: int                    # updates applied (optax's int32 count)
    mu: list                      # first moments, one per leaf
    nu: list                      # second moments, one per leaf


@dataclasses.dataclass
class MasterOpt:
    """Mixed-precision optimizer state (the reference's ``MasterOpt``):
    float32 master copies of the live parameters, one per leaf in the
    parameter tree's order, and the inner optimizer's state, which
    lives on the masters."""
    master: list
    inner: AdamWState


@dataclasses.dataclass(frozen=True)
class TransformerTx:
    """clip_by_global_norm then adamw or lamb, over a parameter tree's
    leaves."""
    lr: object                    # schedule: step -> float32 LR
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0   # 0 disables clipping
    optimizer: str = "adamw"      # "adamw" | "lamb"
    # device -> StepTable of (lr, 1 - B1 ** c, 1 - B2 ** c) at count c - 1
    tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def table(self, device) -> StepTable:
        """The per-step LR and bias corrections on ``device``."""
        device = torch.device(device)
        if device not in self.tables:
            self.tables[device] = StepTable(
                (lambda c: self.lr(c), lambda c: 1 - B1 ** (c + 1),
                 lambda c: 1 - B2 ** (c + 1)), device)
        return self.tables[device]

    def init(self, tree) -> AdamWState:
        leaves = tree_lib.leaves(tree)
        return AdamWState(0, [torch.zeros_like(p) for p in leaves],
                          [torch.zeros_like(p) for p in leaves])

    @torch.no_grad()
    def update(self, tree, grads: list, state: AdamWState,
               sharded=None) -> None:
        """One update of every leaf of ``tree`` in place from ``grads``
        (one per leaf, in ``tree``'s leaf order); ``state.count``
        advances by one.

        ``sharded`` (one entry per leaf: None or False, True, or a
        ``parallel.mesh.Axis``) marks the leaves that are this rank's
        block of a parameter sharded over the world (True) or over that
        axis (``train.gspmd``'s zero1, fsdp and model axis): their
        squares are summed over it for the global norm and for lamb's
        per-leaf norms, while every other leaf is whole on every rank
        and counted once.  The rest of the update is elementwise and runs on a slice
        as on a whole leaf."""
        named = tree_lib.named_leaves(tree)
        params = [p for _, p in named]
        grads = list(grads)
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            norm = global_norm(grads, sharded)
            factor = torch.where(norm < self.grad_clip_norm,
                                 torch.ones_like(norm),
                                 self.grad_clip_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        lr, bc1, bc2 = self.table(params[0].device).read(state.count)
        state.count += 1
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, grads, alpha=1 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - B2)
        mu_hat = torch._foreach_div(state.mu, bc1)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        lamb = self.optimizer == "lamb"
        torch._foreach_add_(denom, LAMB_EPS if lamb else EPS)
        u = torch._foreach_div(mu_hat, denom)
        decay = [i for i, (name, p) in enumerate(named)
                 if _decayable(name, p)]
        if self.weight_decay and decay:
            torch._foreach_add_([u[i] for i in decay],
                                [params[i] for i in decay],
                                alpha=self.weight_decay)
        if lamb:
            torch._foreach_mul_(u, trust_ratios(params, u, sharded))
        torch._foreach_mul_(u, lr)                  # optax: -lr * u, added
        torch._foreach_sub_(params, u)


def _by_axis(sharded) -> list:
    """``[(axis, leaf indices)]`` of the leaves ``sharded`` marks: an
    ``Axis`` (their squares summed over it), or True (the world)."""
    groups = {}
    for i, s in enumerate(sharded or ()):
        if s is None or s is False:
            continue
        axis = None if s is True else s
        key = None if axis is None else axis.names
        groups.setdefault(key, (axis, []))[1].append(i)
    return list(groups.values())


def _sum_sq(norms: list, sharded) -> torch.Tensor:
    """The squares of per-leaf ``norms``, each leaf ``sharded`` marks
    summed over its axis in one all-reduce per axis (a whole leaf keeps
    its own value).  Nothing is copied from the host, so a graph can
    capture it."""
    sq = torch.stack(norms).square()
    groups = _by_axis(sharded)
    if not groups:
        return sq
    out = list(sq.unbind())
    for axis, marked in groups:
        summed = collectives.allreduce_sum(
            torch.stack([sq[i] for i in marked]), axis)
        for j, i in enumerate(marked):
            out[i] = summed[j]
    return torch.stack(out)


def trust_ratios(params: list, updates: list, sharded=None) -> list:
    """LAMB's per-leaf ``|p| / |u|`` (optax's ``scale_by_trust_ratio``),
    1 where either norm is 0; a sharded leaf's norms are its whole
    leaf's."""
    n = len(params)
    sq = _sum_sq(torch._foreach_norm(params) + torch._foreach_norm(updates),
                 None if sharded is None else list(sharded) * 2)
    norms = torch.sqrt(sq)
    p, u = norms[:n], norms[n:]
    ratio = torch.where((p == 0) | (u == 0), torch.ones_like(p), p / u)
    return list(ratio.unbind())


def global_norm(grads: list, sharded=None) -> torch.Tensor:
    """optax's ``global_norm``: the square root of every gradient's sum
    of squares.  The leaves ``sharded`` marks are blocks of leaves split
    over an axis (an ``Axis``, or True for the world): their part is
    all-reduced over it, the rest (whole on every rank) added once."""
    norms = torch._foreach_norm(grads)
    groups = _by_axis(sharded)
    if not groups:
        return torch.linalg.vector_norm(torch.stack(norms))
    marked = {i for _, idx in groups for i in idx}
    whole = [n for i, n in enumerate(norms) if i not in marked]
    total = torch.stack(whole).square().sum() if whole \
        else torch.zeros((), device=norms[0].device)
    for axis, idx in groups:
        total = total + collectives.allreduce_sum(
            torch.stack([norms[i] for i in idx]).square().sum(), axis)
    return torch.sqrt(total)


def transformer_tx(base_lr: float, num_steps: int, *,
                   schedule: str = "warmup_linear",
                   warmup_fraction: float = 0.1,
                   weight_decay: float = 0.01,
                   grad_clip_norm: float = 1.0,
                   optimizer: str = "adamw") -> TransformerTx:
    """The transformer-family optimizer (``"adamw"`` or ``"lamb"``) under
    the named schedule (``"warmup_linear"``, ``"warmup_cosine"`` or
    ``"constant"``), with the reference's defaults: warmup over 10 % of
    the steps, weight decay 0.01, global norm clipped at 1.0."""
    warmup = max(1, int(warmup_fraction * num_steps))
    if schedule == "constant":
        lr = constant(base_lr)
    elif schedule == "warmup_linear":
        lr = warmup_linear(base_lr, warmup, num_steps)
    elif schedule == "warmup_cosine":
        lr = warmup_cosine(base_lr, warmup, num_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if optimizer not in ("adamw", "lamb"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return TransformerTx(lr, weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm, optimizer=optimizer)
