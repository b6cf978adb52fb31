"""Mixture-of-Experts BERT: capacity-routed expert MLPs.

Counterpart of ``MoeConfig`` and ``MoeBertMlm`` in
``mpi_tensorflow_tpu/models/moe.py`` (its ``PipelinedMoeBertMlm`` waits
for the pipeline, ROADMAP Queue 1 item 14d).  The encoder, dropout,
remat, MLM head and loss are ``models/bert.BertMlm``'s; only the MLP of
every other layer (odd layers under ``every_other``) is routed:

- ``capacity(N)``: an expert's buffer, ``ceil(cf * N / experts)``
  rounded up to a multiple of 8, at least 8;
- ``route``: top-1 (Switch) takes each token's argmax expert (the first
  maximum, as ``jnp.argmax``) and its slot in that expert's buffer from
  a cumulative count in token order; a token past capacity goes to the
  overflow row ``X * C``, whose output is never read, so its MLP output
  is zero and the residual carries it.  Top-2 (GShard) adds the second
  choice, placed after the first choices the expert kept, and weighs
  the two outputs by their gates normalised over the pair;
- the expert products are batched matmuls over the expert axis
  (``torch.einsum``), as XLA computes them in the reference;
- the Switch load-balance loss ``X * sum(frac_tokens * mean_gate)``
  over first choices, added to the MLM loss at ``aux_loss_weight``.

The parameters keep the reference's tree: an MoE layer has ``router``
(E, X), ``ew1`` (X, E, F), ``eb1`` (X, F), ``ew2`` (X, F, E) and ``eb2``
(X, E) instead of ``w1``, ``b1``, ``w2``, ``b2``.  Under a data axis each
rank routes its own rows (the reference routes the global batch:
ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from mpi_tensorflow_torch.models import bert as bert_lib


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    num_experts: int = 4
    top_k: int = 1                 # 1 = Switch; 2 = GShard-style
    capacity_factor: float = 1.25  # expert buffer = cf * tokens / experts
    aux_loss_weight: float = 0.01
    every_other: bool = True       # MoE on odd layers, dense on even

    def __post_init__(self):
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 (Switch) or 2 (GShard), "
                             f"got {self.top_k}")


def is_moe_layer(moe: MoeConfig, idx: int) -> bool:
    """Whether layer ``idx`` routes its MLP: the odd layers under
    ``every_other``, else all."""
    return idx % 2 == 1 if moe.every_other else True


def capacity(moe: MoeConfig, num_tokens: int) -> int:
    """Per-expert buffer length: ``cf * tokens / experts`` rounded up to
    a multiple of 8 and at least 8."""
    c = math.ceil(moe.capacity_factor * num_tokens / moe.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def _positions(onehot: torch.Tensor) -> torch.Tensor:
    """Each token's slot in its expert's buffer: how many tokens before
    it, itself included, chose the same expert, less one.  The count
    runs along rows of the (X, N) transpose: a scan down the N rows of
    the (N, X) one-hot runs only X wide on the card (2.65 ms a call at
    N = 16384 on an H100, ``PERF.md``)."""
    per_expert = onehot.t().contiguous()
    return (torch.cumsum(per_expert, 1) * per_expert).sum(0) - 1


def route(gates: torch.Tensor, cap: int, top_k: int) -> list:
    """``[(slot, keep, weight)]`` per choice for float32 ``gates`` (N,
    X): ``slot`` (N,) int64 rows of the (X * C + 1, E) buffer (``X * C``
    for a dropped token), ``keep`` (N,) bool, ``weight`` (N,) float32."""
    X = gates.shape[-1]
    top1 = torch.argmax(gates, -1)
    gate1 = torch.gather(gates, 1, top1[:, None])[:, 0]
    onehot1 = F.one_hot(top1, X).to(torch.int32)
    pos1 = _positions(onehot1)
    keep1 = pos1 < cap
    slot1 = torch.where(keep1, top1 * cap + pos1, X * cap)
    if top_k == 1:
        return [(slot1, keep1, gate1)]
    g2 = gates - gates * F.one_hot(top1, X).to(gates.dtype)
    top2 = torch.argmax(g2, -1)
    gate2 = torch.gather(g2, 1, top2[:, None])[:, 0]
    onehot2 = F.one_hot(top2, X).to(torch.int32)
    occupancy1 = torch.clamp(onehot1.sum(0), max=cap)
    pos2 = _positions(onehot2) + occupancy1[top2]
    keep2 = pos2 < cap
    slot2 = torch.where(keep2, top2 * cap + pos2, X * cap)
    denom = torch.clamp(gate1 + gate2, min=1e-9)
    return [(slot1, keep1, gate1 / denom), (slot2, keep2, gate2 / denom)]


class MoeLayer(bert_lib.EncoderLayer):
    """An encoder layer whose MLP is the routed experts."""

    NAMES = ("wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo", "router",
             "ew1", "eb1", "ew2", "eb2")

    def __init__(self, lp: dict, dt: torch.dtype, moe: MoeConfig,
                 trainable: bool = True):
        super().__init__(lp, dt, trainable)
        self.moe = moe

    def mlp_block(self, h, dt, reduce=None):
        """(B, S, E) -> ``(out, aux)``: the capacity-routed expert MLP
        and the load-balance loss (float32).  No caller passes
        ``reduce``: the experts are not tensor-parallel (ROADMAP Queue 1
        item 14c)."""
        X = self.moe.num_experts
        B, S, E = h.shape
        N = B * S
        C = capacity(self.moe, N)
        hf = h.reshape(N, E)
        gates = torch.softmax(torch.einsum(
            "ne,ec->nc", hf, self.router.to(dt)).to(torch.float32), -1)
        routes = route(gates, C, self.moe.top_k)
        # dispatch: every kept slot is written once; the overflow row
        # X*C takes the dropped tokens and is cut off below
        buf = hf.new_zeros(X * C + 1, E)
        for slot, _, _ in routes:
            buf = buf.index_put((slot,), hf)
        xin = buf[:X * C].reshape(X, C, E)
        a = F.gelu(torch.einsum("xce,xef->xcf", xin, self.ew1.to(dt))
                   + self.eb1.to(dt)[:, None, :], approximate="tanh")
        xout = torch.einsum("xcf,xfe->xce", a, self.ew2.to(dt)) \
            + self.eb2.to(dt)[:, None, :]
        flat = torch.cat([xout.reshape(X * C, E), xout.new_zeros(1, E)])
        out = hf.new_zeros(N, E)
        for slot, keep, w in routes:
            out = out + flat[slot] * (w * keep)[:, None].to(dt)
        # what the last forward dropped, for ``MoeBertMlm.dropped_share``
        self.dropped = sum((~keep).sum() for _, keep, _ in routes).detach()
        self.routed = N * len(routes)
        frac = F.one_hot(torch.argmax(gates, -1), X).to(torch.float32).mean(0)
        aux = X * (frac * gates.mean(0)).sum()
        return out.reshape(B, S, E), aux


class MoeBertMlm(bert_lib.BertMlm):
    """BERT-MLM with routed expert MLPs on the MoE layers; the
    load-balance loss joins the MLM loss at ``moe.aux_loss_weight``."""

    mesh_item = "14c (the expert axis and tensor-parallel experts)"

    def __init__(self, cfg: bert_lib.BertConfig, params: dict,
                 attention: str = "auto", moe: MoeConfig = MoeConfig(),
                 mesh=None):
        self.moe = moe
        super().__init__(cfg, params, attention, mesh=mesh)

    def _make_layer(self, idx: int, lp: dict):
        if is_moe_layer(self.moe, idx):
            return MoeLayer(lp, self.cfg.dtype, self.moe)
        return super()._make_layer(idx, lp)

    def aux_weight(self) -> float:
        return self.moe.aux_loss_weight

    @classmethod
    def init_params(cls, cfg: bert_lib.BertConfig, generator,
                    moe: MoeConfig = MoeConfig()) -> dict:
        """BERT's seeded tree with each MoE layer's dense MLP replaced by
        the router and the expert stacks (normal x 0.02, biases 0)."""
        params = bert_lib.init_params(cfg, generator)
        X = moe.num_experts

        def normal(*shape):
            return torch.randn(shape, generator=generator) * 0.02

        for i, lp in enumerate(params["layers"]):
            if not is_moe_layer(moe, i):
                continue
            for name in ("w1", "b1", "w2", "b2"):
                del lp[name]
            lp.update(router=normal(cfg.hidden, X),
                      ew1=normal(X, cfg.hidden, cfg.mlp),
                      eb1=torch.zeros(X, cfg.mlp),
                      ew2=normal(X, cfg.mlp, cfg.hidden),
                      eb2=torch.zeros(X, cfg.hidden))
        return params

    @classmethod
    def from_seed(cls, cfg: bert_lib.BertConfig, seed: int = 0,
                  attention: str = "auto",
                  moe: MoeConfig = MoeConfig(), mesh=None) -> "MoeBertMlm":
        gen = torch.Generator().manual_seed(seed)
        return cls(cfg, cls.init_params(cfg, gen, moe), attention, moe,
                   mesh=mesh)

    def dropped_share(self) -> float:
        """The share of routings (tokens x choices) over capacity in the
        MoE layers of the last forward: what the capacity factor cost
        that batch (reads the card once)."""
        layers = [layer for layer in self.layers if isinstance(layer, MoeLayer)]
        dropped = torch.stack([layer.dropped for layer in layers]).sum()
        return float(dropped) / sum(layer.routed for layer in layers)
