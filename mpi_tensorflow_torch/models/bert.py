"""Transformer geometry and the shared per-layer math.

Counterpart of ``mpi_tensorflow_tpu/models/bert.py`` for the pieces the
serving forward needs: ``BertConfig`` with its ``BERT_BASE`` and
``BERT_TINY`` presets, the seeded parameter init, and the layer math
(``qkv_proj``, ``attn_out_proj``, ``gelu_mlp``, the LayerNorm,
``rope`` and the LM head's ``head_hidden``) as ``nn.Module``s.
``BertMlm``'s training machinery comes with the training slices.

Parameters keep the JAX layouts — ``wq/wk/wv`` (E, H, D), ``wo``
(H, D, E), ``w1`` (E, F), ``w2`` (F, E), ``tok_emb`` (V, E) — so the
einsums below read like the reference's.  The reference casts each
matmul weight and bias to the compute dtype at every use
(``w.astype(dt)``); a cast is deterministic, so the modules store those
tensors in the compute dtype once, at construction, and the per-use
``.to(dt)`` below is a no-op.  LayerNorm parameters stay float32, as
their use in the reference promotes to float32.

Two numerics traps the reference sets, kept here on purpose:

- GELU is the TANH approximation (``jax.nn.gelu``'s default); torch's
  ``F.gelu`` defaults to exact erf, so ``approximate="tanh"`` is passed.
- LayerNorm uses eps 1e-12 and the population variance, computed in
  the input's dtype and promoted to float32 by the float32 scale, as
  ``jnp`` does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp: int = 3072
    max_positions: int = 512
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32   # compute dtype
    pos_kind: str = "learned"            # "learned" absolute embeddings
                                         # or "rope" rotary on q/k

    def __post_init__(self):
        if self.pos_kind not in ("learned", "rope"):
            raise ValueError(f"pos_kind must be 'learned' or 'rope', "
                             f"got {self.pos_kind!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4, mlp=128,
                       max_positions=128, dropout=0.0)


def init_params(cfg: BertConfig, generator: torch.Generator) -> dict:
    """Seeded float32 parameters in the reference's pytree layout (a
    nested dict; ``layers`` is a list).  Weights are a normal draw
    times 0.02, biases zero, LayerNorm scales one — the reference's
    ``_norm_init``.  Draws come from ``generator`` on the CPU, so one
    seed gives the same weights whatever device they are moved to."""
    c = cfg

    def normal(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    def ln():
        return {"scale": torch.ones(c.hidden), "bias": torch.zeros(c.hidden)}

    params = {
        "tok_emb": normal(c.vocab_size, c.hidden),
        "pos_emb": normal(c.max_positions, c.hidden),
        "emb_ln": ln(),
        "layers": [],
        "mlm": {"w": normal(c.hidden, c.hidden), "b": torch.zeros(c.hidden),
                "ln": ln(), "out_b": torch.zeros(c.vocab_size)},
    }
    H, D = c.heads, c.head_dim
    for _ in range(c.layers):
        params["layers"].append({
            "wq": normal(c.hidden, H, D), "wk": normal(c.hidden, H, D),
            "wv": normal(c.hidden, H, D),
            "bq": torch.zeros(H, D), "bk": torch.zeros(H, D),
            "bv": torch.zeros(H, D),
            "wo": normal(H, D, c.hidden), "bo": torch.zeros(c.hidden),
            "ln1": ln(),
            "w1": normal(c.hidden, c.mlp), "b1": torch.zeros(c.mlp),
            "w2": normal(c.mlp, c.hidden), "b2": torch.zeros(c.hidden),
            "ln2": ln(),
        })
    return params


def _param(t, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(t).to(dtype), requires_grad=False)


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding of ``x`` (B, H, S, D) at ABSOLUTE
    ``positions``: (S,) shared, or (B, S) per row (the paged path, where
    every sequence sits at its own offset).  Angles in float32, output
    in x's dtype; D must be even."""
    D = x.shape[-1]
    half = D // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs   # (..., S, half)
    if positions.ndim == 2:
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    else:
        cos, sin = torch.cos(ang)[None, None], torch.sin(ang)[None, None]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


class LayerNorm(nn.Module):
    """The reference's ``_layernorm`` (eps 1e-12, population variance in
    the input's dtype; the float32 scale/bias promote the result to
    float32 — callers cast back to the compute dtype)."""

    def __init__(self, p: dict, eps: float = 1e-12):
        super().__init__()
        self.scale = _param(p["scale"], torch.float32)
        self.bias = _param(p["bias"], torch.float32)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


class EncoderLayer(nn.Module):
    """One transformer layer's parameters and its shared math; the
    attention between ``qkv_proj`` and ``attn_out_proj`` is the
    caller's (``models/gpt`` routes it to the paged-attention ops)."""

    def __init__(self, lp: dict, dt: torch.dtype):
        super().__init__()
        for name in ("wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo",
                     "w1", "b1", "w2", "b2"):
            setattr(self, name, _param(lp[name], dt))
        self.ln1 = LayerNorm(lp["ln1"])
        self.ln2 = LayerNorm(lp["ln2"])

    def qkv_proj(self, h: torch.Tensor, dt: torch.dtype):
        """(B, S, E) -> per-head q, k, v, each (B, H, S, D)."""
        def proj(w, b):
            return (torch.einsum("bse,ehd->bhsd", h, w.to(dt))
                    + b.to(dt)[None, :, None, :])
        return (proj(self.wq, self.bq), proj(self.wk, self.bk),
                proj(self.wv, self.bv))

    def attn_out_proj(self, a: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Attention output projection: (B, H, S, D) -> (B, S, E)."""
        return torch.einsum("bhsd,hde->bse", a, self.wo.to(dt)) \
            + self.bo.to(dt)

    def gelu_mlp(self, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Position-wise tanh-GELU MLP."""
        m = F.gelu(h @ self.w1.to(dt) + self.b1.to(dt), approximate="tanh")
        return m @ self.w2.to(dt) + self.b2.to(dt)


class LmHead(nn.Module):
    """The MLM/LM head: dense + tanh-GELU + LayerNorm (``head_hidden``)
    feeding the vocab decoder tied to the token embedding, plus the
    float32 output bias."""

    def __init__(self, p: dict, dt: torch.dtype):
        super().__init__()
        self.w = _param(p["w"], dt)
        self.b = _param(p["b"], dt)
        self.ln = LayerNorm(p["ln"])
        self.out_b = _param(p["out_b"], torch.float32)

    def head_hidden(self, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        t = F.gelu(h @ self.w.to(dt) + self.b.to(dt), approximate="tanh")
        return self.ln(t).to(dt)
