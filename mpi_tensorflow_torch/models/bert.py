"""BERT masked-LM: geometry, the shared per-layer math, and ``BertMlm``.

Counterpart of ``mpi_tensorflow_tpu/models/bert.py``: ``BertConfig``
with its ``BERT_BASE`` and ``BERT_TINY`` presets, ``ce_capacity``,
the seeded parameter init, the layer math
(``qkv_proj``, ``attn_out_proj``, ``gelu_mlp``, the LayerNorm, ``rope``
and the LM head's ``head_hidden``) as ``nn.Module``s, and ``BertMlm``
with ``encode``, ``head_hidden``, ``apply`` and ``loss`` for training
(``models/gpt.TrainableCausalLm`` adds the causal mask and the
next-token loss on top, ``models/moe`` routed expert MLPs through the
layer's ``mlp_block`` hook, ``models/encdec`` a decoder after the same
encoder).  ``BertMlm`` and the causal family run under the ``model``
and ``seq`` mesh axes (tensor and sequence parallelism: the class
note).

``cfg.remat`` recomputes each layer's activations in the backward
(``torch.utils.checkpoint``, non-reentrant; ``remat_policy`` "full"
saves nothing, "dots" saves the products without batch dimensions, the
weight projections, as ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable`` does).  A rematted layer keeps the
uniform draws of its dropout masks and recomputes the rest
(``run_layer``), so remat on and off use the same masks, and a CUDA
graph can capture it: no generator state is copied.

Parameters keep the JAX layouts — ``wq/wk/wv`` (E, H, D), ``wo``
(H, D, E), ``w1`` (E, F), ``w2`` (F, E), ``tok_emb`` (V, E) — so the
einsums below read like the reference's.  The reference keeps float32
leaves and casts each matmul weight and bias to the compute dtype at
every use (``w.astype(dt)``); its gradient flows back to float32.  The
layer modules do the same (``.to(dt)`` at each use) and store their
parameters one of two ways:

- ``trainable=True`` (``BertMlm``): float32 leaves with gradients, cast
  at each use exactly as the reference does;
- ``trainable=False`` (serving's ``CausalLm``): frozen copies already in
  the compute dtype — a cast is deterministic, so the per-use ``.to(dt)``
  is then a no-op and serving pays no cast per step.

LayerNorm parameters stay float32 either way, as their use in the
reference promotes to float32.

Two numerics traps the reference sets, kept here on purpose:

- GELU is the TANH approximation (``jax.nn.gelu``'s default); torch's
  ``F.gelu`` defaults to exact erf, so ``approximate="tanh"`` is passed.
- LayerNorm uses eps 1e-12 and the population variance, computed in
  the input's dtype and promoted to float32 by the float32 scale, as
  ``jnp`` does.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from mpi_tensorflow_torch.models.base import dropout_mask
from mpi_tensorflow_torch.ops import mlm_head
from mpi_tensorflow_torch.ops.flash_attention import flash_attention
from mpi_tensorflow_torch.parallel import collectives, sharding_rules
from mpi_tensorflow_torch.parallel.ring import dense_attention, ring_attention
from mpi_tensorflow_torch.parallel.ulysses import ulysses_attention
from mpi_tensorflow_torch.utils import tree as tree_lib

ATTENTION = ("auto", "flash", "dense")


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
    ce_impl: str = "auto"                # MLM loss: "dense" logits;
                                         # "chunked" = vocabulary tiles
                                         # (ops/mlm_head); "auto" =
                                         # chunked when every position
                                         # reaches the head
    ce_chunk: int = 2048                 # vocabulary tile of the chunked CE
    ce_positions: str = "masked"         # "masked": pack each row's masked
                                         # positions before the head;
                                         # "all": head over every position
    ce_capacity_frac: float = 0.25       # packed-buffer width / S
    flash_min_seq: int = 4096            # BertMlm's "auto" attention takes
                                         # the flash kernels at S >= this
                                         # (the reference's TPU threshold;
                                         # the card's own is not measured)
    remat: bool = False                  # recompute each layer in the
                                         # backward (module note)
    remat_policy: str = "full"           # what a rematted layer saves:
                                         # "full" nothing, "dots" the
                                         # products without batch dims
    fused_qkv: bool = False              # q, k, v from ONE (E, 3HD)
                                         # product on the stacked weights
                                         # (the leaves stay separate)
    sp_impl: str = "ring"                # attention over a seq axis:
                                         # "ring" (K/V hops, any head
                                         # count) or "ulysses" (two
                                         # all-to-alls, heads % seq == 0)

    def __post_init__(self):
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got "
                             f"{self.sp_impl!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.pos_kind not in ("learned", "rope"):
            raise ValueError(f"pos_kind must be 'learned' or 'rope', "
                             f"got {self.pos_kind!r}")
        if self.ce_positions not in ("masked", "all"):
            raise ValueError(f"ce_positions must be 'masked' or 'all', "
                             f"got {self.ce_positions!r}")
        if self.ce_impl not in ("auto", "dense", "chunked"):
            raise ValueError(f"ce_impl must be auto, dense or chunked, "
                             f"got {self.ce_impl!r}")

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


def ce_capacity(cfg: BertConfig, S: int) -> int:
    """Packed-buffer width for the masked-position head: ``ce_capacity_frac
    * S`` rounded up to a multiple of 8, floored at 8, capped at S."""
    return min(S, max(8, -(-int(cfg.ce_capacity_frac * S) // 8) * 8))


def _dots_policy(ctx, func, *args, **kwargs):
    """Save the products without batch dimensions: ``mm``/``addmm`` and a
    ``bmm`` of batch 1 (an einsum against a weight); recompute the rest,
    the attention's batched score and value products among them."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if func in (aten.mm.default, aten.addmm.default) or (
            func is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _full_policy(ctx, func, *args, **kwargs):
    """Recompute everything (``remat_policy`` "full")."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.PREFER_RECOMPUTE


def _keeping_draws(policy):
    """``policy`` with every random draw saved: the recomputation reads
    the forward's draws and leaves the generator where the forward left
    it."""
    from torch.utils.checkpoint import CheckpointPolicy

    def keep(ctx, func, *args, **kwargs):
        if torch.Tag.nondeterministic_seeded in func.tags:
            return CheckpointPolicy.MUST_SAVE
        return policy(ctx, func, *args, **kwargs)
    return keep


def run_layer(cfg: BertConfig, fn, h, generator, *args):
    """``fn(h, generator, *args)``, under ``cfg.remat`` (with gradients
    on) through ``torch.utils.checkpoint``: the layer's activations are
    recomputed in the backward, save the uniform draws of its dropout
    masks (and, under "dots", the weight products), which the
    recomputation reads back.  The masks are the forward's, and
    ``generator`` ends where the forward left it, as without remat.
    The saved draws are float32 tensors of the masked activations'
    shape, the memory remat keeps beside the layer's input."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(h, generator, *args)
    from torch.utils import checkpoint as ckpt

    policy = _dots_policy if cfg.remat_policy == "dots" else _full_policy
    return ckpt.checkpoint(
        lambda h, *a: fn(h, generator, *a), h, *args, use_reentrant=False,
        preserve_rng_state=False, context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _keeping_draws(policy)))


def _param(t, dtype: torch.dtype, trainable: bool = False) -> nn.Parameter:
    """A frozen copy in ``dtype``, or a float32 leaf with gradients."""
    if trainable:
        return nn.Parameter(torch.as_tensor(t).to(torch.float32).clone())
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

    def __init__(self, p: dict, eps: float = 1e-12, trainable: bool = False):
        super().__init__()
        self.scale = _param(p["scale"], torch.float32, trainable)
        self.bias = _param(p["bias"], torch.float32, trainable)
        self.eps = eps

    def tree(self) -> dict:
        return {"scale": self.scale, "bias": self.bias}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


class EncoderLayer(nn.Module):
    """One transformer layer's parameters and its shared math; the
    attention between ``qkv_proj`` and ``attn_out_proj`` is the
    caller's (``models/gpt`` routes it to the paged-attention ops,
    ``BertMlm`` to flash or dense attention)."""

    NAMES = ("wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo", "w1", "b1",
             "w2", "b2")

    def __init__(self, lp: dict, dt: torch.dtype, trainable: bool = False):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name, _param(lp[name], dt, trainable))
        self.ln1 = LayerNorm(lp["ln1"], trainable=trainable)
        self.ln2 = LayerNorm(lp["ln2"], trainable=trainable)

    def tree(self) -> dict:
        t = {name: getattr(self, name) for name in self.NAMES}
        t.update(ln1=self.ln1.tree(), ln2=self.ln2.tree())
        return t

    def forward(self, h: torch.Tensor, attention, dt: torch.dtype,
                drop=None, reduce=None, fused: bool = False) -> torch.Tensor:
        """The post-LN block around ``attention(q, k, v) -> (B, H, S,
        D)``; ``drop`` (training) is applied to the attention output and
        to the MLP output before each residual add; ``reduce`` is the
        tensor-parallel sum of the two row-parallel products
        (``serving/tp``); ``fused`` is ``qkv_proj``'s."""
        return self.forward_aux(h, attention, dt, drop, reduce, fused)[0]

    def forward_aux(self, h, attention, dt, drop=None, reduce=None,
                    fused: bool = False, enter=None):
        """``forward`` and the MLP's auxiliary loss (None for a dense
        MLP): ``(h, aux)``.  ``enter`` is applied to the input of each
        column-parallel product (training's tensor parallelism:
        ``collectives.copy_to``, whose backward sums the ranks' parts of
        the residual stream's gradient)."""
        x = h if enter is None else enter(h)
        q, k, v = self.qkv_proj(x, dt, fused)
        a = self.attn_out_proj(attention(q, k, v), dt, reduce)
        if drop is not None:
            a = drop(a)
        h = self.ln1(h + a).to(dt)
        m, aux = self.mlp_block(h if enter is None else enter(h), dt, reduce)
        if drop is not None:
            m = drop(m)
        return self.ln2(h + m).to(dt), aux

    def mlp_block(self, h, dt, reduce=None):
        """The position-wise MLP and its auxiliary loss: ``(out,
        None)`` here; ``models/moe.MoeLayer`` routes it through experts
        and returns the load-balance loss."""
        return self.gelu_mlp(h, dt, reduce), None

    def qkv_proj(self, h: torch.Tensor, dt: torch.dtype,
                 fused: bool = False):
        """(B, S, E) -> per-head q, k, v, each (B, H, S, D).  ``fused``
        stacks the three weights (and biases) at each call and runs one
        (E, 3HD) product, as the reference's ``qkv_proj(fused=True)``;
        the parameters stay three leaves."""
        if fused:
            w = torch.stack([self.wq, self.wk, self.wv]).to(dt)
            b = torch.stack([self.bq, self.bk, self.bv]).to(dt)
            qkv = torch.einsum("bse,cehd->cbhsd", h, w) \
                + b[:, None, :, None, :]
            return qkv[0], qkv[1], qkv[2]

        def proj(w, b):
            return (torch.einsum("bse,ehd->bhsd", h, w.to(dt))
                    + b.to(dt)[None, :, None, :])
        return (proj(self.wq, self.bq), proj(self.wk, self.bk),
                proj(self.wv, self.bv))

    def attn_out_proj(self, a: torch.Tensor, dt: torch.dtype,
                      reduce=None) -> torch.Tensor:
        """Attention output projection: (B, H, S, D) -> (B, S, E).
        ``reduce`` is applied to the product BEFORE the bias, so a
        tensor-parallel sum adds the bias once."""
        out = torch.einsum("bhsd,hde->bse", a, self.wo.to(dt))
        if reduce is not None:
            out = reduce(out)
        return out + self.bo.to(dt)

    def gelu_mlp(self, h: torch.Tensor, dt: torch.dtype,
                 reduce=None) -> torch.Tensor:
        """Position-wise tanh-GELU MLP; ``reduce`` as in
        ``attn_out_proj``, on the down-projection before its bias."""
        m = F.gelu(h @ self.w1.to(dt) + self.b1.to(dt), approximate="tanh")
        out = m @ self.w2.to(dt)
        if reduce is not None:
            out = reduce(out)
        return out + self.b2.to(dt)


class LmHead(nn.Module):
    """The MLM/LM head: dense + tanh-GELU + LayerNorm (``head_hidden``)
    feeding the vocab decoder tied to the token embedding, plus the
    float32 output bias."""

    def __init__(self, p: dict, dt: torch.dtype, trainable: bool = False):
        super().__init__()
        self.w = _param(p["w"], dt, trainable)
        self.b = _param(p["b"], dt, trainable)
        self.ln = LayerNorm(p["ln"], trainable=trainable)
        self.out_b = _param(p["out_b"], torch.float32, trainable)

    def tree(self) -> dict:
        return {"w": self.w, "b": self.b, "ln": self.ln.tree(),
                "out_b": self.out_b}

    def head_hidden(self, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        t = F.gelu(h @ self.w.to(dt) + self.b.to(dt), approximate="tanh")
        return self.ln(t).to(dt)


def takes_flash(q, cfg: BertConfig, attention: str = "auto",
                seq_len=None) -> bool:
    """Whether ``attention`` takes the flash kernels: always for
    ``"flash"``; for ``"auto"`` on CUDA tensors at ``seq_len`` (default:
    q's) ``>= cfg.flash_min_seq``; never for ``"dense"``."""
    S = q.shape[2] if seq_len is None else seq_len
    return attention == "flash" or (
        attention == "auto" and q.device.type == "cuda"
        and S >= cfg.flash_min_seq)


def attend(q, k, v, cfg: BertConfig, attention: str = "auto",
           causal: bool = False):
    """One layer's attention by ``attention`` (``BertMlm``'s note): the
    flash kernels where ``takes_flash``, ``dense_attention`` otherwise."""
    if takes_flash(q, cfg, attention):
        return flash_attention(q, k, v, causal)
    return dense_attention(q, k, v, causal=causal)


class BertMlm(nn.Module):
    """BERT masked-LM for training: float32 trainable leaves in the
    reference's tree, computed in ``cfg.dtype``.

    ``attention`` picks the attention of every layer (the reference's
    ``_attention``):

    - ``"auto"`` — the flash kernels for CUDA tensors at ``S >=
      cfg.flash_min_seq``, ``dense_attention`` otherwise (always on the
      CPU, as the reference is dense off the TPU);
    - ``"flash"`` — ``flash_attention`` at any S (its plain version for
      CPU tensors);
    - ``"dense"`` — ``dense_attention`` at any S.

    ``mesh`` (``parallel.mesh.Mesh``) lays the model out as the
    reference's rules do (``logical_axes``, ``sharding_rules``): the
    constructor takes the WHOLE parameters and keeps this rank's block.

    - ``model`` axis (Megatron): ``wq/wk/wv/bq/bk/bv`` and ``w1/b1``
      column-parallel over the local heads and MLP width, ``wo``/``w2``
      row-parallel (``collectives.reduce_from`` before the bias, the
      input through ``copy_to``); the embedding vocabulary-parallel (a
      masked lookup and a sum); the tied decoder's logits sharded over
      the vocabulary, the CE's max, sum and gold logit taken over the
      axis (``_ce``), the argmax too (``vocab_argmax``: the lowest global
      index among ties, as ``argmax``).  ``ce_impl="auto"`` takes the
      dense CE when the vocabulary is sharded (the reference's rule);
    - ``seq`` axis: ``tokens`` are this rank's contiguous block of each
      row; positions are global (``pos_emb`` and ``rope`` at ``seq_index
      * S_local``); each layer's attention is ``ring_attention`` or, by
      ``cfg.sp_impl``, ``ulysses_attention``, whose inner attention is
      the flash kernels where ``takes_flash`` holds at the FULL length
      (the reference captures it before the split).  The MLM loss packs
      the masked positions of whole rows: ``h`` is gathered over the
      axis (``gather_from``), packed at ``ce_capacity`` of the full
      length as the reference packs, and each rank takes an equal part
      of the packed rows to the head;
    - ``data``: nothing here (``train.gspmd`` reduces over it).

    ``causal`` (a subclass's, ``models/gpt.TrainableCausalLm``) masks
    every layer's attention to the keys at or before each query, on
    every route.  The loss's CE over the vocabulary (``_ce``) is the
    dense (B, P, V) logits or the chunked ``mlm_head.tied_softmax_ce``
    by ``cfg.ce_impl`` (``_use_chunked_ce``).  ``loss_terms`` gives the
    loss's numerator and the layers' summed auxiliary loss, which
    ``loss`` adds at ``aux_weight()`` (0 here; the MoE's 0.01).
    """

    causal = False
    # the ROADMAP item a family waits for under the model or seq axis
    # (None: it runs there)
    mesh_item = None

    def __init__(self, cfg: BertConfig, params: dict, attention: str = "auto",
                 mesh=None):
        super().__init__()
        if attention not in ATTENTION:
            raise ValueError(f"attention must be one of {ATTENTION}, got "
                             f"{attention!r}")
        self.cfg = cfg
        self.attention = attention
        self.mesh = mesh
        size = (lambda a: mesh.axis_size(a)) if mesh is not None \
            else (lambda a: 1)
        self.tp = mesh.group("model") if size("model") > 1 else None
        self.sp = mesh.group("seq") if size("seq") > 1 else None
        if (self.tp or self.sp) and self.mesh_item:
            raise NotImplementedError(
                f"{type(self).__name__} under the model or seq mesh axis "
                f"(mesh {dict(mesh)}) is not ported yet: ROADMAP Queue 1 "
                f"item {self.mesh_item}")
        if self.tp is not None:
            params = sharding_rules.shard_tree(params, self.logical_axes(),
                                               mesh)
        f32 = torch.float32
        self.tok_emb = _param(params["tok_emb"], f32, trainable=True)
        self.pos_emb = _param(params["pos_emb"], f32, trainable=True)
        self.emb_ln = LayerNorm(params["emb_ln"], trainable=True)
        self.layers = nn.ModuleList(
            self._make_layer(i, lp) for i, lp in enumerate(params["layers"]))
        self._init_head(params)

    def _make_layer(self, idx: int, lp: dict) -> EncoderLayer:
        """Encoder layer ``idx`` from its parameters (``models/moe``
        makes its expert layers here)."""
        return EncoderLayer(lp, self.cfg.dtype, trainable=True)

    def _init_head(self, params: dict) -> None:
        """The parameters after the encoder: the MLM head here."""
        self.mlm = LmHead(params["mlm"], self.cfg.dtype, trainable=True)

    @classmethod
    def init_params(cls, cfg: BertConfig, generator) -> dict:
        """Seeded parameters in the family's tree."""
        return init_params(cfg, generator)

    @classmethod
    def from_seed(cls, cfg: BertConfig, seed: int = 0,
                  attention: str = "auto", mesh=None) -> "BertMlm":
        """Random weights from ``seed`` (``init_params`` on a CPU
        ``torch.Generator``); under ``mesh`` this rank's block of
        them."""
        gen = torch.Generator().manual_seed(seed)
        return cls(cfg, cls.init_params(cfg, gen), attention, mesh=mesh)

    def logical_axes(self) -> dict:
        """The tree (``param_tree``'s nesting) of each leaf's logical
        axes, the reference's ``BertMlm.logical_axes``."""
        ln = {"scale": ("embed",), "bias": ("embed",)}
        layer = {"wq": ("embed", "heads", "head_dim"),
                 "wk": ("embed", "heads", "head_dim"),
                 "wv": ("embed", "heads", "head_dim"),
                 "bq": ("heads", "head_dim"), "bk": ("heads", "head_dim"),
                 "bv": ("heads", "head_dim"),
                 "wo": ("heads", "head_dim", "embed"), "bo": ("embed",),
                 "w1": ("embed", "mlp"), "b1": ("mlp",),
                 "w2": ("mlp", "embed"), "b2": ("embed",)}
        return {"tok_emb": ("vocab", "embed"), "pos_emb": ("pos", "embed"),
                "emb_ln": ln,
                "layers": [dict(layer, ln1=ln, ln2=ln)
                           for _ in range(self.cfg.layers)],
                "mlm": {"w": ("embed", "embed"), "b": ("embed",), "ln": ln,
                        "out_b": ("vocab",)}}

    def leaf_specs(self) -> list:
        """Each parameter leaf's spec (``sharding_rules.spec_for``), in
        ``param_tree``'s leaf order; every spec empty without a model
        axis."""
        n = len(tree_lib.leaves(self.param_tree()))
        if self.tp is None:
            return [()] * n
        return tree_lib.leaves(sharding_rules.tree_specs(
            self.logical_axes(), self.mesh))

    def param_tree(self) -> dict:
        """The parameters in the reference's pytree layout (nested dicts,
        ``layers`` a list) — what the optimizer's decay mask and
        ``convert.params_to_numpy`` walk.  Under a model axis, this
        rank's blocks."""
        return {"tok_emb": self.tok_emb, "pos_emb": self.pos_emb,
                "emb_ln": self.emb_ln.tree(),
                "layers": [layer.tree() for layer in self.layers],
                "mlm": self.mlm.tree()}

    def _seq_offset(self, S_local: int) -> int:
        """The global position of this rank's first token."""
        return 0 if self.sp is None else self.sp.index * S_local

    def _attention(self, q, k, v, causal=None):
        """Self-attention of one layer, causal as the model (or as
        ``causal`` says: the enc-dec decoder's); over the seq axis by
        ``cfg.sp_impl``."""
        causal = self.causal if causal is None else causal
        if self.sp is None:
            return attend(q, k, v, self.cfg, self.attention, causal)
        if self.cfg.sp_impl == "ulysses":
            full = q.shape[2] * self.sp.size
            flash = takes_flash(q, self.cfg, self.attention, full)
            inner = flash_attention if flash else None
            return ulysses_attention(q, k, v, self.sp, causal=causal,
                                     inner=inner)
        return ring_attention(q, k, v, self.sp, causal=causal)

    def _dropout_generator(self, train: bool, generator):
        """The generator dropout draws from: ``generator`` in train mode
        with ``cfg.dropout > 0``, else None (no dropout)."""
        if not (train and self.cfg.dropout > 0.0):
            return None
        if generator is None:
            raise ValueError("dropout needs a generator in train mode")
        return generator

    def _embed(self, tokens):
        """The token embedding of ``tokens``; under a model axis each
        rank looks up its vocabulary rows (zero elsewhere) and the
        ranks' rows are summed."""
        if self.tp is None:
            return F.embedding(tokens.long(), self.tok_emb)
        rows = self.tok_emb.shape[0]
        local = tokens.long() - self.tp.index * rows
        mine = (local >= 0) & (local < rows)
        h = F.embedding(local.clamp(0, rows - 1), self.tok_emb) \
            * mine[..., None]
        return collectives.reduce_from(h, self.tp)

    def _tp_hooks(self):
        """``(enter, reduce)`` of the layers' products under a model
        axis, else ``(None, None)``."""
        if self.tp is None:
            return None, None
        return (functools.partial(collectives.copy_to, axis=self.tp),
                functools.partial(collectives.reduce_from, axis=self.tp))

    def encode(self, tokens, *, train: bool = False, generator=None):
        """Embeddings + encoder stack: ``tokens`` (B, S) int ids ->
        hidden states (B, S, E) in the compute dtype.  Dropout (train
        mode, ``cfg.dropout > 0``) draws from ``generator`` at the
        reference's sites, in its order: the embedding, then the
        attention and MLP outputs of each layer."""
        return self.encode_aux(tokens, train=train, generator=generator)[0]

    def encode_aux(self, tokens, *, train: bool = False, generator=None):
        """``encode`` and the layers' summed auxiliary loss (float32
        scalar): ``(h, aux)``."""
        c = self.cfg
        S = tokens.shape[1]
        s0 = self._seq_offset(S)
        S_full = S if self.sp is None else S * self.sp.size
        if c.pos_kind != "rope" and S_full > c.max_positions:
            raise ValueError(f"sequence length {S_full} exceeds "
                             f"max_positions {c.max_positions}")
        gen = self._dropout_generator(train, generator)
        h = self._embed(tokens)
        if c.pos_kind != "rope":
            h = h + self.pos_emb[None, s0:s0 + S]
        h = self.emb_ln(h)
        if gen is not None:
            h = dropout_mask(h, c.dropout, gen)
        h = h.to(c.dtype)
        enter, reduce = self._tp_hooks()

        def attention(q, k, v):
            if c.pos_kind == "rope":
                pos = s0 + torch.arange(S, device=q.device)
                q, k = rope(q, pos), rope(k, pos)
            return self._attention(q, k, v)

        def layer_fn(layer):
            def fn(h, g):
                drop = None if g is None else functools.partial(
                    dropout_mask, rate=c.dropout, generator=g)
                return layer.forward_aux(h, attention, c.dtype, drop, reduce,
                                         fused=c.fused_qkv, enter=enter)
            return fn

        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer in self.layers:
            h, a = run_layer(c, layer_fn(layer), h, gen)
            if a is not None:
                aux = aux + a
        return h, aux

    def aux_weight(self) -> float:
        """The weight of the layers' auxiliary loss in ``loss`` (0 for
        the dense MLP; ``models/moe``'s load-balance weight)."""
        return 0.0

    def head_hidden(self, h):
        """MLM head transform (dense + GELU + LN) in the compute dtype."""
        return self.mlm.head_hidden(h, self.cfg.dtype)

    def _out_b(self):
        """The tied decoder's float32 output bias."""
        return self.mlm.out_b

    def _logits(self, t):
        """Tied vocab decoder: float32 logits of head hidden ``t`` (under
        a model axis this rank's vocabulary rows)."""
        dt = self.cfg.dtype
        if self.tp is not None:
            t = collectives.copy_to(t, self.tp)
        return (t @ self.tok_emb.to(dt).t() + self._out_b()).to(
            torch.float32)

    def apply(self, tokens, *, train: bool = False, generator=None):
        """``tokens`` (B, S) (already masked) -> float32 logits (B, S,
        V); under a model axis this rank's vocabulary slice of them."""
        h = self.encode(tokens, train=train, generator=generator)
        return self._logits(self.head_hidden(h))

    def vocab_argmax(self, logits):
        """The argmax over the vocabulary of ``apply``'s logits (int64;
        under a model axis over every rank's slice, the lowest global
        index among ties, as ``argmax`` takes them: a collective)."""
        if self.tp is None:
            return logits.argmax(-1)
        return mlm_head.vocab_parallel_argmax(logits, self.tp)

    def _packs_positions(self) -> bool:
        """Whether the loss packs masked positions before the head (the
        MLM family); the causal family supervises every position."""
        return self.cfg.ce_positions == "masked"

    def _use_chunked_ce(self) -> bool:
        """``ce_impl``: ``dense`` or ``chunked`` as named; ``auto`` is
        chunked when every position reaches the head (the packed buffer's
        (B, S/4, V) logits are small enough for the dense path) and the
        vocabulary is whole (sharded, the logits are already 1/M)."""
        if self.cfg.ce_impl == "dense":
            return False
        if self.cfg.ce_impl == "chunked":
            return True
        return not self._packs_positions() and self.tp is None

    def _ce(self, t, labels):
        """Per-position float32 CE (B, P) of head hidden ``t`` against
        ``labels`` (B, P)."""
        if self.tp is not None:
            return mlm_head.vocab_parallel_ce(
                t, self.tok_emb, self._out_b(), labels, self.tp,
                chunk=self.cfg.ce_chunk if self._use_chunked_ce() else None,
                dtype=self.cfg.dtype)
        if self._use_chunked_ce():
            return mlm_head.tied_softmax_ce(
                t, self.tok_emb, self._out_b(), labels,
                chunk=self.cfg.ce_chunk, dtype=self.cfg.dtype)
        logits = self._logits(t)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - gold

    def loss_weights(self, batch: dict):
        """(B, S) float32: the positions the loss averages over (the
        masked ones, this rank's block under a seq axis); a step divides
        by their count over the global batch (``train.gspmd``)."""
        return batch["mask"].to(torch.float32)

    def loss(self, batch: dict, labels, *, train: bool = False,
             generator=None):
        """Masked-LM loss: mean CE over the masked positions, plus the
        auxiliary loss at ``aux_weight()``.  ``batch`` holds ``tokens``
        (B, S) and ``mask`` (B, S) bool; ``labels`` (B, S) the original
        ids.  The denominator counts every masked position,
        overflow-dropped ones included, as the reference's."""
        ce, aux = self.loss_terms(batch, labels, train=train,
                                  generator=generator)
        return ce / torch.clamp(self.loss_weights(batch).sum(), min=1.0) \
            + self.aux_weight() * aux

    def _seq_gather(self, x):
        """The whole rows of this rank's block ``x`` (B, S_local, ...)
        under a seq axis (not differentiable), else ``x``."""
        if self.sp is None:
            return x
        return collectives.allgather_dim(x, 1, self.sp)

    def loss_terms(self, batch: dict, labels, *, train: bool = False,
                   generator=None):
        """``(ce_sum, aux)``: the loss's numerator, the CE summed over
        the masked positions that reach the head, and the layers'
        auxiliary loss.  A step divides the sum by the masked count of
        the GLOBAL batch, as the reference's GSPMD loss does
        (``train.gspmd``).  Under a seq axis each rank's sum is its part
        of the packed rows of the whole sequences."""
        h, aux = self.encode_aux(batch["tokens"], train=train,
                                 generator=generator)
        mask = batch["mask"].to(torch.bool)
        labels = labels.long()
        if self.cfg.ce_positions != "masked":
            weights = mask.to(torch.float32)
            return (self._ce(self.head_hidden(h), labels) * weights).sum(), aux
        if self.sp is not None:
            h = collectives.gather_from(h, self.sp, 1)
            labels, mask = self._seq_gather(labels), self._seq_gather(mask)
        h, labels, weights = mlm_head.gather_masked_rows(
            h, labels, mask, ce_capacity(self.cfg, h.shape[1]))
        if self.sp is not None:
            h, labels, weights = (
                mlm_head.rows_part(x, self.sp.index, self.sp.size)
                for x in (h, labels, weights))
        return (self._ce(self.head_hidden(h), labels) * weights).sum(), aux
