"""Encoder-decoder LM (T5-shaped): the cross-attention family.

Counterpart of ``EncDecLm`` in ``mpi_tensorflow_tpu/models/encdec.py``:

- the encoder is ``models/bert.BertMlm``'s (``encode``: token and
  learned position embeddings, the bidirectional layers, the flash
  kernels at ``S >= flash_min_seq`` on the card);
- each decoder layer is post-LN [causal self-attention, cross-attention
  over the encoder's output, GELU MLP].  The self-attention is the
  shared ``BertMlm._attention`` made causal, so it takes the causal flash
  kernel at ``T >= flash_min_seq``; the cross-attention stays
  ``parallel/ring.dense_attention`` (non-causal, rectangular), as in the
  reference;
- the token embedding is tied across the encoder's input, the decoder's
  input and the output head (with a float32 output bias ``out_b``);
- the loss is the teacher-forced next-token CE over the target side
  (position t predicts tgt[t + 1], the last position weighted 0), the
  chunked ``ops/mlm_head.tied_softmax_ce`` unless ``ce_impl`` is
  "dense";
- ``generate``: encode once, compute the cross-attention K/V once, then
  a greedy KV-cache loop; ``max_new_tokens`` past the decoder's
  positions raises;
- dropout draws from the one generator in the reference's site order
  (the encoder's embedding and layers, the decoder's embedding, then
  self, cross and MLP of each decoder layer); ``cfg.remat`` covers the
  decoder layers as it does the encoder's (``bert.run_layer``).

The parameter tree is the reference's: the encoder's ``tok_emb``,
``pos_emb``, ``emb_ln``, ``layers``, then ``dec_pos_emb``,
``dec_emb_ln``, ``dec_layers`` (each an encoder layer's leaves plus
``xq``, ``xk``, ``xv`` (E, H, D), ``xbq``, ``xbk``, ``xbv`` (H, D),
``xo`` (H, D, E), ``xbo``, ``lnx``) and ``out_b``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from mpi_tensorflow_torch.models import bert as bert_lib
from mpi_tensorflow_torch.models.base import dropout_mask
from mpi_tensorflow_torch.models.gpt import shift_targets
from mpi_tensorflow_torch.parallel.ring import dense_attention
from mpi_tensorflow_torch.train import graphs as graphs_lib

class DecoderLayer(bert_lib.EncoderLayer):
    """An encoder layer's leaves plus the cross-attention's."""

    NAMES = bert_lib.EncoderLayer.NAMES + (
        "xq", "xk", "xv", "xbq", "xbk", "xbv", "xo", "xbo")

    def __init__(self, lp: dict, dt: torch.dtype, trainable: bool = True):
        super().__init__(lp, dt, trainable)
        self.lnx = bert_lib.LayerNorm(lp["lnx"], trainable=trainable)

    def tree(self) -> dict:
        t = super().tree()
        t["lnx"] = self.lnx.tree()
        return t

    def cross_kv(self, enc_out, dt):
        """The cross-attention's K and V (B, H, S, D) from the encoder's
        output."""
        def proj(w, b):
            return (torch.einsum("bse,ehd->bhsd", enc_out, w.to(dt))
                    + b.to(dt)[None, :, None, :])
        return proj(self.xk, self.xbk), proj(self.xv, self.xbv)

    def decode(self, h, xk, xv, self_attention, dt, drop=None,
               fused: bool = False):
        """Residual self-attention (``self_attention(q, k, v)``),
        residual cross-attention over ``xk``/``xv``, residual MLP, each
        post-LN; ``drop`` applies dropout before each residual add;
        ``fused`` is ``qkv_proj``'s."""
        d = drop if drop is not None else (lambda x: x)
        q, k, v = self.qkv_proj(h, dt, fused)
        a = d(self.attn_out_proj(self_attention(q, k, v), dt))
        h = self.ln1(h + a).to(dt)
        q = (torch.einsum("bse,ehd->bhsd", h, self.xq.to(dt))
             + self.xbq.to(dt)[None, :, None, :])
        x = dense_attention(q, xk, xv, causal=False)
        x = torch.einsum("bhsd,hde->bse", x, self.xo.to(dt)) \
            + self.xbo.to(dt)
        h = self.lnx(h + d(x)).to(dt)
        m = d(self.gelu_mlp(h, dt))
        return self.ln2(h + m).to(dt)


def init_params(cfg: bert_lib.BertConfig, generator: torch.Generator) -> dict:
    """Seeded float32 parameters in the reference's tree (weights normal
    x 0.02, biases 0, LayerNorm scales 1), drawn on the CPU; as many
    decoder layers as encoder layers."""
    c = cfg
    enc = bert_lib.init_params(cfg, generator)
    del enc["mlm"]

    def normal(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    def ln():
        return {"scale": torch.ones(c.hidden), "bias": torch.zeros(c.hidden)}

    H, D = c.heads, c.head_dim
    dec = []
    for lp in bert_lib.init_params(cfg, generator)["layers"]:
        lp.update(xq=normal(c.hidden, H, D), xk=normal(c.hidden, H, D),
                  xv=normal(c.hidden, H, D), xbq=torch.zeros(H, D),
                  xbk=torch.zeros(H, D), xbv=torch.zeros(H, D),
                  xo=normal(H, D, c.hidden), xbo=torch.zeros(c.hidden),
                  lnx=ln())
        dec.append(lp)
    return {**enc, "dec_pos_emb": normal(c.max_positions, c.hidden),
            "dec_emb_ln": ln(), "dec_layers": dec,
            "out_b": torch.zeros(c.vocab_size)}


class EncDecLm(bert_lib.BertMlm):
    """The encoder-decoder LM for training and greedy decoding.
    ``batch`` is ``{"src": (B, S), "tgt": (B, T)}`` int ids; ``tgt[:, 0]``
    is BOS and positions 1.. are supervised."""

    mesh_item = "14e (encdec_t5 under the model axis)"

    def __init__(self, cfg: bert_lib.BertConfig, params: dict,
                 attention: str = "auto", mesh=None):
        if cfg.pos_kind != "learned":
            raise ValueError(
                f"the encoder-decoder family supports pos_kind='learned' "
                f"only (got {cfg.pos_kind!r})")
        super().__init__(cfg, params, attention, mesh=mesh)

    def _init_head(self, params: dict) -> None:
        f32 = torch.float32
        self.dec_pos_emb = bert_lib._param(params["dec_pos_emb"], f32, True)
        self.dec_emb_ln = bert_lib.LayerNorm(params["dec_emb_ln"],
                                             trainable=True)
        self.dec_layers = nn.ModuleList(
            DecoderLayer(lp, self.cfg.dtype) for lp in params["dec_layers"])
        self.out_b = bert_lib._param(params["out_b"], f32, True)

    @classmethod
    def init_params(cls, cfg: bert_lib.BertConfig, generator) -> dict:
        return init_params(cfg, generator)

    @property
    def n_dec(self) -> int:
        return len(self.dec_layers)

    def param_tree(self) -> dict:
        return {"tok_emb": self.tok_emb, "pos_emb": self.pos_emb,
                "emb_ln": self.emb_ln.tree(),
                "layers": [layer.tree() for layer in self.layers],
                "dec_pos_emb": self.dec_pos_emb,
                "dec_emb_ln": self.dec_emb_ln.tree(),
                "dec_layers": [layer.tree() for layer in self.dec_layers],
                "out_b": self.out_b}

    def _out_b(self):
        return self.out_b

    def _use_chunked_ce(self) -> bool:
        return self.cfg.ce_impl != "dense"

    def _dec_embed(self, tgt_in, offset: int = 0):
        c = self.cfg
        T = tgt_in.shape[1]
        if offset + T > c.max_positions:
            raise ValueError(f"target positions {offset + T} exceed "
                             f"max_positions {c.max_positions}")
        h = F.embedding(tgt_in.long(), self.tok_emb) \
            + self.dec_pos_emb[None, offset:offset + T]
        return self.dec_emb_ln(h).to(c.dtype)

    def decode_hidden(self, enc_out, tgt_in, *, train: bool = False,
                      generator=None):
        """Teacher-forced decoder pass -> hidden states (B, T, E) in the
        compute dtype (the tied head's input)."""
        c = self.cfg
        dt = c.dtype
        gen = self._dropout_generator(train, generator)
        h = self._dec_embed(tgt_in)
        if gen is not None:
            h = dropout_mask(h, c.dropout, gen)

        def self_attention(q, k, v):
            return self._attention(q, k, v, causal=True)

        def fn(layer, h, g, xk, xv):
            drop = None if g is None else functools.partial(
                dropout_mask, rate=c.dropout, generator=g)
            return layer.decode(h, xk, xv, self_attention, dt, drop,
                                c.fused_qkv)

        for layer in self.dec_layers:
            xk, xv = layer.cross_kv(enc_out, dt)
            h = bert_lib.run_layer(c, functools.partial(fn, layer), h, gen,
                                   xk, xv)
        return h

    def apply(self, batch: dict, *, train: bool = False, generator=None):
        """Decoder logits (B, T, V) float32 (position t predicts
        tgt[t + 1])."""
        enc_out = self.encode(batch["src"], train=train, generator=generator)
        return self._logits(self.decode_hidden(
            enc_out, batch["tgt"], train=train, generator=generator))

    def loss_weights(self, batch: dict):
        return shift_targets(batch["tgt"])[1]

    def loss_terms(self, batch: dict, labels=None, *, train: bool = False,
                   generator=None):
        """The target side's CE summed over the supervised positions
        (all but the last of each row) and a zero auxiliary loss."""
        tgt = batch["tgt"]
        enc_out = self.encode(batch["src"], train=train, generator=generator)
        h = self.decode_hidden(enc_out, tgt, train=train,
                               generator=generator)
        targets, w = shift_targets(tgt.long())
        ce = self._ce(h, targets)
        return (ce * w).sum(), torch.zeros((), dtype=torch.float32,
                                           device=h.device)

    @torch.no_grad()
    def generate(self, src, max_new_tokens: int, *, bos_id: int = 0):
        """Greedy decoding conditioned on ``src`` (B, S): (B,
        max_new_tokens) ids, the first AFTER the BOS seed.  The
        self-attention K/V go to a (B, H, L, D) cache per layer; the
        cross-attention's are computed once.  On the card the call is one
        replay of a CUDA graph of ``decode_loop`` per call shape (the
        reference's one ``lax.scan``); on the CPU the eager loop."""
        if max_new_tokens < 1:
            raise ValueError("generate needs max_new_tokens >= 1")
        c = self.cfg
        if max_new_tokens > c.max_positions:
            raise ValueError(f"max_new_tokens {max_new_tokens} exceeds "
                             f"max_positions {c.max_positions}")
        if not graphs_lib.use_graphs(src.device):
            return self.decode_loop(src, max_new_tokens, bos_id=bos_id)
        return graphs_lib.graphed_call(
            self, ("generate", tuple(src.shape), max_new_tokens, bos_id),
            lambda s, _: self.decode_loop(s, max_new_tokens, bos_id=bos_id),
            [src])

    @torch.no_grad()
    def decode_loop(self, src, max_new_tokens: int, *, bos_id: int = 0):
        """``generate``'s eager loop (its arguments checked there), which
        ``generate`` captures into a graph on the card."""
        c = self.cfg
        dt = c.dtype
        B, L = src.shape[0], max_new_tokens
        enc_out = self.encode(src)
        xkv = [layer.cross_kv(enc_out, dt) for layer in self.dec_layers]
        shape = (B, c.heads, L, c.head_dim)
        cache = [(torch.zeros(shape, dtype=dt, device=src.device),
                  torch.zeros(shape, dtype=dt, device=src.device))
                 for _ in self.dec_layers]
        col = torch.arange(L, device=src.device)
        token = torch.full((B,), bos_id, dtype=torch.long, device=src.device)
        out = []
        for i in range(L):
            h = self._dec_embed(token[:, None], offset=i)
            vis = (col <= i)[None, None, None, :]
            for layer, (xk, xv), (ck, cv) in zip(self.dec_layers, xkv,
                                                 cache):
                def self_attention(q, k, v, ck=ck, cv=cv):
                    ck[:, :, i] = k[:, :, 0]
                    cv[:, :, i] = v[:, :, 0]
                    s = torch.einsum("bhsd,bhld->bhsl", q, ck).to(
                        torch.float32)
                    s = torch.where(vis, s * c.head_dim ** -0.5,
                                    torch.finfo(torch.float32).min)
                    p = torch.softmax(s, -1).to(dt)
                    return torch.einsum("bhsl,bhld->bhsd", p, cv)
                h = layer.decode(h, xk, xv, self_attention, dt,
                                 fused=c.fused_qkv)
            token = torch.argmax(self._logits(h)[:, 0], -1)
            out.append(token)
        return torch.stack(out, 1)
