"""Decoder-only causal LM — the model the serving engine drives.

Counterpart of ``mpi_tensorflow_tpu/models/gpt.py``'s ``CausalLm`` for
inference: the paged forward the engine dispatches (``forward_paged``,
over a pool in the compute dtype, int8 or int4), and the
contiguous-cache forward with greedy ``generate`` that the serving
tests use as the token-identity anchor.  Causal-LM training (the
next-token loss) is not ported yet (ROADMAP Queue 1 item 13).

The model is an ``nn.Module`` built from a parameter tree in the
reference's layout: ``bert.init_params`` (seeded on the CPU) or
``convert.params_from_jax`` (a JAX model's parameters).  Move it with
``.to(device)``; caches and pools live on the same device.

The tied logits product is a plain large matmul the reference left to
XLA; here it is ``torch.matmul`` (cuBLAS on the card).  Logits are
float32: the product in the compute dtype plus the float32 output bias.
"""

from __future__ import annotations

import torch
from torch import nn

from mpi_tensorflow_torch.models import bert as bert_lib
from mpi_tensorflow_torch.ops import paged_attention as paged_ops


class CausalLm(nn.Module):
    """GPT-style causal LM on the shared transformer layers."""

    def __init__(self, cfg: bert_lib.BertConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        f32 = torch.float32
        self.tok_emb = bert_lib._param(params["tok_emb"], f32)
        self.pos_emb = bert_lib._param(params["pos_emb"], f32)
        self.emb_ln = bert_lib.LayerNorm(params["emb_ln"])
        self.layers = nn.ModuleList(
            bert_lib.EncoderLayer(lp, dt) for lp in params["layers"])
        self.mlm = bert_lib.LmHead(params["mlm"], dt)
        # the reference casts tok_emb to the compute dtype at every logits
        # product; keep that cast once (None: float32, tok_emb itself)
        self.register_buffer(
            "tok_emb_dt",
            None if dt == f32 else self.tok_emb.detach().to(dt),
            persistent=False)

    @classmethod
    def from_seed(cls, cfg: bert_lib.BertConfig, seed: int = 0) -> "CausalLm":
        """Random weights from ``seed`` (``bert.init_params`` on a CPU
        ``torch.Generator``)."""
        gen = torch.Generator().manual_seed(seed)
        return cls(cfg, bert_lib.init_params(cfg, gen))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def _embed(self, tokens, positions):
        c = self.cfg
        h = self.tok_emb[tokens.long()]
        if c.pos_kind != "rope":
            h = h + self.pos_emb[positions.long()]
        return self.emb_ln(h).to(c.dtype)

    def _logits(self, h):
        dt = self.cfg.dtype
        t = self.mlm.head_hidden(h, dt)
        tied = self.tok_emb if self.tok_emb_dt is None else self.tok_emb_dt
        return (t @ tied.t() + self.mlm.out_b).to(torch.float32)

    # ---------------- paged cache (serving) ----------------

    def forward_paged(self, tokens, pools, block_tables, lengths,
                      valid=None, kernel: str = "gather", reduce=None):
        """Forward ``tokens`` (B, S) through the paged KV cache: row ``b``
        occupies absolute positions [lengths[b], lengths[b] + S) and
        reads/writes the per-layer pools through its block table.  One
        implementation serves chunked prefill (S = chunk) and decode
        (S = 1).

        pools:        per-layer pools (``paged_cache.init_pools``):
                      ``{"k", "v"}`` in the compute dtype, or int8/int4
                      codes with ``{"k_scale", "v_scale"}``; UPDATED IN
                      PLACE with this step's K/V (quantized on store)
        block_tables: (B, NB) int32; entries past a row's allocation are
                      the null block (0)
        lengths:      (B,) int32 cache entries already written per row
        valid:        optional (B, S) bool; False lanes (padded prefill
                      tail, bucket-slack rows) write into the null block
                      and their outputs are garbage the caller discards
        kernel:       resolved lowering, ``"gather"`` or ``"cuda"``
                      (ops/paged_attention.resolve_kernel)
        reduce:       tensor parallelism's sum over the ranks, applied
                      to each layer's two row-parallel products before
                      their biases (``serving/tp``); the pools and the
                      layers then hold this rank's heads and MLP slice

        Returns float32 logits (B, S, V)."""
        c = self.cfg
        dt = c.dtype
        B, S = tokens.shape
        lengths = lengths.to(torch.int32)
        block_tables = block_tables.to(torch.int32)
        pos = lengths[:, None] + torch.arange(S, dtype=torch.int32,
                                              device=tokens.device)
        if valid is None:
            valid = torch.ones((B, S), dtype=torch.bool,
                               device=tokens.device)
        # learned positions gather per row with a clip: padded lanes may
        # sit past the table (the reference's jnp.clip)
        h = self._embed(tokens, torch.clamp(pos, 0, c.max_positions - 1))
        for layer, pl in zip(self.layers, pools):
            def attention(q, k, v, pl=pl):
                if c.pos_kind == "rope":
                    # rotate at ABSOLUTE per-row positions; keys enter
                    # the pool already rotated
                    q, k = bert_lib.rope(q, pos), bert_lib.rope(k, pos)
                if "k_scale" not in pl:
                    paged_ops.write_kv(pl["k"], k, block_tables, pos, valid)
                    paged_ops.write_kv(pl["v"], v, block_tables, pos, valid)
                    return paged_ops.attend(q, pl["k"], pl["v"],
                                            block_tables, lengths, dt,
                                            kernel=kernel)
                # quantized pool: quantize on store (codes and scales
                # through the same block/slot index), dequantize inside
                # attend; int4 (4-d group scales) also passes the step's
                # own K/V for the fp-residual self lane
                int4 = pl["k_scale"].ndim == 4
                write = (paged_ops.write_kv_quant_int4 if int4
                         else paged_ops.write_kv_quant)
                write(pl["k"], pl["k_scale"], k, block_tables, pos, valid)
                write(pl["v"], pl["v_scale"], v, block_tables, pos, valid)
                return paged_ops.attend(
                    q, pl["k"], pl["v"], block_tables, lengths, dt,
                    kernel=kernel, k_scale=pl["k_scale"],
                    v_scale=pl["v_scale"], k_new=k if int4 else None,
                    v_new=v if int4 else None)
            h = layer(h, attention, dt, reduce=reduce)
        return self._logits(h)

    # ---------------- contiguous cache (parity anchor) ----------------

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """Per-layer zero K/V buffers (B, H, max_len, D) in the compute
        dtype.  Under learned positions ``max_len`` must fit the table."""
        c = self.cfg
        if c.pos_kind == "learned" and max_len > c.max_positions:
            raise ValueError(
                f"max_len {max_len} exceeds max_positions {c.max_positions}")
        shape = (batch_size, c.heads, max_len, c.head_dim)
        return [{"k": torch.zeros(shape, dtype=c.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=c.dtype, device=self.device)}
                for _ in range(c.layers)]

    def forward_with_cache(self, tokens, cache, offset: int):
        """Forward ``tokens`` (B, S) at absolute positions [offset,
        offset + S) through the contiguous cache (updated in place).
        Returns float32 logits (B, S, V)."""
        c = self.cfg
        dt = c.dtype
        S = tokens.shape[1]
        L = cache[0]["k"].shape[2]
        pos = offset + torch.arange(S, device=tokens.device)
        h = self._embed(tokens, pos[None])
        vis = torch.arange(L, device=tokens.device)[None, :] <= pos[:, None]
        for layer, cc in zip(self.layers, cache):
            def attention(q, k, v, cc=cc):
                if c.pos_kind == "rope":
                    q, k = bert_lib.rope(q, pos), bert_lib.rope(k, pos)
                cc["k"][:, :, offset:offset + S] = k
                cc["v"][:, :, offset:offset + S] = v
                # the same fp32 masked softmax as the paged gather path
                return paged_ops.masked_softmax_attention(
                    q, cc["k"], cc["v"], vis[None, None], dt)
            h = layer(h, attention, dt)
        return self._logits(h)

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, *,
                 cache_len: int | None = None):
        """Greedy decode: ``prompt`` (B, S0) int ids -> (B, S0 +
        max_new_tokens), the prompt with its continuation.  Prefill runs
        the whole prompt in one forward, then one token per step."""
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, "
                             f"got {max_new_tokens}")
        if max_new_tokens == 0:
            return prompt
        B, S0 = prompt.shape
        total = S0 + max_new_tokens
        if cache_len is not None and cache_len < total:
            raise ValueError(f"cache_len {cache_len} < prompt + "
                             f"max_new_tokens ({total})")
        cache = self.init_cache(B, cache_len or total)
        logits = self.forward_with_cache(prompt, cache, 0)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits = self.forward_with_cache(tok[:, None], cache, S0 + i)
            tok = torch.argmax(logits[:, 0], dim=-1)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, 1).to(prompt.dtype)], 1)
