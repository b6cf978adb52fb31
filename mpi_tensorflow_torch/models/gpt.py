"""Decoder-only causal LM: serving, decoding and next-token training.

Counterpart of ``mpi_tensorflow_tpu/models/gpt.py``'s ``CausalLm``, which
is one class there.  Here it is two, on one parameter tree:

- ``CausalLm``, for inference: the paged forward the engine dispatches
  (``forward_paged``, over a pool in the compute dtype, int8 or int4),
  the contiguous-cache forward, ``generate`` (greedy, or temperature
  sampling with the top-k / top-p filters) and fixed-length
  ``beam_search``.  Its parameters are frozen copies in the compute
  dtype;
- ``TrainableCausalLm``, for training: ``bert.BertMlm`` with the causal
  mask in every layer's attention (the flash kernels' causal mode at
  ``S >= flash_min_seq`` on the card) and the next-token loss through
  the chunked tied cross-entropy (``ops/mlm_head.tied_softmax_ce``).
  ``serving()`` hands its parameters to a ``CausalLm``.

The pipelined ``PipelinedCausalLm`` waits for the pipeline (ROADMAP
Queue 1 item 14d), and ``forward_with_cache`` / ``generate`` under a
mesh for item 14e: ``CausalLm`` is one rank's whole model.

A model is built from a parameter tree in the reference's layout:
``bert.init_params`` (seeded on the CPU) or ``convert.params_from_jax``
(a JAX model's parameters).  Move it with ``.to(device)``; caches and
pools live on the same device.

The tied logits product is a plain large matmul the reference left to
XLA; here it is ``torch.matmul`` (cuBLAS on the card).  Logits are
float32: the product in the compute dtype plus the float32 output bias.
Sampling draws by Gumbel-max, as ``jax.random.categorical`` does:
``argmax(logits + g)`` with ``g = -log(-log(u))``, ``u`` uniform from
the caller's ``torch.Generator``; ``noise`` injects ``g`` instead.
"""

from __future__ import annotations

import torch
from torch import nn

from mpi_tensorflow_torch.models import bert as bert_lib
from mpi_tensorflow_torch.ops import paged_attention as paged_ops
from mpi_tensorflow_torch.train import graphs as graphs_lib
from mpi_tensorflow_torch.utils import tree as tree_lib


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
            h = layer(h, attention, dt, reduce=reduce,
                      fused=c.fused_qkv)
        return self._logits(h)

    # ---------------- contiguous cache (parity anchor) ----------------

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """Per-layer zero K/V buffers (B, H, max_len, D) in the compute
        dtype, H the heads this model holds (a tensor-parallel shard's
        own).  Under learned positions ``max_len`` must fit the table."""
        c = self.cfg
        if c.pos_kind == "learned" and max_len > c.max_positions:
            raise ValueError(
                f"max_len {max_len} exceeds max_positions {c.max_positions}")
        heads = self.layers[0].wq.shape[1] if len(self.layers) else c.heads
        shape = (batch_size, heads, max_len, c.head_dim)
        return [{"k": torch.zeros(shape, dtype=c.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=c.dtype, device=self.device)}
                for _ in range(c.layers)]

    def forward_with_cache(self, tokens, cache, offset: int, reduce=None):
        """Forward ``tokens`` (B, S) at absolute positions [offset,
        offset + S) through the contiguous cache (updated in place).
        ``reduce`` as in ``forward_paged`` (a tensor-parallel shard).
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
            h = layer(h, attention, dt, reduce=reduce,
                      fused=c.fused_qkv)
        return self._logits(h)

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, generator=None, noise=None,
                 cache_len: int | None = None, reduce=None):
        """Autoregressive decode: greedy (``temperature == 0``) or
        temperature sampling, filtered by ``top_k`` (keep the k most
        likely tokens) and/or ``top_p`` (keep the smallest prefix of the
        probability-sorted vocabulary whose mass reaches p).  ``prompt``
        (B, S0) int ids -> (B, S0 + max_new_tokens), the prompt with its
        continuation.  Prefill runs the whole prompt in one forward, then
        one token a step.

        Sampling draws step i's Gumbel noise (B, V) from ``generator``,
        or takes ``noise[i]`` (``noise``: (max_new_tokens, B, V) float32)
        when given.

        On the card (``train.graphs.use_graphs``) the whole call, prefill
        and token loop, is one replay of a CUDA graph of ``decode_loop``
        captured at the first call of its shape (batch, prompt length,
        new tokens, cache capacity, sampling settings; the counterpart of
        the reference's one ``lax.scan``), ``generator`` advanced as the
        eager loop advances it; on the CPU, and with ``reduce`` (a
        tensor-parallel shard: its collectives may run over gloo), the
        eager ``decode_loop``.  ``cache_len`` pins the cache's capacity (default
        prompt + new tokens): a step attends over the whole (masked)
        cache, so timing arms of different lengths must share it.
        ``reduce``: a tensor-parallel shard's sum over the ranks."""
        if temperature > 0.0 and generator is None and noise is None:
            raise ValueError("temperature sampling needs a generator")
        if (top_k > 0 or top_p < 1.0) and temperature <= 0.0:
            raise ValueError(
                "top_k/top_p filter the sampling distribution; they have "
                "no effect under greedy decoding (temperature 0): pass "
                "temperature > 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
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
        if reduce is not None or not graphs_lib.use_graphs(prompt.device):
            return self.decode_loop(prompt, max_new_tokens,
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p, generator=generator,
                                    noise=noise, cache_len=cache_len,
                                    reduce=reduce)
        key = ("generate", tuple(prompt.shape), max_new_tokens,
               cache_len or total, temperature, top_k, top_p,
               None if noise is None else tuple(noise.shape))
        sampled = temperature > 0.0 and noise is None

        def run(p, *rest):
            return self.decode_loop(
                p, max_new_tokens, temperature=temperature, top_k=top_k,
                top_p=top_p, generator=rest[-1],
                noise=rest[0] if noise is not None else None,
                cache_len=cache_len)
        inputs = [prompt] if noise is None else [prompt, noise]
        return graphs_lib.graphed_call(self, key, run, inputs,
                                       generator if sampled else None)

    @torch.no_grad()
    def decode_loop(self, prompt, max_new_tokens: int, *,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, generator=None, noise=None,
                    cache_len: int | None = None, reduce=None):
        """``generate``'s eager loop (its arguments checked there): the
        prefill, then one forward a token, each launched from the host.
        ``generate`` captures it into a graph on the card; on the CPU,
        and under ``reduce``, it is what ``generate`` runs."""
        B, S0 = prompt.shape
        total = S0 + max_new_tokens

        def pick(logits, i):
            return sample(logits, temperature, generator, top_k=top_k,
                          top_p=top_p,
                          noise=None if noise is None else noise[i])

        cache = self.init_cache(B, cache_len or total)
        logits = self.forward_with_cache(prompt, cache, 0, reduce)
        tok = pick(logits[:, -1], 0)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits = self.forward_with_cache(tok[:, None], cache, S0 + i,
                                             reduce)
            tok = pick(logits[:, 0], i + 1)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, 1).to(prompt.dtype)], 1)

    @torch.no_grad()
    def beam_search(self, prompt, max_new_tokens: int, *,
                    num_beams: int = 4, length_penalty: float = 0.0,
                    cache_len: int | None = None):
        """Fixed-length beam search over the contiguous cache (no EOS:
        every beam runs to the full length).  Prefill once at batch B,
        tile the cache K-fold, then each step keeps the top K of the K x V
        extensions, reindexes every cache leaf to the surviving beams'
        parents, and the tokens are backtracked at the end.

        Returns ``(sequences (B, K, S0 + T), scores (B, K))``, best
        first; a score is the sum of the chosen tokens' log-probabilities
        divided by ``T ** length_penalty``.  ``cache_len`` as in
        ``generate``; on the card one graph replay of ``beam_loop`` a
        call, as ``generate``."""
        if max_new_tokens < 1:
            raise ValueError("beam_search needs max_new_tokens >= 1")
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        B, S0 = prompt.shape
        total = S0 + max_new_tokens
        if cache_len is not None and cache_len < total:
            raise ValueError(f"cache_len {cache_len} < prompt + "
                             f"max_new_tokens ({total})")
        if not graphs_lib.use_graphs(prompt.device):
            return self.beam_loop(prompt, max_new_tokens,
                                  num_beams=num_beams,
                                  length_penalty=length_penalty,
                                  cache_len=cache_len)
        key = ("beam_search", tuple(prompt.shape), max_new_tokens,
               num_beams, length_penalty, cache_len or total)
        return graphs_lib.graphed_call(
            self, key, lambda p, _: self.beam_loop(
                p, max_new_tokens, num_beams=num_beams,
                length_penalty=length_penalty, cache_len=cache_len),
            [prompt])

    @torch.no_grad()
    def beam_loop(self, prompt, max_new_tokens: int, *, num_beams: int = 4,
                  length_penalty: float = 0.0,
                  cache_len: int | None = None):
        """``beam_search``'s eager loop (its arguments checked there),
        which ``beam_search`` captures into a graph on the card."""
        B, S0 = prompt.shape
        K, T = num_beams, max_new_tokens
        total = S0 + T
        V = self.cfg.vocab_size
        cache = self.init_cache(B, cache_len or total)
        logits = self.forward_with_cache(prompt, cache, 0)
        scores, first = torch.topk(
            torch.log_softmax(logits[:, -1], -1), K, dim=-1)   # (B, K)
        for cc in cache:
            for name in cc:
                cc[name] = cc[name].repeat_interleave(K, 0)    # (B*K, ...)
        rows = torch.arange(B, device=prompt.device)[:, None] * K
        parents, toks = [], []
        tok = first
        for i in range(T - 1):
            logits = self.forward_with_cache(tok.reshape(B * K, 1), cache,
                                             S0 + i)
            logp = torch.log_softmax(logits[:, 0].reshape(B, K, V), -1)
            scores, flat = torch.topk(
                (scores[..., None] + logp).reshape(B, K * V), K, dim=-1)
            parent = torch.div(flat, V, rounding_mode="floor")
            tok = flat % V
            src = (rows + parent).reshape(-1)
            for cc in cache:
                for name in cc:
                    cc[name] = cc[name].index_select(0, src)
            parents.append(parent)
            toks.append(tok)
        # backtrack from the final slots: the token at step t+1 of a
        # final beam is toks[t] at its slot; its slot at step t is
        # parents[t] there
        idx = torch.arange(K, device=prompt.device).expand(B, K)
        out = []
        for parent, t in zip(reversed(parents), reversed(toks)):
            out.append(torch.gather(t, 1, idx))
            idx = torch.gather(parent, 1, idx)
        out.append(torch.gather(first, 1, idx))
        gen = torch.stack(out[::-1], -1)                       # (B, K, T)
        seqs = torch.cat([prompt[:, None].expand(B, K, S0),
                          gen.to(prompt.dtype)], -1)
        if length_penalty:
            scores = scores / (float(T) ** length_penalty)
        return seqs, scores


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, float32, from ``generator`` (drawn on the
    generator's device): ``-log(-log(u))`` with ``u`` uniform in [tiny,
    1), as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def sample(logits, temperature: float, generator=None, *, top_k: int = 0,
           top_p: float = 1.0, noise=None):
    """(B, V) float32 logits -> (B,) token ids.

    Greedy at ``temperature <= 0``.  Otherwise a Gumbel-max draw (module
    note) on the tempered logits; with a filter the draw runs in the
    DESCENDING-sorted space, as the reference's does: the top-k mask
    first, then the exclusive cumulative mass ``< top_p`` (the top slot
    always survives), and the winning sorted slot is mapped back through
    the sort's index.  ``noise`` (B, V) replaces the draw from
    ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    V = logits.shape[-1]
    if noise is None:
        noise = gumbel(generator, logits.shape, logits.device)
    noise = noise.to(logits.device, torch.float32)
    if top_k <= 0 and top_p >= 1.0:
        return torch.argmax(logits + noise, dim=-1)
    # a stable descending sort: equal logits keep their index order, as
    # lax.top_k orders them
    srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    neg = torch.finfo(srt.dtype).min
    if top_k > 0:
        keep = torch.arange(V, device=srt.device) < min(top_k, V)
        srt = torch.where(keep[None], srt, torch.full_like(srt, neg))
    if top_p < 1.0:
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        srt = torch.where(cum < top_p, srt, torch.full_like(srt, neg))
    choice = torch.argmax(srt + noise, dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0]


def shift_targets(tokens):
    """THE next-token supervision: targets are the inputs shifted left,
    padded with 0, and the final position's weight is 0 (unsupervised).
    Returns ``(targets, weights)``, the weights float32."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        1)
    w = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    w[:, -1] = 0.0
    return targets, w


class TrainableCausalLm(bert_lib.BertMlm):
    """The reference's ``CausalLm`` for training: ``BertMlm`` with the
    causal mask in every layer and the next-token loss at every position
    (no masked packing: ``ce_impl="auto"`` takes the chunked CE, or the
    dense one when a model axis shards the vocabulary).

    ``batch`` holds ``tokens`` (B, S); labels and the MLM mask are not
    read: the targets are the tokens shifted left (``shift_targets``).
    Under a seq axis the shift runs on the whole rows (a block's last
    position is supervised by the next block's first token), and each
    rank keeps its block of the targets and weights.
    """

    causal = True

    def _packs_positions(self) -> bool:
        return False

    def _targets(self, tokens):
        """``shift_targets`` of the whole rows, this rank's block."""
        targets, w = shift_targets(self._seq_gather(tokens.long()))
        S = tokens.shape[1]
        s0 = self._seq_offset(S)
        return targets[:, s0:s0 + S], w[:, s0:s0 + S]

    def loss_weights(self, batch: dict):
        return self._targets(batch["tokens"])[1]

    def loss_terms(self, batch: dict, labels=None, *,
                   train: bool = False, generator=None):
        """The CE summed over the supervised positions, B x (S - 1) of
        them, and the (zero) auxiliary loss; ``loss`` (``BertMlm``'s)
        divides the sum by their count: ``sum(ce * w) / max(sum(w), 1)``,
        the reference's loss."""
        tokens = batch["tokens"]
        h, aux = self.encode_aux(tokens, train=train, generator=generator)
        targets, w = self._targets(tokens)
        ce = self._ce(self.head_hidden(h), targets)
        return (ce * w).sum(), aux

    def serving(self) -> CausalLm:
        """A ``CausalLm`` on copies of these parameters (frozen, in the
        compute dtype), on the same device: ``generate``,
        ``beam_search`` and the paged engine take it.  Not under the
        model or seq axis: the sharded ``forward_with_cache`` and
        ``generate`` are ROADMAP Queue 1 item 14e."""
        if self.tp is not None or self.sp is not None:
            raise NotImplementedError(
                "a sharded model's serving() (the sharded forward_with_cache "
                "and generate) is not ported yet: ROADMAP Queue 1 item 14e")
        tree = tree_lib.map_leaves(lambda _, v: v.detach().clone(),
                                   self.param_tree())
        return CausalLm(self.cfg, tree).to(self.tok_emb.device)
