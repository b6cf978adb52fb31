"""Tensor-parallel paged decode over ``torch.distributed``.

Counterpart of ``mpi_tensorflow_tpu/serving/tp.py``.  The reference is
one process: a ``shard_map`` over a ``tp`` mesh axis.  Here each of the
``tp`` ranks is a process of its own (``torchrun --nproc_per_node T -m
mpi_tensorflow_torch.serving --serve-tp T``), NCCL between cards and
gloo on the CPU, and each rank runs the whole engine on its shard:

- the pools hold ``H / tp`` heads on axis 1 of ``(num_blocks, H,
  block_size, D)``, so every rank's paged kernel runs over its own heads;
- wq, wk, wv (and their biases) split by columns on the heads, wo by
  rows; w1 and b1 by columns on the MLP, w2 by rows.  The LayerNorms,
  the embeddings and the LM head are replicated;
- one ``all_reduce`` a row-parallel product (two a layer), applied
  BEFORE the bias (``models/gpt.forward_paged``'s ``reduce``), rebuilds
  the replicated residual stream, so every rank computes the same
  logits and emits the same greedy tokens;
- block tables, tokens and lengths are replicated: one block id names
  the same slot of every rank's pool, so the host scheduler, allocator
  and trie need no knowledge of ``tp``.

Every rank runs the same host scheduler.  A host decision that reads
the wall clock (admission against ``arrival``, the deadline sweep, the
drain) would part the ranks and hang the next collective, so rank 0 owns
the clock and the stop flag: ``agree`` broadcasts its ``now`` and
``should_stop`` once an iteration, and every rank decides from those.

A fleet of tensor-parallel replicas (``serving/router``) runs the router
on every rank over its shards of the replicas, in lock step: one
replica after another on the calling thread (never a thread each, which
would order the collectives differently on each rank), each router pass
deciding placement, health, failover and the drain from one ``agree``.
A journal (``recovery.ReplayJournal``) is rank 0's file and, on every
other rank, its mirror in memory: every rank replays the same requests,
and a relaunch resumes on every rank.  Only rank 0 writes the journal
and traces; the caller prints on rank 0 alone.

The split is this module's own copy: the reference takes it from
``parallel/sharding_rules.py``, not ported yet (ROADMAP Queue 1 item
14).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world() -> tuple:
    """``(rank, size)`` of the process group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collective(tp: int) -> bool:
    """Whether an engine of ``tp`` ranks runs the collective path (the
    sums and the clock broadcast): when this process is in a world of
    exactly ``tp`` ranks: the caller asks for it by joining one (the
    serving entry points join only under ``--serve-tp``).  ``tp = 1`` in
    a world of one takes it too (``torchrun --nproc_per_node 1 ...
    --serve-tp 1``: NCCL at world 1)."""
    return world()[1] == tp and dist.is_available() \
        and dist.is_initialized()


def check_geometry(cfg, tp: int) -> None:
    """Reject a ``tp`` the model or the world cannot honour: it must be
    the world size, and divide both the heads and the MLP width."""
    if tp < 1:
        raise ValueError(f"--serve-tp must be >= 1, got {tp}")
    if tp == 1:
        return
    if cfg.heads % tp or cfg.mlp % tp:
        raise ValueError(
            f"--serve-tp {tp} must divide both heads ({cfg.heads}) and "
            f"mlp ({cfg.mlp}): the pool shards on the head axis and the "
            f"MLP up-projection on its hidden axis")
    _, size = world()
    if size != tp:
        raise ValueError(
            f"--serve-tp {tp} needs a torch.distributed world of {tp} "
            f"ranks (torchrun --nproc_per_node {tp}); this process is in "
            f"a world of {size}")


def _cut(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous().clone()


def shard_layer(layer, rank: int, tp: int) -> dict:
    """This rank's slice of one ``EncoderLayer``, as a parameter tree:
    wq/wk/wv (E, H, D) and bq/bk/bv (H, D) on the heads, wo (H, D, E) on
    its rows, w1 (E, mlp) and b1 on the MLP, w2 (mlp, E) on its rows;
    the biases of the row-parallel products and the LayerNorms whole."""
    t = layer.tree()
    out = {k: t[k].detach() for k in ("bo", "b2")}
    for k in ("wq", "wk", "wv"):
        out[k] = _cut(t[k].detach(), 1, rank, tp)
    for k in ("bq", "bk", "bv", "wo", "w2"):
        out[k] = _cut(t[k].detach(), 0, rank, tp)
    out["w1"] = _cut(t["w1"].detach(), 1, rank, tp)
    out["b1"] = _cut(t["b1"].detach(), 0, rank, tp)
    out["ln1"] = {k: v.detach() for k, v in t["ln1"].items()}
    out["ln2"] = {k: v.detach() for k, v in t["ln2"].items()}
    return out


def shard_model(model, rank: int, tp: int):
    """A ``CausalLm`` holding rank ``rank`` of ``tp``'s heads and MLP
    slice of every layer, the rest replicated; its config stays the
    whole model's (the layers take their shapes from their weights)."""
    from mpi_tensorflow_torch.models.gpt import CausalLm

    tree = {
        "tok_emb": model.tok_emb.detach(),
        "pos_emb": model.pos_emb.detach(),
        "emb_ln": {k: v.detach() for k, v in model.emb_ln.tree().items()},
        "layers": [shard_layer(layer, rank, tp) for layer in model.layers],
        "mlm": {"w": model.mlm.w.detach(), "b": model.mlm.b.detach(),
                "ln": {k: v.detach()
                       for k, v in model.mlm.ln.tree().items()},
                "out_b": model.mlm.out_b.detach()},
    }
    return CausalLm(model.cfg, tree)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The ``reduce`` hook: the sum of ``x`` over the ranks, in place."""
    dist.all_reduce(x)
    return x


def agree(now: float, stop: bool) -> tuple:
    """Rank 0's ``(now, stop)`` on every rank: one broadcast of a host
    tensor an iteration (gloo, beside NCCL on a card)."""
    t = torch.tensor([now, float(stop)], dtype=torch.float64)
    dist.broadcast(t, 0)
    return float(t[0]), bool(t[1])

