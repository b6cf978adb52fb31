"""One rank of the 4-rank gloo world of ``tests/test_torch_tp_sp.py``.

    python tests/_torch_tpsp_worker.py RANK WORLD PORT WORKDIR

Imports torch, numpy and ``mpi_tensorflow_torch`` only (no JAX, no
conftest): the parent writes the inputs to ``WORKDIR/inputs.npz`` and
computes the reference's side; this rank joins the world at
``tcp://127.0.0.1:PORT`` over gloo, on one thread, and writes what it
computed to ``WORKDIR/rank<RANK>.npz``:

- ``vocab_parallel_ce`` (dense and tiled) on ``{"model": 4}``: its
  distance from the whole vocabulary's CE and gradients; and
  ``vocab_parallel_argmax`` there of logits with planted ties;
- ``ring_attention`` (causal or not, ``block_k`` None or 8) and
  ``ulysses_attention`` (its inner attention the flash kernels' plain
  version) on a ``{"seq": 4}`` mesh: this rank's block of the output
  and of the gradients of q, k, v;
- ``STEPS`` train steps of BERT_TINY (one layer, 8 heads) on each mesh of
  ``CASES`` from the injected parameters, and of the causal family on
  ``GPT_CASE``: the losses, and on rank 0 the parameters gathered whole;
  then each trained model's predictions on one eval window (the first
  step's rows), this rank's block and on rank 0 every rank's placed
  whole by ``mlm_loop.place_predictions``;
- ``DROPOUT_CASE``: the same at dropout 0.1, every rank's own blocks;
- ``CKPT_CASE``'s run also writes a sharded checkpoint after
  ``CKPT_AT`` steps to ``WORKDIR/ckpt``;
- ``train_mlm`` of ``MLM_RUNS``: the history, the last loss, the lines
  printed; and its refusal of a length the seq axis does not divide;
- the subgroups the meshes above made, and whether a second mesh of
  one shape reuses them.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from _torch_tdp_worker import flatten, unflatten

S, GLOBAL_B, STEPS, LR, NUM_STEPS = 32, 4, 3, 1e-3, 16
# BERT_TINY's widths at one layer, with 8 heads of 8 (its 4 of 16 leave
# one head a rank after Ulysses' all-to-all on {model: 2, seq: 2}, and
# a single head hides a head-order fault)
LAYERS, HEADS = 1, 8
# ring_attention / ulysses_attention inputs: (B, H, S, D) on seq = 4
ATTN_SHAPE = (2, 8, 32, 16)
ATTN_CASES = tuple((causal, bk) for causal in (False, True)
                   for bk in (None, 8))
# (name, mesh, sp_impl, param_sharding)
CASES = (("mxs_ring", {"model": 2, "seq": 2}, "ring", "replicated"),
         ("mxs_ulysses", {"model": 2, "seq": 2}, "ulysses", "replicated"),
         ("dxm", {"data": 2, "model": 2}, "ring", "replicated"),
         ("dxs", {"data": 2, "seq": 2}, "ring", "replicated"),
         ("dxm_zero1", {"data": 2, "model": 2}, "ring", "zero1"),
         ("dxm_fsdp", {"data": 2, "model": 2}, "ring", "fsdp"),
         ("dxs_fsdp", {"data": 2, "seq": 2}, "ring", "fsdp"))
GPT_CASE = ("gpt_mxs_ring", {"model": 2, "seq": 2}, "ring", "replicated")
DROPOUT_CASE = ("dropout", {"model": 2, "seq": 2}, "ring", "replicated")
DROPOUT = 0.1
CKPT_CASE = CASES[0]         # its run saves a checkpoint on the way
CKPT_AT = 2
# train_mlm over the world: 32 train rows, global batch 4, 8 steps
MLM = dict(seq_len=S, train_n=32, test_n=8, learning_rate=LR)
MLM_RUNS = (("bert_base", {"model": 2, "seq": 2}, 4),
            ("gpt_base", {"data": 2, "seq": 2}, 2))    # (model, mesh, bs)


def tiny(sp_impl: str = "ring", dropout: float = 0.0):
    from mpi_tensorflow_torch.models import bert

    return dataclasses.replace(bert.BERT_TINY, layers=LAYERS, heads=HEADS,
                               sp_impl=sp_impl, dropout=dropout)


def attention_cases(inputs, out: dict) -> None:
    from mpi_tensorflow_torch.ops.flash_attention import flash_attention
    from mpi_tensorflow_torch.parallel import mesh as meshlib
    from mpi_tensorflow_torch.parallel.ring import ring_attention
    from mpi_tensorflow_torch.parallel.ulysses import ulysses_attention

    mesh = meshlib.make_mesh({"seq": 4})
    axis = mesh.group("seq")
    n = ATTN_SHAPE[2] // 4
    mine = slice(axis.index * n, (axis.index + 1) * n)

    def run(name, fn):
        xs = [torch.from_numpy(inputs[f"attn/{k}"][:, :, mine].copy())
              .requires_grad_() for k in "qkv"]
        o = fn(*xs)
        o.backward(torch.from_numpy(inputs["attn/g"][:, :, mine].copy()))
        out[f"{name}/out"] = o.detach().numpy()
        for k, x in zip("qkv", xs):
            out[f"{name}/d{k}"] = x.grad.numpy()

    for causal, bk in ATTN_CASES:
        run(f"attn/ring/{causal}/{bk}", lambda q, k, v: ring_attention(
            q, k, v, axis, causal=causal, block_k=bk))
    for causal in (False, True):
        run(f"attn/ulysses/{causal}", lambda q, k, v: ulysses_attention(
            q, k, v, axis, causal=causal, inner=flash_attention))


# the vocabulary-parallel CE on {model: 4} against the whole vocabulary's
# (chunk None: dense; 100: tiles that do not divide a rank's 256 rows)
CE_SHAPE, CE_CHUNKS = (2, 5, 16), (None, 100)
# vocab_parallel_argmax on {model: 4}: (B, S, V) logits, 16 columns a
# rank; each (position, columns) ties the row's maximum across two ranks'
# slices, at a slice's edge, within one slice, and over all four
ARGMAX_SHAPE = (2, 3, 64)
ARGMAX_TIES = (((0, 0), (3, 20)), ((0, 1), (20, 37)), ((0, 2), (15, 16)),
               ((1, 0), (48, 63)), ((1, 1), (10, 30, 50, 60)))


def ce_cases(inputs, out: dict) -> None:
    from mpi_tensorflow_torch.ops import mlm_head
    from mpi_tensorflow_torch.parallel import mesh as meshlib

    axis = meshlib.make_mesh({"model": 4}).group("model")
    rows = inputs["ce/emb"].shape[0] // 4
    mine = slice(axis.index * rows, (axis.index + 1) * rows)
    labels = torch.from_numpy(inputs["ce/labels"])
    g = torch.from_numpy(inputs["ce/g"])
    for chunk in CE_CHUNKS:
        t, emb, b = (torch.from_numpy(inputs[f"ce/{k}"].copy())
                     .requires_grad_() for k in ("t", "emb", "b"))
        whole = mlm_head.tied_softmax_ce(t, emb, b, labels, chunk=64)
        whole.backward(g)
        want = [whole.detach(), t.grad, emb.grad[mine], b.grad[mine]]
        t2, emb2, b2 = (x.detach()[sl].clone().requires_grad_() for x, sl in
                        ((t, slice(None)), (emb, mine), (b, mine)))
        got = mlm_head.vocab_parallel_ce(t2, emb2, b2, labels, axis,
                                         chunk=chunk)
        got.backward(g)
        out[f"ce/{chunk}"] = np.array([float((x - y).abs().max()) for x, y in
                                       zip([got.detach(), t2.grad, emb2.grad,
                                            b2.grad], want)])
    per = ARGMAX_SHAPE[2] // 4
    logits = torch.from_numpy(inputs["argmax/logits"])
    out["argmax/ids"] = mlm_head.vocab_parallel_argmax(
        logits[..., axis.index * per:(axis.index + 1) * per].contiguous(),
        axis).numpy()


def _run(inputs, case, rank_out: dict, steps: int = STEPS,
         dropout: float = 0.0, family: str = "bert", ckpt_dir=None):
    """``case`` from the injected parameters: the losses, and the state."""
    from mpi_tensorflow_torch.models import bert, convert, gpt
    from mpi_tensorflow_torch.parallel import mesh as meshlib
    from mpi_tensorflow_torch.train import (checkpoint, gspmd, mlm_loop,
                                            optimizer, state_io)

    name, shape, sp_impl, kind = case
    mesh = meshlib.make_mesh(shape)
    cls = gpt.TrainableCausalLm if family == "gpt" else bert.BertMlm
    model = cls(tiny(sp_impl, dropout), convert.params_from_jax(
        unflatten(dict(inputs), "init")), mesh=mesh)
    tx = optimizer.transformer_tx(LR, NUM_STEPS)
    state = gspmd.init_for(kind, model, tx)
    step = gspmd.make_train_step(tx)
    D, N = mesh.axis_size("data"), mesh.axis_size("seq")
    rows = mlm_loop.rank_rows(0, GLOBAL_B, 1, mesh.axis_index("data"), D)
    n = S // N
    cols = slice(mesh.axis_index("seq") * n, (mesh.axis_index("seq") + 1) * n)
    drop = mesh.group("data", "seq").index
    losses = []
    for t in range(steps):
        if ckpt_dir is not None and t == CKPT_AT:
            checkpoint.save_sharded(os.path.join(ckpt_dir, "ckpt"),
                                    state_io.parts(state), step=t)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(
            a[t][rows][:, cols]))
        gen = gspmd.step_generator(5, t, "cpu", drop) if dropout else None
        _, m = step(state, {"tokens": put(inputs["tokens"]),
                            "mask": put(inputs["mask"])},
                    put(inputs["targets"]), gen)
        losses.append(float(m["loss"]))
    rank_out[f"{name}/losses"] = np.array(losses)
    if state.sharding is not None:
        rank_out[f"{name}/dims"] = np.array(
            [-1 if d is None else d for d in state.sharding.dims])
    return state


def eval_predictions(inputs, name: str, state, rank: int,
                     out: dict) -> None:
    """``train_mlm``'s eval of ``state`` on one window, the first step's
    rows: this rank's rows (by its data coordinate) and positions (by
    its seq coordinate), the argmax over the vocabulary, then every
    rank's placed whole as ``train_mlm`` places them."""
    from mpi_tensorflow_torch.parallel import collectives
    from mpi_tensorflow_torch.train import gspmd, mlm_loop

    mesh = state.model.mesh
    bs, n = GLOBAL_B // mesh.axis_size("data"), S // mesh.axis_size("seq")
    d, q = mesh.axis_index("data"), mesh.axis_index("seq")
    tokens = torch.from_numpy(np.ascontiguousarray(
        inputs["tokens"][0][d * bs:(d + 1) * bs, q * n:(q + 1) * n]))
    pred = state.model.vocab_argmax(
        gspmd.make_eval_step()(state, tokens)).numpy()
    out[f"{name}/pred"] = pred
    placed = mlm_loop.place_predictions(
        collectives.host_allgather(pred[None]), mesh, bs, n)
    if rank == 0:
        out[f"{name}/placed"] = placed[0]


def mlm_runs(rank: int, out: dict) -> None:
    import contextlib
    import io

    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.train import mlm_loop

    for family, shape, bs in MLM_RUNS:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = mlm_loop.train_mlm(
                Config(model=family, epochs=1, batch_size=bs, log_every=4,
                       seed=1, mesh_shape=shape), tiny(), device="cpu",
                **MLM)
        out[f"mlm/{family}/history"] = np.array(res.history)
        out[f"mlm/{family}/final_loss"] = np.float64(res.final_loss)
        out[f"mlm/{family}/num_devices"] = np.int64(res.num_devices)
        out[f"mlm/{family}/lines"] = np.array(text.getvalue().splitlines())
    try:
        mlm_loop.train_mlm(Config(model="bert_base", batch_size=4,
                                  mesh_shape={"model": 2, "seq": 2}),
                           tiny(), device="cpu", **dict(MLM, seq_len=31))
    except ValueError as e:
        out["refusal/seq_len"] = np.array(str(e))


def main() -> int:
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    from mpi_tensorflow_torch.models import convert
    from mpi_tensorflow_torch.parallel import mesh as meshlib
    from mpi_tensorflow_torch.train import gspmd

    meshlib.initialize_distributed("cpu", init_method=f"tcp://127.0.0.1:"
                                   f"{port}", rank=rank, world_size=world)
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    out = {}
    attention_cases(inputs, out)
    ce_cases(inputs, out)
    for case in CASES + (GPT_CASE,):
        state = _run(inputs, case, out,
                     family="gpt" if case is GPT_CASE else "bert",
                     ckpt_dir=workdir if case is CKPT_CASE else None)
        whole = convert.params_to_numpy(gspmd.gathered_params(state))
        if rank == 0:
            out.update(flatten(whole, f"{case[0]}/params"))
        eval_predictions(inputs, case[0], state, rank, out)
    state = _run(inputs, DROPOUT_CASE, out, dropout=DROPOUT)
    out.update(flatten(convert.params_to_numpy(state.model.param_tree()),
                       "dropout/own"))
    mlm_runs(rank, out)
    out["mesh/subgroups"] = np.int64(len(meshlib._SUBGROUPS))
    twice = [meshlib.make_mesh({"model": 2, "seq": 2}) for _ in range(2)]
    out["mesh/reused"] = np.bool_(all(
        twice[0].group(a).group is twice[1].group(a).group is not None
        for a in ("model", "seq")))
    out["seconds"] = np.float64(time.perf_counter() - t0)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    meshlib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
