"""One rank of the 2-rank gloo world of ``tests/test_torch_transformer_dp.py``.

    python tests/_torch_tdp_worker.py RANK WORLD PORT WORKDIR

Imports torch, numpy and ``mpi_tensorflow_torch`` only (no JAX, no
conftest): the parent writes the inputs to ``WORKDIR/inputs.npz`` and
computes the reference's side; this rank joins the world at
``tcp://127.0.0.1:PORT`` over gloo, on one thread, and writes what it
computed to ``WORKDIR/rank<RANK>.npz``:

- ``reduce_scatter`` and the tiled ``allgather`` on rank-distinct arrays;
- ``STEPS`` train steps of BERT_TINY (at ``LAYERS`` layer) in each
  layout of ``CASES`` from the injected parameters, each rank feeding
  its rows of every global batch
  (``mlm_loop.rank_rows``): the losses, the parameters after them, and
  the bytes at rest; and the control that averages per-rank mean losses
  instead;
- ``train_mlm`` over the world with ``grad_accum`` 2: the token rows fed
  to each train and eval step, the history, the printed lines;
- the CNN's psum step with ``grad_accum`` 2 across the ranks.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import torch

S, GLOBAL_B, STEPS, LR, NUM_STEPS = 32, 4, 3, 1e-3, 16
# BERT_TINY's widths at one layer of its two: the reference's compile of
# each step variant is most of the file's time on one core, and a second
# identical layer adds nothing the first does not hold
LAYERS = 1
# (name, param_sharding, grad_accum)
CASES = (("replicated", "replicated", 1), ("accum2", "replicated", 2),
         ("zero1", "zero1", 1), ("fsdp", "fsdp", 1))
# train_mlm over the world: 64 train rows, global batch 4, 16 steps
MLM = dict(seq_len=S, train_n=64, test_n=16, learning_rate=LR)
MLM_CONFIG = dict(model="bert_base", epochs=1, batch_size=GLOBAL_B // 2,
                  log_every=4, seed=1, grad_accum=2)
CNN_B, CNN_STEPS = 8, 3                 # rows per shard, steps


def flatten(tree, prefix: str) -> dict:
    """A nested dict/list tree as ``{prefix + path: leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}"))
    return out


def unflatten(flat: dict, prefix: str):
    """The inverse of ``flatten`` (integer path parts are list
    indices)."""
    root = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def collectives_case(rank: int, out: dict) -> None:
    from mpi_tensorflow_torch.parallel import collectives

    x = np.random.default_rng(10 + rank).normal(size=(4, 3)).astype(
        np.float32)
    out["coll/reduce_scatter"] = collectives.reduce_scatter(
        torch.from_numpy(x)).numpy()
    out["coll/allgather_tiled"] = collectives.allgather(
        torch.from_numpy(x[:2]), tiled=True).numpy()


def tiny():
    import dataclasses

    from mpi_tensorflow_torch.models import bert

    return dataclasses.replace(bert.BERT_TINY, layers=LAYERS)


def _model(inputs):
    from mpi_tensorflow_torch.models import bert, convert

    return bert.BertMlm(tiny(), convert.params_from_jax(
        unflatten(dict(inputs), "init")))


def _batch(inputs, t: int, rows):
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[t][rows]))
    return ({"tokens": put(inputs["tokens"]), "mask": put(inputs["mask"])},
            put(inputs["targets"]))


def _params(state) -> dict:
    from mpi_tensorflow_torch.models import convert
    from mpi_tensorflow_torch.train import gspmd

    with gspmd.full_params(state) as model:
        return convert.params_to_numpy(model.param_tree())


def steps_cases(rank: int, world: int, inputs, out: dict) -> None:
    from mpi_tensorflow_torch.train import gspmd, mlm_loop, optimizer

    for name, kind, accum in CASES:
        tx = optimizer.transformer_tx(LR, NUM_STEPS)
        state = gspmd.init_for(kind, _model(inputs), tx)
        step = gspmd.make_train_step(tx, grad_accum=accum)
        rows = mlm_loop.rank_rows(0, GLOBAL_B, accum, rank, world)
        losses = [float(step(state, *_batch(inputs, t, rows))[1]["loss"])
                  for t in range(STEPS)]
        out[f"{name}/losses"] = np.array(losses)
        out[f"{name}/rows"] = rows
        out.update(flatten(_params(state), f"{name}/params"))
        for k, v in gspmd.bytes_at_rest(state).items():
            out[f"{name}/bytes/{k}"] = np.int64(v)
    control_case(rank, world, inputs, out)


def control_case(rank: int, world: int, inputs, out: dict) -> None:
    """The wrong step: each rank's own mean loss over its rows, the
    gradients and losses averaged over the ranks."""
    from mpi_tensorflow_torch.parallel import collectives
    from mpi_tensorflow_torch.train import gspmd, mlm_loop, optimizer
    from mpi_tensorflow_torch.utils import tree as tree_lib

    tx = optimizer.transformer_tx(LR, NUM_STEPS)
    model = _model(inputs)
    state = gspmd.init_state(model, tx)
    rows = mlm_loop.rank_rows(0, GLOBAL_B, 1, rank, world)
    losses = []
    for t in range(STEPS):
        batch, labels = _batch(inputs, t, rows)
        loss = model.loss(batch, labels, train=True)
        loss.backward()
        params = tree_lib.leaves(model.param_tree())
        grads = [collectives.allreduce_mean(p.grad) for p in params]
        tx.update(model.param_tree(), grads, state.opt)
        model.zero_grad(set_to_none=True)
        losses.append(float(collectives.allreduce_mean(loss.detach())))
    out["control/losses"] = np.array(losses)
    out.update(flatten(_params(state), "control/params"))


def mlm_case(rank: int, inputs, out: dict) -> None:
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import bert, convert
    from mpi_tensorflow_torch.train import gspmd, mlm_loop

    init = convert.params_from_jax(unflatten(dict(inputs), "init"))
    fed = []
    make_train, make_eval = gspmd.make_train_step, gspmd.make_eval_step

    def recording(make, train):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def call(state, batch, *rest):
                tok = batch["tokens"] if train else batch
                fed.append((train, tok.numpy().copy()))
                return step(state, batch, *rest)
            return call
        return wrapped

    gspmd.make_train_step = recording(make_train, True)
    gspmd.make_eval_step = recording(make_eval, False)
    init_params = bert.init_params
    bert.init_params = lambda cfg, gen: init
    try:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = mlm_loop.train_mlm(Config(**MLM_CONFIG), tiny(),
                                     device="cpu", **MLM)
    finally:
        gspmd.make_train_step, gspmd.make_eval_step = make_train, make_eval
        bert.init_params = init_params
    out["mlm/lines"] = np.array(text.getvalue().splitlines(), dtype=str)
    out["mlm/train"] = np.array([t for t, _ in fed])
    out["mlm/tokens"] = np.stack([x for _, x in fed])
    out["mlm/history"] = np.array(res.history, dtype=np.float64)
    out["mlm/num_steps"] = np.int64(res.num_steps)
    out["mlm/num_devices"] = np.int64(res.num_devices)
    out["mlm/final_loss"] = np.float64(res.final_loss)


def cnn_case(rank: int, inputs, out: dict) -> None:
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import cnn, convert
    from mpi_tensorflow_torch.train import step

    model = cnn.MnistCnn(convert.cnn_params_from_jax(
        unflatten(dict(inputs), "cnn")), dropout_rate=0.0)
    state = step.init_state(model)
    train_step = step.make_train_step(
        model, Config(grad_accum=2, dropout_rate=0.0), 1, 100,
        across_ranks=True)
    mine = slice(rank * CNN_B, (rank + 1) * CNN_B)
    for t in range(CNN_STEPS):
        train_step(state, torch.from_numpy(inputs["cnn_x"][t][mine]),
                   torch.from_numpy(inputs["cnn_y"][t][mine]))
    out.update(flatten(convert.cnn_params_to_numpy(model.param_tree()),
                       "cnn/params"))


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    workdir = sys.argv[4]
    torch.set_num_threads(1)
    from mpi_tensorflow_torch.parallel import mesh

    mesh.initialize_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    try:
        collectives_case(rank, out)
        steps_cases(rank, world, inputs, out)
        mlm_case(rank, inputs, out)
        cnn_case(rank, inputs, out)
    finally:
        mesh.shutdown()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
