"""One rank of the 2-rank gloo world of ``tests/test_torch_data_axis.py``.

    python tests/_torch_dp_worker.py RANK WORLD PORT WORKDIR MNIST_DIR

Imports torch, numpy and ``mpi_tensorflow_torch`` only (no JAX, no
conftest): the parent computes the reference's side and writes the
inputs to ``WORKDIR/inputs.npz``; this rank joins the world at
``tcp://127.0.0.1:PORT`` over gloo, on one thread, and writes what it
computed to ``WORKDIR/rank<RANK>.npz``:

- ``host_shard`` by the group's rank;
- each collective on a rank-distinct float32 array;
- the CNN trained through ``loop.train`` under psum and under avg50 (the
  reference's init on rank 0, another on rank 1, which the loop's
  broadcast must replace), its history, trace lines, parameters,
  velocity and step counter, at the end and right after each average;
- the average step and the sharded eval on this rank's own injected
  replica;
- a tiny ResNet (``RESNET``: one basic block a stage) trained through
  ``loop.train`` under psum on a small synthetic image set
  (``RESNET_SPLIT``), from the reference's injected parameters: its
  history, parameters and BatchNorm state at the end; and avg50's
  average step on this rank's injected ResNet replica (parameters,
  velocity, BatchNorm state).
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import torch

# the loop runs (the reference's side uses the same values)
LOOP = dict(epochs=1, batch_size=64, log_every=3, dropout_rate=0.0,
            fused_steps=1)
SPLIT = dict(train_n=1200, test_n=256)
EVAL_ROWS, EVAL_BATCH = 200, 128        # two windows, the tail overlapped
# the ResNet case: one basic block in each of two stages, 8x8 images,
# 55 train rows (27 a rank: 6 steps of 4), a trace every 3 steps
RESNET = dict(stage_sizes=(1, 1), widths=(8, 16), bottleneck=False,
              cifar_stem=True)
RESNET_SPLIT = dict(train_n=60, test_n=16, size=8, channels=3,
                    num_classes=10)
RESNET_LOOP = dict(epochs=1, batch_size=4, log_every=3, fused_steps=1)
RESNET_STEP = 5.0                       # the replicas' step counter


def _tree(npz, prefix: str) -> dict:
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


def _model(jax_params: dict):
    from mpi_tensorflow_torch.models import cnn, convert

    return cnn.MnistCnn(convert.cnn_params_from_jax(jax_params),
                        dropout_rate=0.0)


def _save_state(out: dict, prefix: str, state) -> None:
    from mpi_tensorflow_torch.models import cnn, convert

    for k, v in convert.cnn_params_to_numpy(
            state.model.param_tree()).items():
        out[f"{prefix}param/{k}"] = v
    for k, v in convert.cnn_params_to_numpy(
            dict(zip(cnn.NAMES, state.opt.velocity))).items():
        out[f"{prefix}velocity/{k}"] = v
    out[f"{prefix}step"] = np.float32(state.opt.step)


def resnet_cases(rank: int, inputs, out: dict) -> None:
    from _torch_tdp_worker import flatten, unflatten
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.data import synthetic
    from mpi_tensorflow_torch.models import convert, resnet
    from mpi_tensorflow_torch.train import loop, optimizer, step
    from mpi_tensorflow_torch.utils import tree as tree_lib

    geo = resnet.Geometry(**RESNET)
    inputs = dict(inputs)
    params = convert.resnet_params_from_jax(unflatten(inputs, "resnet_init"))
    if rank:                     # the loop's broadcast makes it rank 0's
        params["fc"] = {k: v + 0.5 for k, v in params["fc"].items()}
    cfg = Config(**RESNET_LOOP, mesh_shape={"data": 2})
    with contextlib.redirect_stdout(io.StringIO()):
        res = loop.train(cfg, model=resnet.ResNet(geo, params),
                         splits=synthetic.image_classification(
                             **RESNET_SPLIT), device="cpu")
    out["resnet/psum/history"] = np.array(res.history, dtype=np.float64)
    out.update(flatten(convert.resnet_params_to_numpy(
        res.state.model.param_tree()), "resnet/psum/params"))
    out.update(flatten(convert.params_to_numpy(
        res.state.model_state), "resnet/psum/state"))
    # avg50's average of this rank's injected replica
    pre = f"resnet_replica{rank}"
    model = resnet.ResNet(geo, convert.resnet_params_from_jax(
        unflatten(inputs, f"{pre}/params")))
    state = step.init_state(model)
    # the reference's trees (keys sorted), put in the model's order

    def in_order(src, like):
        return tree_lib.map_leaves(lambda path, _: tree_lib.at(src, path),
                                   like)

    velocity = convert.resnet_params_from_jax(unflatten(
        inputs, f"{pre}/velocity"))
    state.opt = optimizer.MomentumState(tree_lib.leaves(in_order(
        velocity, model.param_tree())), np.float32(RESNET_STEP))
    state.model_state = in_order(convert.params_from_jax(
        unflatten(inputs, f"{pre}/state")), state.model_state)
    state = step.make_average_step(state)(state)
    out["resnet/average/step"] = np.float32(state.opt.step)
    out.update(flatten(convert.resnet_params_to_numpy(model.param_tree()),
                       "resnet/average/params"))
    out.update(flatten(convert.resnet_params_to_numpy(tree_lib.unflatten(
        model.param_tree(), state.opt.velocity)), "resnet/average/velocity"))
    out.update(flatten(convert.params_to_numpy(state.model_state),
                       "resnet/average/state"))


def collectives_case(rank: int, out: dict) -> None:
    from mpi_tensorflow_torch.data import sharding
    from mpi_tensorflow_torch.parallel import collectives

    out["host_shard"] = sharding.host_shard(np.arange(101))
    out["axis_index"] = np.int64(collectives.axis_index())
    x = np.random.default_rng(rank).normal(size=(3, 5)).astype(np.float32)
    for name in ("allreduce_sum", "allreduce_mean", "allreduce_max",
                 "pbroadcast"):
        out[f"coll/{name}"] = getattr(collectives, name)(
            torch.from_numpy(x.copy())).numpy()
    out["coll/allgather"] = collectives.allgather(torch.from_numpy(x)).numpy()
    out["coll/host_allgather"] = collectives.host_allgather(x)
    collectives.barrier()


def loop_case(rank: int, sync: str, inputs, mnist_dir: str,
              out: dict) -> None:
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.data import mnist
    from mpi_tensorflow_torch.train import loop, step

    init = _tree(inputs, "init/")
    if rank:                     # the loop's broadcast makes it rank 0's
        init = {k: v + np.float32(0.5) for k, v in init.items()}
    cfg = Config(**LOOP, sync=sync, mesh_shape={"data": 2})
    splits = mnist.load_splits(mnist_dir, num_shards=2, **SPLIT)
    make_average = step.make_average_step

    def recording_average(state):
        """The loop's average step, recording the state it leaves."""
        average = make_average(state)

        def call(state):
            state = average(state)
            _save_state(out, f"{sync}/averaged/", state)
            return state
        return call

    step.make_average_step = recording_average
    try:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = loop.train(cfg, model=_model(init), splits=splits,
                             device="cpu")
    finally:
        step.make_average_step = make_average
    out[f"{sync}/lines"] = np.array(text.getvalue().splitlines(), dtype=str)
    out[f"{sync}/history"] = np.array(res.history, dtype=np.float64)
    out[f"{sync}/num_steps"] = np.int64(res.num_steps)
    out[f"{sync}/num_devices"] = np.int64(res.num_devices)
    out[f"{sync}/images_per_sec"] = np.float64(res.images_per_sec)
    out[f"{sync}/final_loss"] = np.float64(res.final_loss)
    _save_state(out, f"{sync}/", res.state)


def replica_cases(rank: int, inputs, mnist_dir: str, out: dict) -> None:
    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.data import mnist
    from mpi_tensorflow_torch.models import cnn, convert
    from mpi_tensorflow_torch.train import evaluation, optimizer, step

    model = _model(_tree(inputs, f"replica{rank}/"))
    state = step.init_state(model)
    vel = convert.cnn_params_from_jax(_tree(inputs, f"velocity{rank}/"))
    state.opt = optimizer.MomentumState([vel[k] for k in cnn.NAMES],
                                        np.float32(inputs["step"]))
    eval_step = step.make_eval_step(model, Config(**LOOP))
    test = mnist.load_splits(mnist_dir, num_shards=2, **SPLIT).test_data
    out["eval/preds"] = evaluation.eval_sharded(
        lambda x: eval_step(state, torch.from_numpy(x)).numpy(),
        test[:EVAL_ROWS], EVAL_BATCH, rank, 2)
    _save_state(out, "average/", step.make_average_step(state)(state))


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    workdir, mnist_dir = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    from mpi_tensorflow_torch.parallel import mesh

    mesh.initialize_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    try:
        collectives_case(rank, out)
        for sync in ("psum", "avg50"):
            loop_case(rank, sync, inputs, mnist_dir, out)
        replica_cases(rank, inputs, mnist_dir, out)
        resnet_cases(rank, inputs, out)
    finally:
        mesh.shutdown()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
