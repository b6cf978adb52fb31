"""The scanned arm of the image family, on the CPU (on the card the same
calls are CUDA graph replays, ``train/graphs.py``; ``chip_smoke.py``
phase 21 holds those against these eager steps):

- ``step.make_multi_train_step`` against the reference's
  ``make_multi_train_step`` on a 1-device mesh, unmasked (K = 3 steps)
  and masked (``n_valid`` = 2 of K = 3): the CNN at dropout 0 and the
  tiny ResNet with its BatchNorm state, from the same parameters; the
  losses, parameters, velocity and state within 1e-5, and the padded
  step's loss and LR 0;
- ``step.make_multi_eval_step`` against the reference's
  ``make_multi_eval_step`` over every eval window, the overlapped tail
  window included: ``evaluation.rank_windows`` is the reference's
  ``stack_eval_windows`` and the probabilities within 1e-6; the fused
  evaluation equals the one-window-at-a-time ``eval_sharded``;
- dropout on: the multi-step equals K single steps fed
  ``step_generator``'s generators, bit for bit, and ``stop`` ends the
  window after the step it returns True for;
- the device tables: ``StepTable`` rows equal the host schedules bit
  for bit over a whole run (the reference's staircase decay over 20000
  steps; warmup_linear and warmup_cosine and adamw's bias corrections
  over 10000);
- ``loop.window_schedule``'s distinct widths, the graphs the loop
  captures (51, 50 and the tail; a resume inside a window adds one),
  as ``prepare`` returns them;
- ``bench --scan-steps``: the line's ``scan_steps`` and timed steps.

The reference compiles with XLA's optimisation passes off.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import fast
from _torch_resnet_inputs import TINY, jax_net, net_inputs
from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.models import cnn as jax_cnn
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import evaluation as jax_evaluation
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_torch import bench
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import cnn, convert, resnet
from mpi_tensorflow_torch.train import evaluation, gspmd, loop, optimizer
from mpi_tensorflow_torch.train import step as step_lib

K, B, DECAY = 3, 4, 8
SIZES = {"cnn": 8, "resnet": 9}


def _nets(name):
    """``(reference model, its params, its model state, the port's
    model)`` from one set of parameters."""
    if name == "cnn":
        jm = jax_cnn.MnistCnn(image_size=8, dropout_rate=0.0)
        params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
        return jm, params, {}, cnn.MnistCnn(
            convert.cnn_params_from_jax(params), image_size=8,
            dropout_rate=0.0)
    params, state = net_inputs("basic", seed=3)
    geo = resnet.Geometry(**{k: TINY["basic"][k] for k in (
        "stage_sizes", "widths", "bottleneck", "cifar_stem")})
    port = resnet.ResNet(geo, convert.resnet_params_from_jax(params))
    return jax_net("basic"), params, state, port


def _window(name, n=K):
    rng = np.random.default_rng(5)
    s = SIZES[name]
    c = 1 if name == "cnn" else 3
    x = rng.normal(size=(n, B, s, s, c)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, B)).astype(np.int64)
    return x, y


def _close(got, want, tol, what):
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), atol=tol, rtol=0, err_msg=what),
        want, got)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["cnn", "resnet"])
def test_multi_step_matches_reference(name, masked):
    jm, params, mstate, model = _nets(name)
    x, y = _window(name)
    n = 2 if masked else K
    mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate = jax_step.TrainState(params, jax_opt.momentum_init(params),
                                 mstate)
    multi = fast(jax_step.make_multi_train_step(
        jm, JaxConfig(batch_size=B), mesh, DECAY, masked=masked))
    args = (jstate, x, y.astype(np.int32), jax.random.key(0))
    jstate, jm_out = multi(*args, n) if masked else multi(*args)

    state = step_lib.init_state(model)
    if name == "resnet":
        state.model_state = convert.params_from_jax(mstate)
    multi_step = step_lib.make_multi_train_step(model, Config(batch_size=B),
                                                1, DECAY)
    state, m = multi_step(state, torch.from_numpy(x), torch.from_numpy(y),
                          n if masked else None)
    assert int(state.opt.step) == n
    np.testing.assert_allclose(m["loss"].numpy(),
                               np.asarray(jm_out["loss"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(m["lr"].numpy(),
                                  np.asarray(jm_out["lr"]))
    if masked:
        assert m["loss"][n:].tolist() == [0.0] * (K - n)
        assert m["lr"][n:].tolist() == [0.0] * (K - n)
    to_np = (convert.cnn_params_to_numpy if name == "cnn"
             else convert.resnet_params_to_numpy)
    _close(to_np(model.param_tree()), jstate.params, 1e-5, "params")
    _close(to_np(step_lib.tree_lib.unflatten(model.param_tree(),
                                             state.opt.velocity)),
           jstate.opt.velocity, 1e-5, "velocity")
    if name == "resnet":
        _close(convert.params_to_numpy(state.model_state),
               jstate.model_state, 1e-5, "model state")


def test_multi_eval_matches_reference():
    jm, params, mstate, model = _nets("resnet")
    data = np.random.default_rng(7).normal(size=(10, 9, 9, 3)).astype(
        np.float32)
    windows, starts = jax_evaluation.stack_eval_windows(data, B)
    assert starts == [0, 4, 6]
    mine = evaluation.rank_windows(data, B, 0, 1)
    np.testing.assert_array_equal(mine, windows)
    mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    want = np.asarray(fast(jax_step.make_multi_eval_step(
        jm, JaxConfig(batch_size=B), mesh))(params, mstate, windows))
    state = step_lib.init_state(model)
    state.model_state = convert.params_from_jax(mstate)
    multi_eval = step_lib.make_multi_eval_step(model, Config())
    got = multi_eval(state, torch.from_numpy(mine))
    assert got.shape == (3, B, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    one = step_lib.make_eval_step(model, Config())
    fused = evaluation.eval_sharded_fused(
        lambda w: multi_eval(state, torch.from_numpy(w)).numpy(), mine,
        data.shape[0], B, 1)
    plain = evaluation.eval_sharded(
        lambda b: one(state, torch.from_numpy(b)).numpy(), data, B, 0, 1)
    np.testing.assert_array_equal(fused, plain)


def test_multi_step_with_dropout_is_k_single_steps():
    x, y = _window("cnn")
    cfg = Config(batch_size=B, grad_accum=2)
    runs = []
    for multi in (False, True):
        model = cnn.MnistCnn.from_seed(4, image_size=8, dropout_rate=0.5)
        state = step_lib.init_state(model)
        if multi:
            state, m = step_lib.make_multi_train_step(model, cfg, 1, DECAY)(
                state, torch.from_numpy(x), torch.from_numpy(y))
            losses = m["loss"].tolist()
        else:
            one = step_lib.make_train_step(model, cfg, 1, DECAY)
            losses = []
            for t in range(K):
                gens = [gspmd.step_generator(cfg.seed + 1, t, "cpu", 0, i)
                        for i in range(2)]
                state, m = one(state, torch.from_numpy(x[t]),
                               torch.from_numpy(y[t]), gens)
                losses.append(m["loss"].item())
        runs.append((losses, [p.detach().clone() for p in
                              model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    # stop(t) ends the window after step t
    model = cnn.MnistCnn.from_seed(4, image_size=8, dropout_rate=0.5)
    state = step_lib.init_state(model)
    state, m = step_lib.make_multi_train_step(model, cfg, 1, DECAY)(
        state, torch.from_numpy(x), torch.from_numpy(y),
        stop=lambda t: t == 1)
    assert int(state.opt.step) == 2 and m["loss"][2].item() == 0.0
    assert m["loss"][:2].tolist() == runs[0][0][:2]


def test_step_tables_equal_host_schedules():
    cfg = Config(batch_size=64)
    sched = optimizer.reference_schedule(cfg, 30000)
    table = optimizer.StepTable([sched], "cpu")
    table.ensure(20000)
    want = np.array([sched(np.float32(t)) for t in range(20000)],
                    dtype=np.float32)
    assert table.values[:20000, 0].numpy().tobytes() == want.tobytes()
    for t in (0, 468, 469, 19999):
        assert table.read(t)[0].item() == float(want[t])
        assert table.index.item() == t + 1
    for name in ("warmup_linear", "warmup_cosine"):
        tx = optimizer.transformer_tx(1e-4, 10000, schedule=name)
        rows = tx.table("cpu")
        rows.ensure(10000)
        lr = np.array([tx.lr(c) for c in range(10000)], np.float32)
        bc1 = np.array([1 - optimizer.B1 ** (c + 1) for c in range(10000)],
                       np.float32)
        bc2 = np.array([1 - optimizer.B2 ** (c + 1) for c in range(10000)],
                       np.float32)
        got = rows.values[:10000].numpy()
        for col, w in enumerate((lr, bc1, bc2)):
            assert got[:, col].tobytes() == w.tobytes(), (name, col)
    rows.freeze(10000)
    with pytest.raises(RuntimeError, match="captured graph"):
        rows.ensure(rows.values.shape[0] + 1)


def test_window_widths_are_the_graphs_captured():
    starts, widths = loop.window_schedule(1562, 50, 51)
    assert widths[:3] == [51, 50, 50] and widths[-1] == 11
    assert sorted(set(widths)) == [11, 50, 51] and sum(widths) == 1562
    assert starts[1] == 51
    _, resumed = loop.window_schedule(1562, 50, 51, start_step=1020)
    assert sorted(set(resumed)) == [11, 31, 50]
    model = cnn.MnistCnn.from_seed(0, image_size=8)
    multi = step_lib.make_multi_train_step(model, Config(batch_size=B), 1,
                                           DECAY)
    x, y = _window("cnn", 51)
    state = step_lib.init_state(model)
    assert multi.prepare(state, torch.from_numpy(x), torch.from_numpy(y),
                         widths) == [11, 50, 51]
    assert not multi.replays and int(state.opt.step) == 0


@pytest.mark.parametrize("scan", [2, 0])
def test_bench_scan_steps_line(scan):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(["--mode", "train", "--device", "cpu", "--steps",
                           "5", "--warmup", "1", "--batch-size", "8",
                           "--scan-steps", str(scan)]) == 0
    line = json.loads(out.getvalue())
    assert line["scan_steps"] == scan
    assert line["steps"] == (4 if scan else 5)
    assert np.isfinite(line["final_loss"]) and line["step_time_ms"] > 0
    assert bench.scan_width(None, bench.IMAGE_SPECS["mnist_cnn"]["scan"],
                            1000) == 400
    assert bench.scan_width(None, bench.TRANSFORMER_SCAN, 2) == 2
