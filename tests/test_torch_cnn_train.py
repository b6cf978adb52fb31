"""The port's CNN training loop against the reference's, on the CPU.

Both loops train the CNN from the reference's own initial parameters
(its ``init`` at ``jax.random.key(1)``, carried across by
``convert.cnn_params_from_jax``) on the synthetic MNIST at 1200 train /
256 test rows, batch 8 per shard, one epoch, a trace every 10 steps,
dropout 0 — once with one shard and early stopping at a patience of 2
(the reference on a one-device mesh) and once with four shards over the
whole epoch (the reference on four devices, the port with four shards
in one process):

- the history's steps and the trace points are identical;
- test errors within 1 percentage point (two of the 256 test rows
  flipping their argmax);
- the trace lines identical apart from the ``[timing]`` line;
- the port's train step, run from the reference's own state (parameters,
  velocity, step counter) at steps of its run, on the batch the
  reference's loop fed it, gives the reference's next state: loss within
  1e-5, velocity within 1e-5 absolute + 1e-4 relative, parameters
  within 1e-6 (the velocity's error times the LR) — at the first
  steps and the last;
- the port's windowed loop (``fused_steps = log_every``) gives the same
  history and bit-identical parameters as its per-step loop;
- early stopping fires at the same trace point as the reference's.

The two loops' final parameters are not compared: the trajectory is
chaotic at the reference's settings.  Run at 4 threads, the port's step
stands 4.470e-08 from its own 8-thread run after step 2, takes another
conv1 ReLU and max-pool decision at step 3, and ends 125 steps with
conv1_b 5.585e-02 from the reference's; at 8, 2 and 1 threads it ends
within 6.6e-07 of it (``scripts/torch_cnn_drift.py``).  The
step-by-step check above holds the arithmetic without that
amplification.
"""

import contextlib
import dataclasses
import io

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import pytest
import torch

from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.data import mnist as jax_mnist
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import loop as jax_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import mnist
from mpi_tensorflow_torch.models import cnn, convert
from mpi_tensorflow_torch.train import loop, optimizer, step

COMMON = dict(epochs=1, batch_size=8, log_every=10, dropout_rate=0.0,
              fused_steps=1)
CASES = {
    "one_shard": (1, {"early_stop_patience": 2}),
    "four_shards": (4, {}),
}
# the steps of each reference run whose state is recorded: the first
# ones and the last (early stopping ends the one-shard run at step 40)
RECORDED = {"one_shard": (0, 3, 40), "four_shards": (0, 3, 30)}


def _traced(fn):
    """``(fn(), its stdout lines without the [timing] line)``."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn()
    lines = [ln for ln in out.getvalue().splitlines()
             if not ln.startswith("[timing]")]
    return res, lines


def _host(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _recording(make, steps, into):
    """``make`` (the reference's ``make_train_step``) whose step records,
    at the step numbers in ``steps``, ``(state before, batch, labels,
    state after, loss)`` into ``into``."""
    def wrapped(*a, **kw):
        fn = make(*a, **kw)
        count = [0]

        def step(state, batch, labels, rng):
            t = count[0]
            count[0] += 1
            before = _host((state.params, state.opt)) if t in steps else None
            new, metrics = fn(state, batch, labels, rng)
            if before is not None:
                into[t] = (before, np.array(batch), np.array(labels),
                           _host((new.params, new.opt)),
                           float(metrics["loss"]))
            return new, metrics
        return step
    return wrapped


@pytest.fixture(scope="module")
def reference_runs(mnist_dir):
    """The reference loop's result, trace and recorded steps per case,
    and its initial parameters, computed once per module.  XLA keeps its
    optimisation passes here: without them the compile is ~2 s shorter
    and each of these steps twice as slow on one core."""
    out = {}
    model = jax_loop.build_model(JaxConfig(**COMMON))
    init = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1)))
    mp = pytest.MonkeyPatch()
    try:
        for name, (n, kw) in CASES.items():
            cfg = JaxConfig(**{**COMMON, **kw})
            splits = jax_mnist.load_splits(mnist_dir, num_shards=n,
                                           train_n=1200, test_n=256)
            mesh = jax_mesh.make_mesh({"data": n}, devices=jax.devices()[:n])
            recorded = {}
            mp.setattr(jax_step, "make_train_step", _recording(
                jax_step.make_train_step, RECORDED[name], recorded))
            # the initial state placed as the step returns it (replicated
            # over the mesh), so its first and later calls share one
            # compile
            mp.setattr(jax_step, "init_state", lambda m, rng: jax.device_put(
                jax_step.TrainState(init, jax_opt.momentum_init(init), {}),
                NamedSharding(mesh, P())))
            res, lines = _traced(lambda: jax_loop.train(
                cfg, splits=splits, mesh=mesh, verbose=True))
            mp.undo()
            out[name] = (res, lines, recorded)
    finally:
        mp.undo()
    return out, init


def _port_run(mnist_dir, init, n, **kw):
    cfg = Config(**{**COMMON, **kw})
    splits = mnist.load_splits(mnist_dir, num_shards=n, train_n=1200,
                               test_n=256)
    model = loop.build_model(cfg)
    with torch.no_grad():
        for k, v in convert.cnn_params_from_jax(init).items():
            getattr(model, k).copy_(v)
    return _traced(lambda: loop.train(cfg, model=model, splits=splits,
                                      num_shards=n, device="cpu"))


@pytest.fixture(scope="module")
def port_runs(mnist_dir, reference_runs):
    _, init = reference_runs
    return {name: _port_run(mnist_dir, init, n, **kw)
            for name, (n, kw) in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_history_and_trace_match_reference(reference_runs, port_runs, case):
    runs, _ = reference_runs
    want, want_lines, _ = runs[case]
    got, got_lines = port_runs[case]
    assert got.num_steps == want.num_steps
    assert got.num_devices == want.num_devices == CASES[case][0]
    assert [t for t, _ in got.history] == [t for t, _ in want.history]
    for (_, g), (_, w) in zip(got.history, want.history):
        assert abs(g - w) <= 1.0
    assert got_lines == want_lines
    assert np.isfinite(got.final_loss) and got.device == "cpu"
    assert got.images_per_sec > 0 and got.step_time_seconds > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_from_the_reference_state_match(reference_runs, case):
    runs, _ = reference_runs
    _, _, recorded = runs[case]
    assert sorted(recorded) == list(RECORDED[case])
    n, kw = CASES[case]
    cfg = Config(**{**COMMON, **kw})
    local_n = 1000 // n
    for t, (before, batch, labels, after, want_loss) in recorded.items():
        (p0, opt0), (p1, opt1) = before, after
        model = cnn.MnistCnn(convert.cnn_params_from_jax(p0),
                             dropout_rate=0.0)
        state = step.init_state(model)
        vel = convert.cnn_params_from_jax(opt0.velocity)
        state.opt = optimizer.MomentumState(
            [vel[k] for k in cnn.NAMES], np.float32(opt0.step))
        train_step = step.make_train_step(model, cfg, n, local_n)
        state, metrics = train_step(state, torch.from_numpy(batch),
                                    torch.from_numpy(labels.astype(np.int64)))
        assert state.opt.step == np.float32(opt1.step) == np.float32(t + 1)
        np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                   atol=1e-5, rtol=0)
        got_p = convert.cnn_params_to_numpy(model.param_tree())
        got_v = convert.cnn_params_to_numpy(
            dict(zip(cnn.NAMES, state.opt.velocity)))
        for k in cnn.NAMES:
            np.testing.assert_allclose(got_v[k], opt1.velocity[k],
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"step {t} velocity {k}")
            np.testing.assert_allclose(got_p[k], p1[k], atol=1e-6, rtol=0,
                                       err_msg=f"step {t} {k}")
            if t == 0:
                assert not np.array_equal(p1[k], p0[k]), k


def test_final_parameters_trained(reference_runs, port_runs):
    """The port's run moved every parameter from the shared init, and
    its step counter stands at the steps it ran."""
    _, init = reference_runs
    for case, (got, _) in port_runs.items():
        params = convert.cnn_params_to_numpy(got.state.model.param_tree())
        for k, v in params.items():
            assert np.isfinite(v).all() and not np.allclose(
                v, init[k], atol=1e-3), (case, k)
        last = got.history[-1][0]
        assert got.state.opt.step == np.float32(last + 1)


def test_early_stopping_fires_with_the_reference(reference_runs, port_runs):
    runs, _ = reference_runs
    want, _, _ = runs["one_shard"]
    got, got_lines = port_runs["one_shard"]
    assert got.history[-1][0] < got.num_steps - 1      # it stopped early
    assert [t for t, _ in got.history] == [t for t, _ in want.history]
    assert any("[early-stop] validation error has not improved" in ln
               for ln in got_lines)


def test_windowed_loop_equals_per_step_loop(mnist_dir, reference_runs,
                                            port_runs):
    _, init = reference_runs
    per_step, lines = port_runs["four_shards"]
    windowed, w_lines = _port_run(mnist_dir, init, 4,
                                  fused_steps=COMMON["log_every"])
    assert windowed.history == per_step.history
    assert w_lines == lines
    for a, b in zip(windowed.state.model.param_tree().values(),
                    per_step.state.model.param_tree().values()):
        assert torch.equal(a, b)
    assert windowed.state.opt.step == per_step.state.opt.step


def test_result_fields(port_runs):
    got, _ = port_runs["one_shard"]
    want = {f.name for f in dataclasses.fields(jax_loop.TrainResult)}
    assert want <= {f.name for f in dataclasses.fields(loop.TrainResult)}
