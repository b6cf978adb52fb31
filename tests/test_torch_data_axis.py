"""The port's data axis over ``torch.distributed`` against the JAX
package's ``data`` mesh axis, on the CPU.

One module-scoped 2-rank gloo world (``tests/_torch_dp_worker.py``, two
processes at one thread each) does all of the port's side while this
process runs the reference's on a 2-device mesh of the virtual CPU
platform, from the reference's own initial parameters carried across by
``convert.cnn_params_from_jax``:

- (a) ``host_shard`` and the splits' truncation at 2 shards: exact;
- (b) ``allreduce_sum`` / ``_mean`` / ``_max``, ``allgather``,
  ``host_allgather``, ``pbroadcast``, ``axis_index`` against numpy on
  the ranks' arrays: exact (a float32 sum of two, then a division by 2,
  rounds once each on both sides);
- (c) psum: ``loop.train`` over the 2-rank world against the
  reference's ``loop.train`` on the 2-device mesh — the 1200/256-row
  synthetic MNIST, batch 64 per shard, one epoch (7 steps), a trace
  every 3 steps (t = 3 and 6), dropout 0, float32: trace lines,
  history and step counts exactly (rank 1 prints nothing), parameters
  within 1e-5 and velocity within 1e-5 absolute + 1e-4 relative, as in
  ``test_torch_cnn_train.py`` (float32 convolutions summed in another
  order by another library); rank 1 starts from other parameters, so
  these also hold the loop's broadcast of rank 0's;
- (d) avg50: the same, rank r's state against the reference's stacked
  ``state[r]``: right after the one average (t = 3) within those
  tolerances and bit-identical across the ranks; at the end (no average
  after the last step) the parameters within ``AVG50_FINAL_TOL``, one
  flipped decision (see there);
- (e) the average step on two distinct injected replicas (parameters,
  velocity, step counter) against ``make_average_step``: within 1 ulp;
- (f) the sharded eval on the same two replicas against
  ``make_stacked_eval_step`` + ``eval_in_batches`` on 200 rows in
  windows of 128 (the tail window overlaps rows 72-127): identical
  argmax on every row, probabilities within 1e-5 (the replicas disagree
  on some of those rows, so the row-to-replica assignment is held);
- (h) a tiny ResNet (one basic block a stage, ``worker.RESNET``)
  through ``loop.train`` under psum on both ranks against the
  reference's ``loop.train`` on the 2-device mesh, from its parameters,
  on the synthetic image set of ``worker.RESNET_SPLIT`` (6 steps of 4
  rows a rank, a trace every 3): the history exactly, parameters and
  BatchNorm state (each rank normalising its own rows, the state
  averaged in the step's one all-reduce) within ``PARAM_TOL``, the
  ranks' states bit-identical; and avg50's average step on two
  injected ResNet replicas (parameters, velocity, BatchNorm state)
  against the reference's: within 1 ulp, every rank the same;
- (g) ``initialize_distributed`` with a configured launch whose
  ``MASTER_ADDR:MASTER_PORT`` (localhost, a port nothing listens on)
  cannot be joined raises; with no launcher it is a no-op at world
  size 1.
"""

import contextlib
import datetime
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.data import mnist as jax_mnist
from mpi_tensorflow_tpu.data import synthetic as jax_synthetic
from mpi_tensorflow_tpu.data import sharding as jax_sharding
from mpi_tensorflow_tpu.models import cnn as jax_cnn
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import evaluation as jax_evaluation
from mpi_tensorflow_tpu.train import loop as jax_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_torch.data import mnist, sharding
from mpi_tensorflow_torch.parallel import collectives, mesh

import _torch_dp_worker as worker
from _torch_resnet_inputs import net_inputs as resnet_inputs
from _torch_tdp_worker import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PARAM_TOL = 1e-5                      # absolute
# avg50's replicas step on 64 rows each, and at the last step (t = 6)
# rank 0's takes another max-pool or ReLU decision than the reference's:
# conv1_b parts by 2.433e-05 there, from 1.639e-07 the step before, while
# each of the port's steps from the reference's own state stays within
# 5.4e-08 (ROADMAP Queue 3).  So the final parameters are held to one
# such decision (the velocity, lr = 0.01 times more sensitive, is not
# held there); right after the average, parameters and velocity are held
# to PARAM_TOL and VELOCITY_TOL
AVG50_FINAL_TOL = 1e-4
VELOCITY_TOL = (1e-5, 1e-4)           # absolute, relative
PROB_TOL = 1e-5


def _traced(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn()
    return res, [ln for ln in out.getvalue().splitlines()
                 if not ln.startswith("[timing]")]


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def _fast_compile():
    """XLA's optimisation passes off while the reference's ResNet loop
    compiles its steps: they only slow the compile."""
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)


def _reference_resnet(m, params, replicas) -> dict:
    """(h): the reference's psum loop on the tiny ResNet, and its
    average step on the two injected ResNet replicas ``replicas``
    (``(params, velocity, BatchNorm state)`` each)."""
    from mpi_tensorflow_tpu.models import resnet as jax_resnet

    model = jax_resnet.ResNet(**worker.RESNET)
    splits = jax_synthetic.image_classification(**worker.RESNET_SPLIT)
    with pytest.MonkeyPatch.context() as mp, _fast_compile():
        mp.setattr(jax_step, "init_state", lambda model, rng: jax.device_put(
            jax_step.TrainState(params, jax_opt.momentum_init(params),
                                model.init_state()), NamedSharding(m, P())))
        psum = _traced(lambda: jax_loop.train(
            JaxConfig(**worker.RESNET_LOOP), model=model, splits=splits,
            mesh=m, verbose=True))[0]
        state = jax.device_put(jax.tree.map(
            lambda *xs: np.stack(xs), *[jax_step.TrainState(
                p, jax_opt.MomentumState(v, np.float32(worker.RESNET_STEP)),
                s) for p, v, s in replicas]), NamedSharding(m, P("data")))
        average = _host(jax_step.make_average_step(m)(state))
    return {"psum": psum, "average": average}


def _reference(mnist_dir, init, replicas, velocities, step):
    """The JAX package's side of (c)-(f) on a 2-device mesh."""
    m = jax_mesh.make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    splits = jax_mnist.load_splits(mnist_dir, num_shards=WORLD,
                                   **worker.SPLIT)
    out = {"averaged": []}
    make_average = jax_step.make_average_step

    def recording_average(mesh_):
        average = make_average(mesh_)

        def call(state):
            state = average(state)
            out["averaged"].append(_host(state))
            return state
        return call

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_step, "init_state", lambda model, rng: jax.device_put(
            jax_step.TrainState(init, jax_opt.momentum_init(init), {}),
            NamedSharding(m, P())))
        mp.setattr(jax_step, "make_average_step", recording_average)
        for sync in ("psum", "avg50"):
            cfg = JaxConfig(**worker.LOOP, sync=sync)
            out[sync] = _traced(lambda: jax_loop.train(
                cfg, splits=splits, mesh=m, verbose=True))
    finally:
        mp.undo()
    stack = lambda trees: jax.device_put(
        jax.tree.map(lambda *xs: np.stack(xs), *trees),
        NamedSharding(m, P("data")))
    state = stack([jax_step.TrainState(
        r, jax_opt.MomentumState(v, np.float32(step)), {})
        for r, v in zip(replicas, velocities)])
    model = jax_cnn.MnistCnn(dropout_rate=0.0)
    cfg = JaxConfig(**worker.LOOP)
    stacked_eval = jax_step.make_stacked_eval_step(model, cfg, m)
    out["eval"] = jax_evaluation.eval_in_batches(
        lambda b: stacked_eval(state.params, state.model_state, b),
        splits.test_data[:worker.EVAL_ROWS], worker.EVAL_BATCH)
    out["average"] = _host(jax_step.make_average_step(m)(state))
    return out


@pytest.fixture(scope="module")
def world(mnist_dir, tmp_path_factory):
    """``(reference, [rank 0's npz, rank 1's npz], inputs)``: the workers
    run while this process computes the reference."""
    workdir = tmp_path_factory.mktemp("data_axis")
    init_fn = jax.jit(jax_cnn.MnistCnn().init)
    init = _host(init_fn(jax.random.key(1)))
    replicas = [init, _host(init_fn(jax.random.key(2)))]
    rng = np.random.default_rng(0)
    velocities = [{k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32)
                   for k, v in init.items()} for _ in range(WORLD)]
    step = 7.0
    inputs = {f"init/{k}": v for k, v in init.items()}
    for r in range(WORLD):
        inputs.update({f"replica{r}/{k}": v for k, v in replicas[r].items()})
        inputs.update({f"velocity{r}/{k}": v
                       for k, v in velocities[r].items()})
    resnet_init, _ = resnet_inputs("basic", seed=5)
    inputs.update(flatten(resnet_init, "resnet_init"))
    resnet_replicas = [resnet_inputs("basic", seed=6 + r)
                       for r in range(WORLD)]
    resnet_replicas = [(p, jax.tree.map(lambda x: x * np.float32(1e-2), p),
                        st) for p, st in resnet_replicas]
    for r, (p, v, st) in enumerate(resnet_replicas):
        inputs.update(flatten(p, f"resnet_replica{r}/params"))
        inputs.update(flatten(v, f"resnet_replica{r}/velocity"))
        inputs.update(flatten(st, f"resnet_replica{r}/state"))
    np.savez(workdir / "inputs.npz", step=np.float32(step), **inputs)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in mesh.LAUNCH_ENV:
        env.pop(k, None)
    port = mesh.free_port()
    # output to files, not pipes: a rank blocked on a full pipe could no
    # longer reach the collective its peer waits in
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(port),
         str(workdir), mnist_dir], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        ref = _reference(mnist_dir, init, replicas, velocities, step)
        ref["resnet"] = _reference_resnet(jax_mesh.make_mesh(
            {"data": WORLD}, devices=jax.devices()[:WORLD]), resnet_init,
            resnet_replicas)
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        log.seek(0)
        assert rc == 0, f"rank {r} exited {rc}:\n{log.read()[-4000:]}"
        log.close()
    ranks = [np.load(workdir / f"rank{r}.npz") for r in range(WORLD)]
    return ref, ranks, np.load(workdir / "inputs.npz")


# ---------------------------------------------------------- (a), (b)

def test_host_shard_and_truncation_match_reference(mnist_dir, world):
    _, ranks, _ = world
    x = np.arange(101)
    for r in range(WORLD):
        want = jax_sharding.host_shard(x, r, WORLD)
        assert np.array_equal(sharding.host_shard(x, r, WORLD), want)
        assert np.array_equal(ranks[r]["host_shard"], want)
        assert int(ranks[r]["axis_index"]) == r
    want = jax_mnist.load_splits(mnist_dir, num_shards=WORLD, **worker.SPLIT)
    got = mnist.load_splits(mnist_dir, num_shards=WORLD, **worker.SPLIT)
    for w, g in zip(vars(want).values(), vars(got).values()):
        assert w.shape == g.shape and w.tobytes() == g.tobytes()


def test_collectives_against_numpy(world):
    _, ranks, _ = world
    xs = [np.random.default_rng(r).normal(size=(3, 5)).astype(np.float32)
          for r in range(WORLD)]
    total = xs[0] + xs[1]
    want = {"allreduce_sum": total,
            "allreduce_mean": total / np.float32(WORLD),
            "allreduce_max": np.maximum(xs[0], xs[1]),
            "pbroadcast": xs[0], "allgather": np.stack(xs),
            "host_allgather": np.stack(xs)}
    for r in range(WORLD):
        for name, w in want.items():
            got = ranks[r][f"coll/{name}"]
            assert got.dtype == np.float32 and np.array_equal(got, w), name


def test_collectives_without_a_group_are_the_identity():
    import torch

    assert not mesh.active() and mesh.process_count() == 1
    x = torch.arange(4.0)
    for fn in (collectives.allreduce_sum, collectives.allreduce_mean,
               collectives.allreduce_max, collectives.pbroadcast):
        assert fn(x) is x and torch.equal(x, torch.arange(4.0))
    assert torch.equal(collectives.allgather(x), x[None])
    assert collectives.axis_index() == 0
    collectives.barrier()


# ---------------------------------------------------------- (c), (d)

def _hold(got, prefix, params, vel, what, param_tol=PARAM_TOL):
    """The port's parameters within ``param_tol`` of the reference's
    ``params`` and, when ``vel`` is given, its velocity within
    ``VELOCITY_TOL`` of ``vel``."""
    for k in params:
        np.testing.assert_allclose(got[f"{prefix}param/{k}"], params[k],
                                   atol=param_tol, rtol=0,
                                   err_msg=f"{what} {k}")
        if vel is not None:
            np.testing.assert_allclose(
                got[f"{prefix}velocity/{k}"], vel[k], atol=VELOCITY_TOL[0],
                rtol=VELOCITY_TOL[1], err_msg=f"{what} velocity {k}")


@pytest.mark.parametrize("sync", ["psum", "avg50"])
def test_loop_matches_reference_on_two_devices(world, sync):
    ref, ranks, _ = world
    want, want_lines = ref[sync]
    assert want.num_devices == WORLD and want.num_steps == 7
    for r in range(WORLD):
        got = ranks[r]
        assert int(got[f"{sync}/num_steps"]) == want.num_steps
        assert int(got[f"{sync}/num_devices"]) == WORLD
        assert [tuple(h) for h in got[f"{sync}/history"]] == [
            (t, e) for t, e in want.history]
        lines = [ln for ln in got[f"{sync}/lines"]
                 if not ln.startswith("[timing]")]
        assert lines == (want_lines if r == 0 else [])
        assert np.isfinite(float(got[f"{sync}/final_loss"]))
        assert float(got[f"{sync}/images_per_sec"]) > 0
    assert any(ln.startswith("[timing]") for ln in ranks[0][f"{sync}/lines"])
    assert len(want_lines) == 1 + 2 * WORLD       # session + 2 trace points
    state = _host(want.state)
    for r in range(WORLD):
        params, vel, step = state.params, state.opt.velocity, state.opt.step
        if sync == "avg50":                       # stacked: replica r
            params, vel, step = jax.tree.map(lambda x: x[r],
                                             (params, vel, step))
        got = ranks[r]
        assert got[f"{sync}/step"] == np.float32(step) == np.float32(7)
        if sync == "psum":
            _hold(got, "psum/", params, vel, f"psum rank {r}")
        else:
            _hold(got, "avg50/", params, None, f"avg50 rank {r}",
                  AVG50_FINAL_TOL)
    if sync == "psum":               # replicated: bit-identical ranks
        assert "averaged" not in {k.split("/")[1] for k in ranks[0].files
                                  if k.startswith("psum/")}
        for k in params:
            assert np.array_equal(ranks[0][f"psum/param/{k}"],
                                  ranks[1][f"psum/param/{k}"])
        return
    # the one average, at t = 3: replicas bit-identical right after it,
    # both within PARAM_TOL of the reference's; apart again at the end
    (averaged,) = ref["averaged"]
    for r in range(WORLD):
        at = jax.tree.map(lambda x: x[r], averaged)
        got = ranks[r]
        assert got["avg50/averaged/step"] == np.float32(at.opt.step) == 4
        _hold(got, "avg50/averaged/", at.params, at.opt.velocity,
              f"avg50 rank {r} after the average")
        for k in at.params:
            for name in ("param", "velocity"):
                assert np.array_equal(got[f"avg50/averaged/{name}/{k}"],
                                      ranks[0][f"avg50/averaged/{name}/{k}"])
    assert any(not np.array_equal(ranks[0][f"avg50/param/{k}"],
                                  ranks[1][f"avg50/param/{k}"])
               for k in state.params)


# ---------------------------------------------------------- (e), (f)

def test_average_step_matches_reference(world):
    ref, ranks, inputs = world
    want = ref["average"]
    for r in range(WORLD):
        got = ranks[r]
        assert got["average/step"] == np.float32(inputs["step"])
        for k in want.params:
            for name, tree in (("param", want.params),
                               ("velocity", want.opt.velocity)):
                np.testing.assert_array_max_ulp(
                    got[f"average/{name}/{k}"], tree[k][r], maxulp=1)
        for k in want.params:
            assert np.array_equal(got[f"average/param/{k}"],
                                  ranks[0][f"average/param/{k}"])


def test_sharded_eval_assigns_rows_as_reference(mnist_dir, world):
    ref, ranks, inputs = world
    want = ref["eval"]
    for r in range(WORLD):
        got = ranks[r]["eval/preds"]
        assert got.shape == want.shape == (worker.EVAL_ROWS, 10)
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    # the two replicas disagree on rows the assignment decides
    model = jax_cnn.MnistCnn(dropout_rate=0.0)
    x = jax_mnist.load_splits(mnist_dir, num_shards=WORLD, **worker.SPLIT
                              ).test_data[:worker.EVAL_ROWS]
    own = [np.asarray(model.apply(worker._tree(inputs, f"replica{r}/"), x)
                      ).argmax(-1) for r in range(WORLD)]
    assert np.any(own[0][72:128] != own[1][72:128])


# ----------------------------------------------------------------- (h)

def _close(got: dict, want, tol, what) -> None:
    want = flatten(_host(want), "")
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=0,
                                   err_msg=f"{what} {k}")


def _rank_tree(rank, prefix: str) -> dict:
    """``{path: leaf}`` of one tree a rank saved under ``prefix``."""
    return {k[len(prefix):]: rank[k] for k in rank.files
            if k.startswith(prefix + "/")}


def test_resnet_psum_loop_matches_reference(world):
    ref, ranks, _ = world
    want = ref["resnet"]["psum"]
    for r in range(WORLD):
        assert [tuple(h) for h in ranks[r]["resnet/psum/history"]] == [
            (t, e) for t, e in want.history]
        _close(_rank_tree(ranks[r], "resnet/psum/params"), want.state.params,
               PARAM_TOL, f"psum rank {r} params")
        _close(_rank_tree(ranks[r], "resnet/psum/state"),
               want.state.model_state, PARAM_TOL,
               f"psum rank {r} BatchNorm state")
    states = [_rank_tree(ranks[r], "resnet/psum/state") for r in range(WORLD)]
    assert all(np.array_equal(v, states[1][k]) for k, v in states[0].items())


def test_resnet_average_step_matches_reference(world):
    """avg50's average of two ResNet replicas: parameters, velocity and
    BatchNorm state within 1 ulp of the reference's, every rank the
    same."""
    ref, ranks, _ = world
    want = ref["resnet"]["average"]
    for name, tree in (("params", want.params),
                       ("velocity", want.opt.velocity),
                       ("state", want.model_state)):
        got = [_rank_tree(ranks[r], f"resnet/average/{name}")
               for r in range(WORLD)]
        for r in range(WORLD):
            assert ranks[r]["resnet/average/step"] == np.float32(
                worker.RESNET_STEP)
            mine = flatten(jax.tree.map(lambda x: x[r], tree), "")
            assert sorted(got[r]) == sorted(mine)
            for k, w in mine.items():
                np.testing.assert_array_max_ulp(got[r][k], w, maxulp=1)
                assert np.array_equal(got[r][k], got[0][k])


# ---------------------------------------------------------------- (g)

def test_initialize_distributed_raises_or_is_a_no_op(monkeypatch):
    for k in mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mesh.initialize_distributed("cpu") is False
    assert not mesh.active() and mesh.make_mesh() == {"data": 1}
    with pytest.raises(ValueError, match="needs 4 processes"):
        mesh.make_mesh({"data": 4})
    # a configured launch that cannot be joined: rank 1 of 2 dials a
    # localhost port nothing listens on
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(mesh.free_port()))
    with pytest.raises(RuntimeError, match="distributed initialization "
                                           "failed"):
        mesh.initialize_distributed(
            "cpu", timeout=datetime.timedelta(seconds=1))
    assert not mesh.active()


def test_data_axis_refusals(monkeypatch):
    """A rank without a card of its own, a launch env missing a key, a
    pipe axis, avg50 over shards in one process and a rank holding two
    shards all raise."""
    import torch

    from mpi_tensorflow_torch.config import Config
    from mpi_tensorflow_torch.models import cnn
    from mpi_tensorflow_torch.train import loop, step

    for k in mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mesh.rank_device("cuda") == torch.device("cuda")   # no launch
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        mesh.rank_device("cuda")
    assert mesh.rank_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="not \\['RANK'"):
        mesh.initialize_distributed("cpu")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(NotImplementedError, match="item 14"):
        mesh.make_mesh({"data": 1, "pipe": 2})       # 14d; model is ported
    model = cnn.MnistCnn.from_seed(1)
    with pytest.raises(ValueError, match="one replica per rank"):
        loop.train(Config(sync="avg50"), model=model, num_shards=2,
                   device="cpu")
    with pytest.raises(ValueError, match="a rank holds one shard"):
        step.make_train_step(model, Config(), 2, 100, across_ranks=True)
