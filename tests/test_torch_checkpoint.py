"""The port's checkpoints, resume, preemption and metrics sink against
the JAX reference, on the CPU.

- **The state mapping** (``train.state_io``): for the CNN, the tiny
  ResNets (basic and bottleneck blocks) and BERT_TINY, the port's leaves
  follow ``jax.tree_util.tree_flatten_with_path`` of the reference's own
  initial state (``step.init_state``; ``gspmd.init_gspmd_state``, traced
  by ``jax.eval_shape``) in count, shape and dtype.
- **Interop**: a state with every leaf drawn from numpy, written by the
  reference's synchronous ``save`` and ``save_sharded``, restores in the
  port to the same parameters, velocity or moments, counters and model
  state (each checked against ``models.convert`` of the reference's
  leaves); the port's own write of it restores in the reference's
  ``restore`` / ``restore_sharded`` to every leaf exactly, and its
  sharded directory is the reference's byte for byte.  avg50's stacked
  state the same, over two ranks emulated in this process (a 2-device
  mesh on the reference's side).  The reference's ``AsyncSaver`` and
  loops with ``checkpoint_dir`` are not run (the known segfault flake).
- **Resume**: a run stopped by ``request_stop`` (the image loop) or by
  SIGTERM (``train_mlm``) and resumed gives the uninterrupted run's
  trace lines, metrics and state, bit for bit; across two gloo ranks
  (``tests/_torch_ckpt_worker.py``) in the image loop (psum, avg50) and
  ``train_mlm`` (replicated, zero1, fsdp), with the stop agreed at the
  next trace point and recorded as "peer preemption" on the other rank;
  ``train_mlm``'s three layouts also restored at world 1 and continued
  with the same global batch, within ``TOL`` of the two-rank run.
- **Commit markers**: shard files without ``meta.json`` and a bare
  ``.npz`` are skipped by ``latest_step``, as by the reference's.
- **Metrics**: ``metrics.jsonl`` lines equal the reference writer's
  (``null`` for NaN and Inf), rank 1's writer writes nothing; the loops'
  tags and steps (``test_torch_data_path.py`` holds the image loop's
  against the reference loop's).
- ``PreemptionGuard``: SIGTERM sets the flag and its reason, handlers are
  restored (also when the guarded body raises); ``AsyncSaver`` raises a
  failed write in the next call.
"""

import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_ckpt_worker as worker
from _torch_resnet_inputs import TINY, jax_net
from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import resnet as jax_resnet
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import checkpoint as jax_ckpt
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import loop as jax_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_tpu.utils import metrics_writer as jax_mw
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import bert, cnn, convert, resnet
from mpi_tensorflow_torch.parallel import mesh
from mpi_tensorflow_torch.train import checkpoint, gspmd, mlm_loop
from mpi_tensorflow_torch.train import optimizer, preemption, state_io
from mpi_tensorflow_torch.train import step as step_lib
from mpi_tensorflow_torch.utils import metrics_writer
from mpi_tensorflow_torch.utils import tree as tree_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("cnn", "resnet_basic", "resnet_bottleneck", "bert")
TOL = 1e-5                  # world 1 against world 2: float32 sums
BK_TOL = 3 * worker.MLM["learning_rate"]   # bk's gradient is 0 exactly:
                                            # adamw scales its noise


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the two-rank worker runs: the bit-equal
    resume checks need one reduction order in every run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the two states

def _reference_init(name):
    """The reference's own initial train state, traced (shapes and
    dtypes only)."""
    key = jax.random.key(0)
    if name == "bert":
        model = jax_bert.BertMlm(jax_bert.BERT_TINY)
        tx = jax_opt.transformer_tx(1e-4, 10)
        m = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
        return jax.eval_shape(lambda k: jax_gspmd.init_gspmd_state(
            model, tx, k, m), key)
    if name == "cnn":
        model = jax_loop.build_model(JaxConfig())
        return jax.eval_shape(lambda k: jax_step.init_state(model, k), key)
    with pytest.MonkeyPatch.context() as mp:
        # the He-normal draw sizes its fan-in with a concrete product
        mp.setattr(jax_resnet, "_he_normal",
                   lambda k, shape: jnp.zeros(shape, jnp.float32))
        return jax.eval_shape(lambda k: jax_step.init_state(
            jax_net(name.split("_")[1]), k), key)


def _drawn(tree, seed):
    """``tree``'s structure with every float leaf drawn from numpy and
    every integer leaf 7 (the counters: adam's and the schedule's
    agree)."""
    rng = np.random.default_rng(seed)

    def draw(x):
        if np.issubdtype(x.dtype, np.integer):
            return np.full(x.shape, 7, x.dtype)
        return rng.normal(size=x.shape).astype(x.dtype)

    return jax.tree.map(draw, tree)


def _port_state(name):
    """A fresh port state of the same model (its own weights)."""
    if name == "bert":
        model = bert.BertMlm.from_seed(bert.BERT_TINY, 3)
        return gspmd.init_state(model, optimizer.transformer_tx(1e-4, 10))
    if name == "cnn":
        model = cnn.MnistCnn.from_seed(3)
    else:
        geo = resnet.Geometry(**TINY[name.split("_")[1]], num_classes=10)
        model = resnet.ResNet.from_seed(geo, 3)
    return step_lib.init_state(model)


def _as_reference(state):
    """The port's state as the reference's trees of numpy leaves, each
    through ``models.convert`` (independent of ``state_io``)."""
    ptree = state.model.param_tree()
    like = lambda leaves: tree_lib.unflatten(ptree, leaves)
    if isinstance(state, gspmd.TrainState):
        np_ = convert.params_to_numpy
        return {"params": np_(ptree), "mu": np_(like(state.opt.mu)),
                "nu": np_(like(state.opt.nu)), "count": state.opt.count,
                "step": state.step}
    np_ = convert.cnn_params_to_numpy \
        if isinstance(state.model, cnn.MnistCnn) \
        else convert.resnet_params_to_numpy
    return {"params": np_(ptree), "velocity": np_(like(state.opt.velocity)),
            "step": state.opt.step,
            "model_state": convert.params_to_numpy(state.model_state)}


def _assert_same(port_tree, ref_tree):
    assert jax.tree.structure(port_tree) == jax.tree.structure(ref_tree)
    for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(ref_tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b)


def _assert_port_holds(state, ref):
    got = _as_reference(state)
    _assert_same(got["params"], ref.params)
    if isinstance(state, gspmd.TrainState):
        adam = ref.opt[1][0]
        _assert_same(got["mu"], adam.mu)
        _assert_same(got["nu"], adam.nu)
        assert got["count"] == int(adam.count) == int(ref.opt[1][2].count)
        assert got["step"] == int(ref.step)
    else:
        _assert_same(got["velocity"], ref.opt.velocity)
        assert got["step"] == np.float32(ref.opt.step)
        _assert_same(got["model_state"], ref.model_state)


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", MODELS)
def test_parts_follow_the_reference_leaves(name):
    """Leaf for leaf, the reference's ``tree_flatten_with_path`` order."""
    want = jax.tree_util.tree_flatten_with_path(_reference_init(name))[0]
    got = state_io.parts(_port_state(name))
    assert len(got) == len(want)
    for part, (path, leaf) in zip(got, want):
        key = jax.tree_util.keystr(path)
        assert part.shape == tuple(leaf.shape), key
        assert part.dtype == np.dtype(leaf.dtype), key


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
@pytest.mark.parametrize("name", MODELS)
def test_checkpoints_cross_between_the_packages(name, fmt, tmp_path):
    ref = _drawn(_reference_init(name), 11)
    save = {"npz": (jax_ckpt.save, checkpoint.save),
            "sharded": (jax_ckpt.save_sharded, checkpoint.save_sharded)}[fmt]
    restore = {"npz": (jax_ckpt.restore, checkpoint.restore),
               "sharded": (jax_ckpt.restore_sharded,
                           checkpoint.restore_sharded)}[fmt]
    save[0](str(tmp_path / "ref"), ref, step=3, extra={"k": 1})
    state = _port_state(name)
    arrays, meta = restore[1](str(tmp_path / "ref"), state_io.parts(state))
    assert meta["step"] == 3 and meta["extra"] == {"k": 1}
    state = state_io.load(state, arrays)
    _assert_port_holds(state, ref)
    # the port's write of it, read by the reference
    save[1](str(tmp_path / "port"), state_io.parts(state), step=3,
            extra={"k": 1})
    back, meta = restore[0](str(tmp_path / "port"),
                            jax.tree.map(np.zeros_like, ref))
    assert meta["step"] == 3
    _assert_same(back, ref)
    if fmt == "sharded":
        assert _dir_bytes(tmp_path / "port.sharded") == \
            _dir_bytes(tmp_path / "ref.sharded")
    else:
        assert json.load(open(tmp_path / "port.json")) == \
            json.load(open(tmp_path / "ref.json"))


@pytest.mark.parametrize("fmt", ["npz", "sharded"])
def test_avg50_stacked_state_crosses(fmt, tmp_path):
    """The reference's stacked avg50 state (a leading axis of two
    replicas, sharded over a 2-device mesh) and the port's replica per
    rank, ranks 0 and 1 emulated here."""
    rep = _reference_init("resnet_basic")
    ref = jax.tree.map(lambda a, b: np.stack([a, b]), _drawn(rep, 1),
                       _drawn(rep, 2))
    m = jax_mesh.make_mesh({"data": 2}, devices=jax.devices()[:2])
    placed = jax.device_put(ref, NamedSharding(m, P("data")))
    path = str(tmp_path / "ref")
    (jax_ckpt.save_sharded if fmt == "sharded" else jax_ckpt.save)(
        path, placed, step=8)
    reader = checkpoint.restore_sharded if fmt == "sharded" \
        else checkpoint.restore
    states, parts = [], []
    for r in range(2):
        st = _port_state("resnet_basic")
        arrays, _ = reader(path, state_io.image_parts(st, True, r, 2))
        states.append(state_io.load(st, arrays, stacked=True))
        _assert_port_holds(states[r], jax.tree.map(lambda x: x[r], ref))
        parts.append(state_io.image_parts(states[r], True, r, 2))
    out = str(tmp_path / "port")
    if fmt == "sharded":
        for r in range(2):                  # each rank its files
            jobs, meta = checkpoint.snapshot_sharded(parts[r])
            checkpoint._write_shard_files(out + ".sharded", jobs)
        meta.update(step=8, extra={})
        checkpoint._barrier_and_commit(out + ".sharded", meta)
        assert _dir_bytes(out + ".sharded") == _dir_bytes(path + ".sharded")
        back, _ = jax_ckpt.restore_sharded(out, jax.device_put(
            jax.tree.map(np.zeros_like, ref), NamedSharding(m, P("data"))))
    else:
        # the npz form holds whole leaves: the two replicas stacked
        checkpoint.save(out, [np.stack([_np(a.data), _np(b.data)])
                              for a, b in zip(*parts)], step=8)
        back, _ = jax_ckpt.restore(out, jax.tree.map(np.zeros_like, ref))
    _assert_same(jax.tree.map(np.asarray, back), ref)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------- one process

def _joined(*runs):
    """The lines of consecutive runs as one run would print them: the
    checkpoint notices and the repeated session header dropped."""
    out = []
    for lines in runs:
        for ln in lines:
            if ln.startswith(("[checkpoint]", "[preemption]")) or (
                    out and ln.startswith("Process ID")):
                continue
            out.append(ln)
    return out


def _state_leaves(state):
    return [np.asarray(p.data) for p in state_io.parts(state)]


def test_image_loop_stops_and_resumes(tmp_path):
    """psum, one process: a stop after step 5 (no trace point) saves
    step 5; the resumed run repeats the uninterrupted one."""
    full, full_lines, _ = worker.run_case("psum", str(tmp_path / "full"))
    part = str(tmp_path / "part")
    _, stop_lines, guards = worker.run_case("psum", part, stop=worker.STOP)
    assert guards[0].reason == "requested"
    assert checkpoint.latest_step(part) == worker.STOP
    assert "[preemption] requested: checkpointed step 5, exiting cleanly" \
        in stop_lines
    res, res_lines, _ = worker.run_case("psum", part, resume=True)
    assert res_lines[0] == "[checkpoint] resumed from step 5"
    assert _joined(stop_lines, res_lines) == full_lines
    for a, b in zip(_state_leaves(res.state), _state_leaves(full.state)):
        assert np.array_equal(a, b)
    # the metrics of the two runs together are the uninterrupted run's
    read = lambda d: [json.loads(ln) for ln in open(os.path.join(
        d, "metrics.jsonl"))]
    want, got = read(tmp_path / "full"), read(part)
    assert [(m["tag"], m["step"], m["value"]) for m in got
            if m["tag"].startswith("eval")] == \
        [(m["tag"], m["step"], m["value"]) for m in want
         if m["tag"].startswith("eval")]
    assert got[-1]["tag"] == want[-1]["tag"] == "perf/images_per_sec"
    assert got[-1]["step"] == want[-1]["step"] == res.num_steps


def test_train_mlm_stops_on_sigterm_and_resumes(tmp_path):
    """A SIGTERM during step 5 of ``train_mlm`` (one process): the
    handler's flag stops the run after that step, checkpointed, and the
    previous SIGTERM handler is back afterwards."""
    before = signal.getsignal(signal.SIGTERM)
    full, full_lines, _ = worker.run_case("replicated",
                                          str(tmp_path / "full"))
    part = str(tmp_path / "part")
    _, stop_lines, guards = worker.run_case("replicated", part,
                                            stop=worker.STOP, by_signal=True)
    assert guards[0].reason == "signal SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is before
    assert checkpoint.latest_step(part) == worker.STOP
    res, res_lines, _ = worker.run_case("replicated", part, resume=True)
    assert _joined(stop_lines, res_lines) == full_lines
    assert res.history == [h for h in full.history if h[0] > worker.STOP]
    for a, b in zip(_state_leaves(res.state), _state_leaves(full.state)):
        assert np.array_equal(a, b)
    tags = [(json.loads(ln)["tag"], json.loads(ln)["step"])
            for ln in open(os.path.join(tmp_path / "full", "metrics.jsonl"))]
    points = [t for t, _ in full.history]
    assert tags == [(tag, t) for t in points for tag in (
        "eval/heldout_error_pct", "train/loss")] + [
        ("perf/tokens_per_sec", full.num_steps)]


# ------------------------------------------------------- two gloo ranks

WORLD = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The worker's result and its directory (two ranks over gloo)."""
    workdir = tmp_path_factory.mktemp("ckpt_world")
    # one OpenMP and BLAS thread a rank, as its torch runs one: idle
    # pool threads spin for the CPU the six test workers share
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in mesh.LAUNCH_ENV:
        env.pop(k, None)
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(workdir)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        log.seek(0)
        assert rc == 0, f"rank {r} exited {rc}:\n{log.read()[-4000:]}"
        log.close()
    with open(workdir / "result.json") as f:
        result = json.load(f)
    with open(workdir / "rank1.json") as f:
        result["rank1_reasons"] = json.load(f)
    return result, workdir


def _whole(path):
    """Every leaf of ``<path>.sharded`` whole, as numpy arrays."""
    with open(path + ".sharded/meta.json") as f:
        meta = json.load(f)
    template = [checkpoint.Part(tuple(lm["shape"]), np.dtype(lm["dtype"]),
                                [((0,) * len(lm["shape"]),
                                  tuple(lm["shape"]))], 0, None, False)
                for lm in meta["leaves"]]
    return checkpoint.restore_sharded(path, template)[0]


@pytest.mark.parametrize("case", worker.CASES)
def test_two_ranks_stop_agreed_and_resume(world, case):
    result, workdir = world
    r = result[case]
    log_every = worker.IMAGE["log_every"] if case in ("psum", "avg50") \
        else worker.MLM_CONFIG["log_every"]
    # rank 0 asked after step STOP; both stopped at the next trace point
    agreed = (worker.STOP // log_every + 1) * log_every
    assert r["stopped_at"] == agreed
    assert r["stopped"]["reasons"] == ["requested"]
    assert result["rank1_reasons"][case] == ["peer preemption"]
    assert f"[preemption] requested: checkpointed step {agreed}, exiting " \
        "cleanly" in r["stopped"]["lines"]
    assert r["resumed"]["lines"][0] == \
        f"[checkpoint] resumed from step {agreed}"
    assert _joined(r["stopped"]["lines"], r["resumed"]["lines"]) == \
        r["full"]["lines"]
    last = r["last_step"]
    got = _whole(os.path.join(workdir, case, "part", f"ckpt_{last}"))
    want = _whole(os.path.join(workdir, case, "full", f"ckpt_{last}"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["replicated", "zero1", "fsdp"])
def test_two_rank_checkpoint_restores_at_world_one(world, case, tmp_path):
    """The stopped two-rank run's checkpoint, resumed in one process with
    the same global batch: the two-rank run's trace and, within ``TOL``,
    its final state."""
    result, workdir = world
    r = result[case]
    src = os.path.join(workdir, case, "part", f"ckpt_{r['stopped_at']}")
    shutil.copytree(src + ".sharded",
                    tmp_path / f"ckpt_{r['stopped_at']}.sharded")
    res, lines, _ = worker.run_case(
        "replicated", str(tmp_path), resume=True,
        world_batch=WORLD * worker.MLM_CONFIG["batch_size"])
    assert lines[0] == f"[checkpoint] resumed from step {r['stopped_at']}"
    assert [list(h) for h in res.history] == [
        h for h in r["full"]["history"] if h[0] > r["stopped_at"]]
    want = _whole(os.path.join(workdir, case, "full",
                               f"ckpt_{r['last_step']}"))
    got = [np.asarray(p.data) for p in state_io.parts(res.state)]
    names = [tree_lib.leaf_name(p) for p, _ in tree_lib.leaves_with_path(
        res.state.model.param_tree())]
    order = state_io.ref_order(res.state.model.param_tree())
    tol = [BK_TOL if names[i] == "bk" else TOL for i in order]
    n = len(order)
    for j, (a, b) in enumerate(zip(got, want)):
        if j < n:                                   # the parameters
            assert np.abs(a - b).max() <= tol[j], names[order[j]]
        elif np.issubdtype(a.dtype, np.integer):    # the counters
            assert np.array_equal(a, b)
        else:                           # Adam's moments, the float step
            assert np.abs(a - b).max() <= TOL, j


# ------------------------------------------------------ commit markers

def test_uncommitted_checkpoints_are_skipped(tmp_path):
    d = str(tmp_path)
    leaves = [np.arange(6, dtype=np.float32).reshape(2, 3)]
    checkpoint.save_sharded(checkpoint.step_path(d, 3), leaves, step=3)
    checkpoint.save(checkpoint.step_path(d, 4), leaves, step=4)
    # step 5: shard files, no meta.json; step 6: a bare .npz
    jobs, _ = checkpoint.snapshot_sharded(leaves)
    checkpoint._write_shard_files(checkpoint.step_path(d, 5) + ".sharded",
                                  jobs)
    np.savez(checkpoint.step_path(d, 6) + ".npz", leaf_00000=leaves[0])
    assert checkpoint.latest_step(d) == jax_ckpt.latest_step(d) == 4
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    # both formats of one step: the sharded one is read
    checkpoint.save(checkpoint.step_path(d, 3), [leaves[0] + 1], step=3)
    got, meta = checkpoint.restore_latest(d, leaves, 3)
    assert np.array_equal(got[0], leaves[0]) and meta["step"] == 3
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore_latest(d, [np.zeros((3, 2), np.float32)], 3)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_latest(d, leaves * 2, 4)


def test_async_saver_surfaces_a_failed_write(tmp_path):
    (tmp_path / "blocker").write_text("a file where a directory goes")
    saver = checkpoint.AsyncSaver()
    saver.save(str(tmp_path / "blocker" / "ckpt_1"), [np.zeros(2)], step=1)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        saver.wait()
    saver.save(str(tmp_path / "ok" / "ckpt_2"), [np.ones(2)], step=2)
    saver.close()
    assert checkpoint.latest_step(str(tmp_path / "ok")) == 2


# ------------------------------------------------------------- metrics

def test_metrics_lines_match_the_reference_writer(tmp_path):
    values = [("eval/test_error_pct", 12.5, 50), ("train/loss", float("nan"),
                                                   50),
              ("perf/images_per_sec", float("inf"), 100),
              ("train/loss", -float("inf"), 100), ("eval/x", 3, 7)]
    for w, d in ((lambda d: metrics_writer.for_process(d, 0), "port"),
                 (jax_mw.MetricsWriter, "ref")):
        mw = w(str(tmp_path / d))
        for tag, v, t in values:
            mw.scalar(tag, v, t)
        mw.close()
        mw.scalar("after/close", 1.0, 1)        # dropped
    read = lambda d: [{k: v for k, v in json.loads(ln).items()
                       if k != "time"} for ln in open(
                           tmp_path / d / "metrics.jsonl")]
    got = read("port")
    assert got == read("ref")
    assert [g["value"] for g in got] == [12.5, None, None, None, 3.0]
    # rank 1, and rank 0 with no directory: nothing written anywhere
    for d, rank in ((str(tmp_path / "rank1"), 1), (None, 0)):
        off = metrics_writer.for_process(d, rank)
        off.scalar("eval/test_error_pct", 1.0, 1)
        off.close()
    assert sorted(os.listdir(tmp_path)) == ["port", "ref"]


# ---------------------------------------------------------- preemption

def test_preemption_guard_signal_and_handlers():
    before = signal.getsignal(signal.SIGTERM)
    guard = preemption.PreemptionGuard.install()
    assert not guard.should_stop
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.should_stop and guard.reason == "signal SIGTERM"
    guard.request_stop("later")                 # the first reason stays
    assert guard.reason == "signal SIGTERM"
    guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before
    with pytest.raises(KeyError):
        with preemption.PreemptionGuard.installed() as g:
            assert signal.getsignal(signal.SIGTERM) == g._handler
            raise KeyError("the body fails")
    assert signal.getsignal(signal.SIGTERM) is before
    g = preemption.PreemptionGuard()
    g.request_stop()
    assert g.should_stop and g.reason == "requested"
