"""The port's data-parallel transformer training against the JAX
package's GSPMD step on a 2-device ``data`` mesh, on the CPU.

One module-scoped 2-rank gloo world (``tests/_torch_tdp_worker.py``, two
processes at one thread each) does the port's side while this process
runs the reference's on the virtual CPU platform, from parameters drawn
with numpy and carried across by ``convert.params_from_jax``.  BERT_TINY's
widths at one layer (``worker.LAYERS``), S = 32, global batch 4, float32,
dropout 0; the reference compiles with XLA's optimisation passes off, one
compile per step variant:

- (a) ``fsdp.tree_shard_dims`` against ``fsdp_tree_specs`` at BERT_TINY
  and BERT_BASE shapes for 2, 4 and 8 ranks: exactly;
- (b) ``reduce_scatter`` and the tiled ``allgather`` against numpy:
  exactly (one float32 sum of two);
- (c) three steps each of the replicated step, ``grad_accum`` 2, zero1
  and fsdp against ``make_gspmd_train_step`` from ``init_gspmd_state``,
  ``init_zero1_state`` and ``init_fsdp_state``: losses and parameters
  within 1e-5 (``bk`` within 3 x lr: its gradient is zero in exact
  arithmetic, see ``test_torch_bert_train.py``).  The ranks' rows hold
  different masked counts, and the control that averages per-rank mean
  losses misses that tolerance; each rank's bytes at rest equal the
  reference's per-device bytes;
- (d) ``train_mlm`` over the 2-rank world with ``grad_accum`` 2 against
  the reference's on the 2-device mesh: the global rows fed, byte for
  byte; the same history steps; errors within 1.5 points (one of ~77
  held-out masked positions flipping its argmax); trace lines from rank
  0 alone;
- (e) the CNN's psum step with ``grad_accum`` 2, in one process over two
  shards and across the two ranks, against the reference's on the mesh:
  parameters within 1e-5 after three steps;
- (f) the refusals: zero1/fsdp on a world of one rank, ``--param-
  sharding`` on the CNN, avg50 with accumulation, a batch that does not
  split into the microbatches.
"""

import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.data import synthetic as jax_synthetic
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import cnn as jax_cnn
from mpi_tensorflow_tpu.parallel import fsdp as jax_fsdp
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import mlm_loop as jax_mlm_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.train import step as jax_step
from mpi_tensorflow_torch import cli
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import bert, cnn, convert
from mpi_tensorflow_torch.parallel import collectives, fsdp, mesh
from mpi_tensorflow_torch.train import gspmd, mlm_loop, optimizer, step

import _torch_tdp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JCFG, TCFG = jax_bert.BERT_TINY, bert.BERT_TINY
DP_JCFG = dataclasses.replace(JCFG, layers=worker.LAYERS)    # (c), (d)
TOL = 1e-5                 # losses and parameters, absolute
BK_TOL = 3 * worker.LR
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# the CNN's convolutions run ~7x slower unoptimised; level 1 halves the
# default compile and keeps the steps fast
CNN_COMPILE = {"xla_backend_optimization_level": 1,
               "xla_llvm_disable_expensive_passes": True}
_COMPILED = {}


def _fast(key, jitted, options=FAST_COMPILE):
    """``jitted`` compiled at its first call with ``options``, once per
    ``key`` for the module: (c) and (d) run the same computation."""
    def call(*args):
        if key not in _COMPILED:
            _COMPILED[key] = jitted.lower(*args).compile(options)
        return _COMPILED[key](*args)
    return call


def _np_params(seed):
    """The reference's BertMlm tree with every leaf drawn from numpy:
    LayerNorm scales near 1, everything else normal x 0.1."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(jax_bert.BertMlm(DP_JCFG).init, jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh():
    return jax_mesh.make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


def _shard_bytes(tree) -> int:
    """The bytes one device holds of ``tree``'s arrays of rank >= 1."""
    return sum(4 * int(np.prod(x.sharding.shard_shape(x.shape)))
               for x in jax.tree.leaves(tree) if x.ndim >= 1)


def _reference_steps(mp, m, init, inputs) -> dict:
    """(c): each case's three losses, parameters and per-device bytes."""
    inits = {"replicated": jax_gspmd.init_gspmd_state,
             "zero1": jax_gspmd.init_zero1_state,
             "fsdp": jax_gspmd.init_fsdp_state}
    mp.setattr(jax_bert.BertMlm, "init",
               lambda self, rng: jax.tree.map(jnp.asarray, init))
    rng = JaxConfig().make_train_key(worker.MLM_CONFIG["seed"] + 2)
    out = {}
    for name, kind, accum in worker.CASES:
        model = jax_bert.BertMlm(DP_JCFG, mesh=m)
        tx = jax_opt.transformer_tx(worker.LR, worker.NUM_STEPS)
        state = inits[kind](model, tx, jax.random.key(0), m)
        train = _fast(("train", kind, accum), jax_gspmd.make_gspmd_train_step(
            model, m, tx, state_template=None if kind == "replicated"
            else state, grad_accum=accum))
        rest = {"params": _shard_bytes(state.params),
                "moments": _shard_bytes(state.opt)}
        losses = []
        for t in range(worker.STEPS):
            batch = jax_gspmd.shard_batch(
                {"tokens": inputs["tokens"][t], "mask": inputs["mask"][t]}, m)
            state, metrics = train(state, batch, jax_gspmd.shard_batch(
                inputs["targets"][t], m), rng)
            losses.append(float(metrics["loss"]))
        out[name] = (np.array(losses), _host(state.params), rest)
    return out


def _reference_mlm(mp, m) -> tuple:
    """(d): the reference's ``train_mlm`` on the mesh, recording the
    token rows fed to each train and eval step."""
    fed = []

    def recording(make, kind):
        def wrapped(*a, **kw):
            fn = _fast((kind, "replicated", kw.get("grad_accum", 1)),
                       make(*a, **kw))

            def call(state, batch, *rest):
                tok = batch["tokens"] if kind == "train" else batch
                fed.append((kind == "train", np.asarray(tok).copy()))
                return fn(state, batch, *rest)
            return call
        return wrapped

    mp.setattr(jax_gspmd, "make_gspmd_train_step",
               recording(jax_gspmd.make_gspmd_train_step, "train"))
    mp.setattr(jax_gspmd, "make_gspmd_eval_step",
               recording(jax_gspmd.make_gspmd_eval_step, "eval"))
    with contextlib.redirect_stdout(io.StringIO()) as text:
        res = jax_mlm_loop.train_mlm(JaxConfig(**worker.MLM_CONFIG), DP_JCFG,
                                     mesh=m, **worker.MLM)
    return res, fed, text.getvalue().splitlines()


def _reference_cnn(m, init, inputs):
    """(e): three psum steps with grad_accum 2 on the mesh."""
    model = jax_cnn.MnistCnn(dropout_rate=0.0)
    state = jax.device_put(jax_step.TrainState(
        init, jax_opt.momentum_init(init), {}), NamedSharding(m, P()))
    train = _fast(("cnn",), jax_step.make_train_step(
        model, JaxConfig(grad_accum=2, dropout_rate=0.0), m, 100),
        CNN_COMPILE)
    for t in range(worker.CNN_STEPS):
        state, _ = train(state, inputs["cnn_x"][t],
                         inputs["cnn_y"][t].astype(np.int32),
                         jax.random.key(0))
    return _host(state.params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(reference, [rank 0's npz, rank 1's npz], inputs)``: the workers
    run while this process computes the reference."""
    workdir = tmp_path_factory.mktemp("transformer_dp")
    init = _np_params(7)
    tokens, targets, mask = jax_synthetic.mlm_batches(
        worker.STEPS * worker.GLOBAL_B, seq_len=worker.S,
        vocab_size=JCFG.vocab_size, seed=11)
    shape = (worker.STEPS, worker.GLOBAL_B, worker.S)
    # the port's init (the reference's recipe), in the reference's layout
    cnn_init = convert.cnn_params_to_numpy(cnn.init_params(
        torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(3)
    inputs = {"tokens": tokens.reshape(shape),
              "targets": targets.reshape(shape), "mask": mask.reshape(shape),
              "cnn_x": rng.random((worker.CNN_STEPS, WORLD * worker.CNN_B,
                                   28, 28, 1), dtype=np.float32),
              "cnn_y": rng.integers(0, 10, (worker.CNN_STEPS,
                                            WORLD * worker.CNN_B)),
              **worker.flatten(init, "init"),
              **worker.flatten(cnn_init, "cnn")}
    np.savez(workdir / "inputs.npz", **inputs)
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
         str(workdir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    mp = pytest.MonkeyPatch()
    try:
        m = _mesh()
        ref = {"steps": _reference_steps(mp, m, init, inputs),
               "mlm": _reference_mlm(mp, m),
               "cnn": _reference_cnn(m, cnn_init, inputs)}
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        mp.undo()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        log.seek(0)
        assert rc == 0, f"rank {r} exited {rc}:\n{log.read()[-4000:]}"
        log.close()
    ranks = [np.load(workdir / f"rank{r}.npz") for r in range(WORLD)]
    return ref, ranks, inputs


def _hold_params(got: dict, want, what: str) -> None:
    """Every leaf within ``TOL``, ``bk`` within ``BK_TOL``."""
    for key, w in worker.flatten(want, "").items():
        tol = BK_TOL if key.endswith("/bk") else TOL
        np.testing.assert_allclose(got[key], w, atol=tol, rtol=0,
                                   err_msg=f"{what}{key}")


def _rank_params(npz, prefix: str) -> dict:
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix + "/")}


# ----------------------------------------------------------------- (a)

@pytest.mark.parametrize("geometry", ["tiny", "base"])
def test_fsdp_shard_dims_match_reference(geometry):
    jcfg = JCFG if geometry == "tiny" else jax_bert.BERT_BASE
    model = jax_bert.BertMlm(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    if geometry == "tiny":      # the port's own tree, leaf for leaf
        ours = bert.BertMlm.from_seed(TCFG, 0).param_tree()
        assert jax.tree.map(lambda x: tuple(x.shape), shapes) == \
            jax.tree.map(lambda x: tuple(x.shape), ours)
    else:
        ours = shapes
    seen = set()
    for w in (2, 4, 8):
        m = jax_mesh.make_mesh({"data": w}, devices=jax.devices()[:w])
        specs = jax_fsdp.fsdp_tree_specs(shapes, m, model.logical_axes())
        want = jax.tree.map(
            lambda s: next((d for d, e in enumerate(s) if e == "data"),
                           None), specs,
            is_leaf=lambda s: isinstance(s, P))
        got = fsdp.tree_shard_dims(ours, w)
        assert jax.tree.leaves(got, is_leaf=lambda x: x is None) == \
            jax.tree.leaves(want, is_leaf=lambda x: x is None), w
        seen.update(jax.tree.leaves(got, is_leaf=lambda x: x is None))
    assert {None, 0, 1}.issubset(seen)   # replicated, and both ties


# ----------------------------------------------------------------- (b)

def test_reduce_scatter_and_tiled_allgather_against_numpy(world):
    _, ranks, _ = world
    xs = [np.random.default_rng(10 + r).normal(size=(4, 3)).astype(
        np.float32) for r in range(WORLD)]
    total = xs[0] + xs[1]
    for r in range(WORLD):
        got = ranks[r]["coll/reduce_scatter"]
        assert got.dtype == np.float32
        assert np.array_equal(got, total[2 * r:2 * r + 2])
        assert np.array_equal(ranks[r]["coll/allgather_tiled"],
                              np.concatenate([x[:2] for x in xs]))


def test_zero_collectives_without_a_group_and_the_flat_layout():
    assert not mesh.active()
    x = torch.arange(6.0).reshape(3, 2)
    assert collectives.reduce_scatter(x) is x
    assert collectives.allgather(x, tiled=True) is x
    # a rank's slice, and the leaves rebuilt from the packed ranks' slices
    leaves = [x, torch.arange(4.0), torch.arange(24.0).reshape(2, 3, 4)]
    dims = [1, None, 2]
    layout = fsdp.FlatLayout([t.shape for t in leaves], dims, 2)
    assert layout.chunk == 3 + 12
    assert torch.equal(fsdp.shard(x, 1, 1, 2), x[:, 1:])
    chunks = [layout.pack_own(leaves, r, torch.empty(layout.chunk))
              for r in range(2)]
    flat = torch.cat(chunks)
    assert torch.equal(flat, layout.pack(leaves, torch.empty(30)))
    whole = layout.whole(flat)
    assert set(whole) == {0, 2}
    for i in (0, 2):
        assert torch.equal(whole[i], leaves[i])
    for r in range(2):
        for i, view in layout.views(chunks[r]).items():
            assert torch.equal(view, fsdp.shard(leaves[i], dims[i], r, 2))


# ----------------------------------------------------------------- (c)

@pytest.mark.parametrize("case", [c[0] for c in worker.CASES])
def test_dp_steps_match_reference(world, case):
    ref, ranks, _ = world
    want_losses, want_params, _ = ref["steps"][case]
    accum = {c[0]: c[2] for c in worker.CASES}[case]
    for r in range(WORLD):
        got = ranks[r]
        assert np.array_equal(got[f"{case}/rows"], mlm_loop.rank_rows(
            0, worker.GLOBAL_B, accum, r, WORLD))
        np.testing.assert_allclose(got[f"{case}/losses"], want_losses,
                                   atol=TOL, rtol=0)
        _hold_params(_rank_params(got, f"{case}/params"), want_params,
                     f"{case} rank {r}")
    for k in _rank_params(ranks[0], f"{case}/params"):
        assert np.array_equal(ranks[0][f"{case}/params{k}"],
                              ranks[1][f"{case}/params{k}"])


def test_loss_is_the_global_mean_not_a_mean_of_rank_means(world):
    ref, ranks, inputs = world
    counts = inputs["mask"].reshape(worker.STEPS, WORLD, -1).sum(-1)
    assert np.any(counts[:, 0] != counts[:, 1])       # the ranks differ
    want_losses, want_params, _ = ref["steps"]["replicated"]
    got = ranks[0]
    assert np.abs(got["control/losses"] - want_losses).max() > 10 * TOL
    control = _rank_params(got, "control/params")
    worst = max(np.abs(control[k] - w).max()
                for k, w in worker.flatten(want_params, "").items())
    assert worst > 10 * TOL


@pytest.mark.parametrize("case", ["replicated", "zero1", "fsdp"])
def test_bytes_at_rest_match_reference_shards(world, case):
    """Each rank's parameters and moments at rest: the reference's
    per-device bytes of the same layout, and for zero1 the moments and
    for fsdp both about half of a replica's."""
    ref, ranks, _ = world
    want = ref["steps"][case][2]
    for r in range(WORLD):
        got = {k: int(ranks[r][f"{case}/bytes/{k}"])
               for k in ("params", "moments", "replica_params",
                         "replica_moments")}
        assert got["params"] == want["params"]
        assert got["moments"] == want["moments"]
        share = {"params": got["params"] / got["replica_params"],
                 "moments": got["moments"] / got["replica_moments"]}
        if case == "replicated":
            assert share == {"params": 1.0, "moments": 1.0}
        else:
            assert 0.5 <= share["moments"] < 0.51
            assert share["params"] == 1.0 if case == "zero1" \
                else 0.5 <= share["params"] < 0.51


# ----------------------------------------------------------------- (d)

def test_train_mlm_over_two_ranks_matches_reference(world):
    ref, ranks, _ = world
    want, want_fed, want_lines = ref["mlm"]
    per = worker.MLM_CONFIG["batch_size"] // worker.MLM_CONFIG["grad_accum"]
    train = ranks[0]["mlm/train"]
    assert np.array_equal(train, ranks[1]["mlm/train"])
    assert list(train) == [t for t, _ in want_fed]
    for j, (is_train, w) in enumerate(want_fed):
        parts = [ranks[r]["mlm/tokens"][j] for r in range(WORLD)]
        if is_train:        # microbatch i: every rank's rows of it
            parts = [p[i * per:(i + 1) * per] for i in range(
                worker.MLM_CONFIG["grad_accum"]) for p in parts]
        assert np.concatenate(parts).tobytes() == w.tobytes(), j
    assert want.num_steps == 16 and want.num_devices == WORLD
    for r in range(WORLD):
        got = ranks[r]
        assert int(got["mlm/num_steps"]) == want.num_steps
        assert int(got["mlm/num_devices"]) == WORLD
        history = [tuple(h) for h in got["mlm/history"]]
        assert [t for t, _ in history] == [t for t, _ in want.history] \
            == [4, 8, 12, 15]
        for (_, e_got), (_, e_want) in zip(history, want.history):
            assert abs(e_got - e_want) <= 1.5
        assert np.isfinite(float(got["mlm/final_loss"]))
    assert list(ranks[1]["mlm/lines"]) == []
    pat = re.compile(r"0  process at  (\d+) with test error: ([\d.]+)%")
    lines = [str(ln) for ln in ranks[0]["mlm/lines"]]
    assert lines[0] == want_lines[0] == \
        "Process ID: 0  training session starts!"
    got_trace = [pat.fullmatch(ln) for ln in lines[1:-1]]
    want_trace = [pat.fullmatch(ln) for ln in want_lines[1:-1]]
    assert [int(g[1]) for g in got_trace] == [int(w[1]) for w in want_trace]
    assert lines[-1].startswith("[timing]") and \
        lines[-1].endswith("| 2 device(s)")


# ----------------------------------------------------------------- (e)

@pytest.mark.parametrize("where", ["in_process", "across_ranks"])
def test_cnn_grad_accum_matches_reference(world, where):
    ref, ranks, inputs = world
    if where == "across_ranks":
        got = [_rank_params(ranks[r], "cnn/params") for r in range(WORLD)]
    else:
        model = cnn.MnistCnn(convert.cnn_params_from_jax(
            worker.unflatten(dict(inputs), "cnn")), dropout_rate=0.0)
        state = step.init_state(model)
        train_step = step.make_train_step(
            model, Config(grad_accum=2, dropout_rate=0.0), WORLD, 100)
        for t in range(worker.CNN_STEPS):
            train_step(state, torch.from_numpy(inputs["cnn_x"][t]),
                       torch.from_numpy(inputs["cnn_y"][t]))
        got = [worker.flatten(convert.cnn_params_to_numpy(
            model.param_tree()), "")]
    for params in got:
        for key, w in worker.flatten(ref["cnn"], "").items():
            np.testing.assert_allclose(params[key], w, atol=TOL, rtol=0,
                                       err_msg=f"{where} {key}")


# ----------------------------------------------------------------- (f)

def _mlm(**kw):
    return mlm_loop.train_mlm(
        Config(model="bert_base", epochs=1, batch_size=4, **kw), TCFG,
        seq_len=8, train_n=8, test_n=4, verbose=False, device="cpu")


@pytest.mark.parametrize("case", ["zero1_world1", "fsdp_world1",
                                  "cnn_param_sharding", "avg50_accum",
                                  "batch_not_divisible"])
def test_refusals(case, monkeypatch):
    for k in mesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    if case in ("zero1_world1", "fsdp_world1"):
        kind = case.split("_")[0]
        with pytest.raises(ValueError, match=f"--param-sharding {kind} "
                                             f"shards over the 'data'"):
            _mlm(param_sharding=kind)
        tx = optimizer.transformer_tx(1e-3, 1)
        with pytest.raises(ValueError, match="mesh has none"):
            gspmd.init_for(kind, bert.BertMlm.from_seed(TCFG, 0), tx)
    elif case == "cnn_param_sharding":
        with pytest.raises(SystemExit, match="applies to the transformer"):
            cli.main(["--device", "cpu", "--param-sharding", "zero1"])
    elif case == "avg50_accum":
        with pytest.raises(ValueError, match="avg50 fidelity mode"):
            Config(sync="avg50", grad_accum=2)
        with pytest.raises(ValueError, match="avg50 fidelity mode"):
            cli.main(["--device", "cpu", "--sync", "avg50",
                      "--grad-accum", "2"])
    else:
        with pytest.raises(ValueError, match="not divisible by grad_accum"):
            _mlm(grad_accum=3)
        tx = optimizer.transformer_tx(1e-3, 1)
        model = bert.BertMlm.from_seed(TCFG, 0)
        tokens = torch.zeros((3, 8), dtype=torch.int32)
        with pytest.raises(ValueError, match="not divisible by grad_accum"):
            gspmd.make_train_step(tx, grad_accum=2)(
                gspmd.init_state(model, tx),
                {"tokens": tokens, "mask": tokens.bool()}, tokens.long())
        cnn_model = cnn.MnistCnn.from_seed(1, dropout_rate=0.0)
        with pytest.raises(ValueError, match="per-shard batch 3 not "
                                             "divisible by grad_accum 2"):
            step.make_train_step(cnn_model, Config(grad_accum=2), 1, 100)(
                step.init_state(cnn_model), torch.zeros((3, 28, 28, 1)),
                torch.zeros(3, dtype=torch.int64))
