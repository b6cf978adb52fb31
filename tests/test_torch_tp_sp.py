"""The port's tensor and sequence parallelism (the ``model`` and ``seq``
mesh axes) against the JAX package on the same meshes, on the CPU.

One module-scoped 4-rank gloo world (``tests/_torch_tpsp_worker.py``,
four processes at one thread each) does the port's side while this
process runs the reference's on 4 of the 8 virtual CPU devices, from
parameters drawn with numpy and carried across by
``convert.params_from_jax``.  BERT_TINY's widths at one layer with 8
heads of 8 (so Ulysses leaves a rank several heads), S = 32, global
batch 4, float32, dropout 0 unless said; the reference compiles with
XLA's optimisation passes off:

- (a) ``ring_attention`` (causal or not, ``block_k`` None and 8) and
  ``ulysses_attention`` on ``{seq: 4}``, output and the gradients of q,
  k, v, against the reference's under ``shard_map`` (its Ulysses inner
  attention dense, the port's the flash kernels' plain version): 1e-5;
- (a') ``mlm_head.vocab_parallel_ce``, dense and tiled, on ``{model:
  4}`` against the whole vocabulary's CE and gradients: 1e-5; and
  ``vocab_parallel_argmax`` there equal to ``argmax`` of the whole
  logits, ties planted across, at the edge of and within the slices;
- (b) three steps of ``BertMlm`` on ``{model: 2, seq: 2}`` (ring and
  Ulysses), ``{data: 2, model: 2}``, ``{data: 2, seq: 2}``,
  ``{data: 2, model: 2}`` under zero1 and fsdp and ``{data: 2, seq:
  2}`` under fsdp: losses and the
  parameters gathered whole within 1e-5 (``bk`` within 3 x lr) of the
  reference's step on the same mesh (zero1 and fsdp against its
  replicated layout there: one compile a mesh), and the zero1 / fsdp
  shard dimensions equal to ``fsdp_tree_specs``' on that mesh;
- (c) ``gpt_base`` on ``{model: 2, seq: 2}`` ring: the next-token target
  of each block's last position is the next block's first token;
- (d) at dropout 0.1 every leaf a model rank holds whole is bit-equal
  across the model ranks after 3 steps, and every block bit-equal
  across the seq ranks;
- (e) a sharded checkpoint saved on ``{model: 2, seq: 2}`` restores at
  world 1 and its next step matches the mesh's within 1e-5;
- (f) ``train_mlm`` on ``{model: 2, seq: 2}`` (bert_base) and ``{data:
  2, seq: 2}`` (gpt_base) against itself at world 1, and the spec rules
  against the reference's; its eval's predictions after each mesh of
  (b), (c), every rank's block and the blocks placed whole
  (``mlm_loop.place_predictions``), equal element for element to the
  argmax of the world-1 model's logits from the gathered parameters;
  the meshes' subgroups made once a world;
- (g) the refusals: the expert and pipe axes, moe_bert and encdec_t5
  under the model axis, a length the seq axis does not divide, Ulysses'
  ``H % n``, a vocabulary the model axis does not divide.
"""

import contextlib
import dataclasses
import functools
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
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.parallel import fsdp as jax_fsdp
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.parallel import ring as jax_ring
from mpi_tensorflow_tpu.parallel import sharding_rules as jax_rules
from mpi_tensorflow_tpu.parallel import ulysses as jax_ulysses
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import bert, convert, gpt
from mpi_tensorflow_torch.parallel import mesh, sharding_rules
from mpi_tensorflow_torch.parallel.ulysses import ulysses_attention
from mpi_tensorflow_torch.train import (checkpoint, gspmd, mlm_loop,
                                        optimizer, state_io)
from mpi_tensorflow_torch.utils import tree as tree_lib

import _torch_tpsp_worker as worker
from _torch_tdp_worker import flatten, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TOL = 1e-5                 # outputs, losses and parameters, absolute
BK_TOL = 3 * worker.LR
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
STEP_CASES = worker.CASES + (worker.GPT_CASE,)


def _jcfg(sp_impl: str = "ring"):
    return dataclasses.replace(jax_bert.BERT_TINY, layers=worker.LAYERS,
                               heads=worker.HEADS, sp_impl=sp_impl)


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:n])


def _np_params(seed):
    """The reference's BertMlm tree with every leaf drawn from numpy:
    LayerNorm scales near 1, everything else normal x 0.1."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(jax_bert.BertMlm(_jcfg()).init, jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def _reference_attention(inputs) -> dict:
    """(a): every case's output and gradients, one compile."""
    m = _jmesh({"seq": 4})
    spec = P(None, None, "seq")

    def sharded(fn):
        return jax.shard_map(fn, mesh=m, in_specs=(spec,) * 3,
                             out_specs=spec, check_vma=False)

    fns = {f"attn/ring/{c}/{bk}": functools.partial(
        jax_ring.ring_attention, axis_name="seq", causal=c, block_k=bk)
        for c, bk in worker.ATTN_CASES}
    fns.update({f"attn/ulysses/{c}": functools.partial(
        jax_ulysses.ulysses_attention, axis_name="seq", causal=c)
        for c in (False, True)})

    def every(q, k, v, g):
        out = {}
        for name, fn in fns.items():
            o, vjp = jax.vjp(sharded(fn), q, k, v)
            out[name] = (o, *vjp(g))
        return out

    args = [inputs[f"attn/{k}"] for k in "qkvg"]
    res = jax.jit(every).lower(*args).compile(FAST_COMPILE)(*args)
    return {f"{name}/{key}": np.asarray(x) for name, xs in res.items()
            for key, x in zip(("out", "dq", "dk", "dv"), xs)}


def _reference_steps(mp, init, inputs) -> dict:
    """(b), (c): each mesh's three losses and parameters (zero1 and fsdp
    take the reference's step on the same mesh, whose numbers the layout
    does not change), and the data dimension of each leaf in
    ``fsdp_tree_specs`` on that mesh."""
    mp.setattr(jax_bert.BertMlm, "init",
               lambda self, rng: jax.tree.map(jnp.asarray, init))
    rng = JaxConfig().make_train_key(3)
    out = {}
    for name, shape, sp_impl, kind in STEP_CASES:
        m = _jmesh(shape)
        cls = jax_gpt.CausalLm if name.startswith("gpt") else \
            jax_bert.BertMlm
        model = cls(_jcfg(sp_impl), mesh=m)
        specs = jax_fsdp.fsdp_tree_specs(init, m, model.logical_axes())
        dims = flatten(jax.tree.map(
            lambda s: next((d for d, e in enumerate(s) if e == "data"), -1),
            specs, is_leaf=lambda s: isinstance(s, P)), "")
        same = next((c[0] for c in STEP_CASES if c[1] == shape
                     and c[2] == sp_impl and c[3] == "replicated"
                     and c[0][:3] == name[:3]), name)
        if same != name:
            out[name] = out[same][:2] + (dims,)
            continue
        tx = jax_opt.transformer_tx(worker.LR, worker.NUM_STEPS)
        state = jax_gspmd.init_gspmd_state(model, tx, jax.random.key(0), m)
        train = jax_gspmd.make_gspmd_train_step(model, m, tx)
        compiled = None
        losses = []
        for t in range(worker.STEPS):
            batch = jax_gspmd.shard_batch(
                {"tokens": inputs["tokens"][t], "mask": inputs["mask"][t]}, m)
            tgt = jax_gspmd.shard_batch(inputs["targets"][t], m)
            if compiled is None:
                compiled = train.lower(state, batch, tgt, rng).compile(
                    FAST_COMPILE)
            state, metrics = compiled(state, batch, tgt, rng)
            losses.append(float(metrics["loss"]))
        out[name] = (np.array(losses), jax.tree.map(np.asarray,
                                                     state.params), dims)
    return out


def _tied_logits(rng) -> np.ndarray:
    """``worker.ARGMAX_SHAPE`` logits whose positions in
    ``worker.ARGMAX_TIES`` hold their row's maximum at every named
    column."""
    logits = rng.normal(size=worker.ARGMAX_SHAPE).astype(np.float32)
    for pos, cols in worker.ARGMAX_TIES:
        logits[pos][list(cols)] = logits[pos].max() + 1.0
    return logits


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(reference, [each rank's npz], inputs, workdir)``: the workers
    run while this process computes the reference."""
    workdir = tmp_path_factory.mktemp("tp_sp")
    init = _np_params(7)
    tokens, targets, mask = jax_synthetic.mlm_batches(
        worker.STEPS * worker.GLOBAL_B, seq_len=worker.S,
        vocab_size=jax_bert.BERT_TINY.vocab_size, seed=11)
    shape = (worker.STEPS, worker.GLOBAL_B, worker.S)
    rng = np.random.default_rng(5)
    inputs = {"tokens": tokens.reshape(shape),
              "targets": targets.reshape(shape), "mask": mask.reshape(shape),
              **{f"attn/{k}": rng.normal(size=worker.ATTN_SHAPE).astype(
                  np.float32) for k in "qkvg"},
              "ce/t": rng.normal(size=worker.CE_SHAPE).astype(np.float32),
              "ce/emb": rng.normal(size=(1024, worker.CE_SHAPE[2])).astype(
                  np.float32),
              "ce/b": rng.normal(size=1024).astype(np.float32),
              "ce/labels": rng.integers(0, 1024, worker.CE_SHAPE[:2]),
              "ce/g": rng.random(worker.CE_SHAPE[:2]).astype(np.float32),
              "argmax/logits": _tied_logits(rng),
              **flatten(init, "init")}
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in mesh.LAUNCH_ENV:
        env.pop(k, None)
    port = mesh.free_port()
    # output to files, not pipes: a rank blocked on a full pipe could no
    # longer reach the collective its peers wait in
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(port),
         str(workdir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    mp = pytest.MonkeyPatch()
    try:
        ref = {"attn": _reference_attention(inputs),
               "steps": _reference_steps(mp, init, inputs)}
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
    return ref, ranks, inputs, workdir


def _hold_params(got: dict, want, what: str) -> None:
    """Every leaf within ``TOL``, ``bk`` within ``BK_TOL``."""
    for key, w in flatten(want, "").items():
        tol = BK_TOL if key.endswith("/bk") else TOL
        np.testing.assert_allclose(got[key], w, atol=tol, rtol=0,
                                   err_msg=f"{what}{key}")


def _rank_params(npz, prefix: str) -> dict:
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix + "/")}


def _coords(shape, r):
    return dict(zip(shape, np.unravel_index(r, tuple(shape.values()))))


# ----------------------------------------------------------------- (a)

@pytest.mark.parametrize("name", [f"attn/ring/{c}/{bk}"
                                  for c, bk in worker.ATTN_CASES]
                         + [f"attn/ulysses/{c}" for c in (False, True)])
def test_sequence_parallel_attention_matches_reference(world, name):
    ref, ranks, _, _ = world
    for key in ("out", "dq", "dk", "dv"):
        got = np.concatenate([ranks[r][f"{name}/{key}"]
                              for r in range(WORLD)], axis=2)
        np.testing.assert_allclose(got, ref["attn"][f"{name}/{key}"],
                                   atol=TOL, rtol=0, err_msg=f"{name} {key}")


@pytest.mark.parametrize("chunk", worker.CE_CHUNKS)
def test_vocab_parallel_ce_matches_the_whole_vocabulary(world, chunk):
    """The CE over a vocabulary split on {model: 4}, dense or by tiles
    that do not divide a rank's rows: every rank's CE, and its gradients
    of t and of its own rows, against the whole vocabulary's."""
    _, ranks, _, _ = world
    for r in range(WORLD):
        assert (ranks[r][f"ce/{chunk}"] <= TOL).all(), (
            r, ranks[r][f"ce/{chunk}"])


def test_vocab_parallel_argmax_takes_the_lowest_tied_index(world):
    """Every rank's argmax over logits split on {model: 4} is the whole
    logits' ``argmax``: among ties, across two ranks' slices, at a
    slice's edge, within a slice or over all four, the lowest index."""
    _, ranks, inputs, _ = world
    logits = inputs["argmax/logits"]
    want = logits.argmax(-1)
    for pos, cols in worker.ARGMAX_TIES:
        assert (logits[pos] == logits[pos].max()).sum() == len(cols)
        assert want[pos] == cols[0]
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["argmax/ids"], want,
                                      err_msg=f"rank {r}")


# ------------------------------------------------------------ (b), (c)

@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_sharded_steps_match_reference(world, case):
    ref, ranks, inputs, _ = world
    want_losses, want_params, want_dims = ref["steps"][case]
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"{case}/losses"], want_losses,
                                   atol=TOL, rtol=0, err_msg=f"rank {r}")
    _hold_params(_rank_params(ranks[0], f"{case}/params"), want_params,
                 f"{case} ")
    if f"{case}/dims" in ranks[0].files:
        paths = ["/" + "/".join(map(str, p)) for p, _ in
                 tree_lib.leaves_with_path(bert.BertMlm.from_seed(
                     worker.tiny(), 0).param_tree())]
        for r in range(WORLD):
            got = dict(zip(paths, ranks[r][f"{case}/dims"].tolist()))
            assert got == want_dims, r
        assert {0, 1, -1}.issubset(want_dims.values())


# ----------------------------------------------------------------- (d)

def test_dropout_keeps_replicated_leaves_identical(world):
    _, ranks, _, _ = world
    shape = worker.DROPOUT_CASE[1]
    own = [_rank_params(ranks[r], "dropout/own") for r in range(WORLD)]
    losses = [ranks[r]["dropout/losses"] for r in range(WORLD)]
    at = [_coords(shape, r) for r in range(WORLD)]
    specs = {"/" + "/".join(map(str, p)): sp for p, sp in
             tree_lib.leaves_with_path(sharding_rules.tree_specs(
                 bert.BertMlm.from_seed(worker.tiny(), 0).logical_axes(),
                 shape))}
    split = {k for k, sp in specs.items() if sp}
    assert split and len(split) < len(specs)
    for r in range(1, WORLD):
        assert np.array_equal(losses[r], losses[0])
        for key, x in own[r].items():
            same_block = at[r]["model"] == at[0]["model"]
            if key not in split or same_block:
                assert np.array_equal(x, own[0][key]), (r, key)
            else:
                assert not np.array_equal(x, own[0][key]), (r, key)
    # the masks did act: the run parts from the dropout-0 one
    assert not np.allclose(losses[0][1:], ranks[0]["mxs_ring/losses"][1:])


# ----------------------------------------------------------------- (e)

def test_checkpoint_saved_on_the_mesh_restores_at_world_one(world):
    ref, ranks, inputs, workdir = world
    model = bert.BertMlm(worker.tiny(), convert.params_from_jax(
        unflatten(dict(inputs), "init")))
    tx = optimizer.transformer_tx(worker.LR, worker.NUM_STEPS)
    state = gspmd.init_for("replicated", model, tx)
    arrays, meta = checkpoint.restore_sharded(
        str(workdir / "ckpt"), state_io.parts(state))
    state_io.load(state, arrays)
    assert meta["step"] == worker.CKPT_AT == state.step == state.opt.count
    step = gspmd.make_train_step(tx)
    losses = []
    for t in range(worker.CKPT_AT, worker.STEPS):
        put = lambda a: torch.from_numpy(a[t].copy())
        losses.append(float(step(state, {"tokens": put(inputs["tokens"]),
                                         "mask": put(inputs["mask"])},
                                 put(inputs["targets"]))[1]["loss"]))
    name = worker.CKPT_CASE[0]
    got = ranks[0][f"{name}/losses"][worker.CKPT_AT:]
    np.testing.assert_allclose(losses, got, atol=TOL, rtol=0)
    np.testing.assert_allclose(losses, ref["steps"][name][0][
        worker.CKPT_AT:], atol=TOL, rtol=0)
    mine = flatten(convert.params_to_numpy(model.param_tree()), "")
    _hold_params(mine, unflatten(_rank_params(ranks[0], f"{name}/params"),
                                 ""), "restored ")


# ----------------------------------------------------------------- (f)

@pytest.mark.parametrize("family", [f for f, _, _ in worker.MLM_RUNS])
def test_train_mlm_over_the_mesh_matches_one_process(world, family):
    _, ranks, _, _ = world
    _, shape, _ = next(r for r in worker.MLM_RUNS if r[0] == family)
    with contextlib.redirect_stdout(io.StringIO()):
        want = mlm_loop.train_mlm(
            Config(model=family, epochs=1, batch_size=worker.GLOBAL_B,
                   log_every=4, seed=1), worker.tiny(), device="cpu",
            **worker.MLM)
    for r in range(WORLD):
        got = ranks[r]
        history = [tuple(h) for h in got[f"mlm/{family}/history"]]
        assert [t for t, _ in history] == [t for t, _ in want.history] \
            == [4, 7]
        for (_, e_got), (_, e_want) in zip(history, want.history):
            assert abs(e_got - e_want) <= 1.5
        assert abs(float(got[f"mlm/{family}/final_loss"])
                   - want.final_loss) <= TOL
        assert int(got[f"mlm/{family}/num_devices"]) == WORLD
        lines = [str(x) for x in got[f"mlm/{family}/lines"]]
        if r:
            assert lines == []
        else:
            assert lines[0] == "Process ID: 0  training session starts!"
            assert re.fullmatch(r"0  process at  4 with test error: "
                                r"[\d.]+%", lines[1])
            assert lines[-1].endswith(f"| {WORLD} device(s)")


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_eval_predictions_match_world_one(world, case):
    """``train_mlm``'s eval predictions on one window after the mesh's
    three steps: each rank's block (its data coordinate's rows, its seq
    coordinate's positions, ``vocab_argmax`` over the vocabulary's
    slices) and the blocks placed whole by ``place_predictions`` equal,
    element for element, the argmax of the world-1 model's logits from
    the parameters gathered whole."""
    _, ranks, inputs, _ = world
    _, shape, sp_impl, _ = next(c for c in STEP_CASES if c[0] == case)
    cls = gpt.TrainableCausalLm if case.startswith("gpt") else bert.BertMlm
    model = cls(worker.tiny(sp_impl), convert.params_from_jax(unflatten(
        _rank_params(ranks[0], f"{case}/params"), "")))
    with torch.no_grad():
        want = model.apply(torch.from_numpy(inputs["tokens"][0].copy()),
                           train=False).argmax(-1).numpy()
    bs = worker.GLOBAL_B // shape.get("data", 1)
    n = worker.S // shape.get("seq", 1)
    for r in range(WORLD):
        at = _coords(shape, r)
        d, q = at.get("data", 0), at.get("seq", 0)
        np.testing.assert_array_equal(
            ranks[r][f"{case}/pred"],
            want[d * bs:(d + 1) * bs, q * n:(q + 1) * n], err_msg=f"rank {r}")
    np.testing.assert_array_equal(ranks[0][f"{case}/placed"], want)


def test_meshes_share_their_subgroups(world):
    """Every mesh the world made (``{seq: 4}``, ``{model: 4}``, and the
    three two-by-two shapes, several times each) drew on four
    subgroups, the two pairs of each kind of line; a second mesh of one
    shape holds the first's."""
    _, ranks, _, _ = world
    for r in range(WORLD):
        assert int(ranks[r]["mesh/subgroups"]) == 4, r
        assert bool(ranks[r]["mesh/reused"]), r


@pytest.mark.parametrize("shape", [{"model": 2}, {"data": 2, "model": 2},
                                   {"model": 2, "seq": 2}, {"seq": 4},
                                   {"data": 1, "model": 4}])
def test_spec_rules_match_reference(shape):
    want = jax_rules.tree_specs(jax_bert.BertMlm(_jcfg()).logical_axes(),
                                _jmesh(shape))
    got = sharding_rules.tree_specs(
        bert.BertMlm.from_seed(worker.tiny(), 0).logical_axes(), shape)
    want = flatten(jax.tree.map(tuple, want,
                                is_leaf=lambda s: isinstance(s, P)), "")
    assert flatten(got, "") == want


# ----------------------------------------------------------------- (g)

@pytest.mark.parametrize("case", ["expert_axis", "pipe_axis",
                                  "moe_under_model", "moe_under_seq",
                                  "encdec_under_model", "encdec_under_seq",
                                  "seq_len", "ulysses_heads",
                                  "vocab_indivisible"])
def test_refusals(case, world):
    _, ranks, _, _ = world
    if case in ("expert_axis", "pipe_axis"):
        axis = case.split("_")[0]
        item = {"expert": "14c", "pipe": "14d"}[axis]
        for make in (lambda: Config(mesh_shape={"data": 1, axis: 2}),
                     lambda: mesh.make_mesh({"data": 1, axis: 2})):
            with pytest.raises(NotImplementedError, match=f"item {item}"):
                make()
    elif case.startswith(("moe", "encdec")):
        family = "moe_bert" if case.startswith("moe") else "encdec_t5"
        axis = case.rsplit("_", 1)[1]
        if case == "encdec_under_seq":
            # the reference's own refusal (data x model meshes only)
            with pytest.raises(ValueError, match="data x model"):
                Config(model=family, mesh_shape={axis: 2})
            return
        item = "14c" if family == "moe_bert" else "14e"
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            Config(model=family, mesh_shape={axis: 2})
        from mpi_tensorflow_torch.train.mlm_loop import FAMILIES

        with pytest.raises(NotImplementedError, match=f"item {item}"):
            FAMILIES[family].from_seed(worker.tiny(), 0, mesh=mesh.Mesh(
                {axis: 2}, 0, {(axis,): mesh.Axis((axis,), 2, 0, (0, 1))}))
    elif case == "seq_len":
        for r in range(WORLD):
            assert "does not split evenly" in str(ranks[r]["refusal/seq_len"])
    elif case == "ulysses_heads":
        q = torch.zeros(1, 4, 8, 16)
        three = mesh.Axis(("seq",), 3, 0, (0, 1, 2))
        with pytest.raises(ValueError, match=r"num_heads \(4\) divisible"):
            ulysses_attention(q, q, q, three)
        with pytest.raises(ValueError, match=r"num_heads \(4\) divisible"):
            jax.shard_map(functools.partial(
                jax_ulysses.ulysses_attention, axis_name="seq"),
                mesh=jax_mesh.make_mesh({"seq": 3},
                                        devices=jax.devices()[:3]),
                in_specs=(P(None, None, "seq"),) * 3,
                out_specs=P(None, None, "seq"))(*(np.zeros((1, 4, 9, 16),
                                                           np.float32),) * 3)
    else:
        # the reference's device_put refuses the shape, and so does the
        # port's slice
        x = np.zeros((1025, 8), np.float32)
        with pytest.raises(ValueError):
            jax.device_put(x, NamedSharding(_jmesh({"model": 2, "seq": 2}),
                                            P("model")))
        two = mesh.Mesh({"model": 2}, 0, {})
        with pytest.raises(ValueError, match="divisible by the 'model'"):
            sharding_rules.shard_leaf(torch.from_numpy(x), ("model",), two)
        assert sharding_rules.shard_leaf(torch.zeros(30522, 8), ("model",),
                                         two).shape == (15261, 8)
