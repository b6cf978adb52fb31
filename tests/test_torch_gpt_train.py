"""The port's causal-LM training (``gpt_base``) against the JAX
reference, on the CPU.

- ``ops/mlm_head.tied_softmax_ce``: values and the gradients of t, the
  tied matrix and the output bias, at a vocabulary that is not a
  multiple of the tile (1000 over tiles of 256), within 1e-5 absolute;
- ``TrainableCausalLm.loss`` and its gradients with
  ``attention="dense"`` and ``"flash"`` (the flash kernels' plain
  versions on CPU tensors, causal) against the reference's
  ``CausalLm.loss`` (causal dense attention off the TPU, the chunked CE
  over tiles of 256), BERT_TINY at one layer: loss 1e-5, gradients
  1e-5 absolute + 1e-4 relative — float32 matmuls summed in another
  order by another library;
- ``train_mlm`` with ``model="gpt_base"`` (the same geometry, S 16,
  batch 4, learning rate 1e-3) against the reference's on a one-device
  mesh from the same numpy-drawn parameters: the parameters after three
  adamw steps within 1e-5 (the key bias within 3 x lr, as the MLM test
  holds it); the same train and eval windows; the causal held-out error
  within 1.5 points (one of the 45 next-token predictions flipping).
  With ``grad_accum`` 2 the port is held to the same reference run: the
  causal loss's microbatches carry equal counts of supervised positions
  (2 rows x 15), so the mean of their means is the batch's mean and the
  reference's two-microbatch step is its one-microbatch step up to
  float rounding (within 1e-5 after three steps);
- the trained state feeds ``generate``: its greedy tokens are the
  argmax of the reference's logits, from the reference's trained
  parameters, at every position they were drawn from (teacher forced);
  and the paged engine serves the same tokens.

The reference compiles with XLA's optimisation passes off.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.ops import mlm_head as jax_mlm_head
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import mlm_loop as jax_mlm_loop
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import bert, convert, gpt
from mpi_tensorflow_torch.ops import mlm_head
from mpi_tensorflow_torch.serving import engine
from mpi_tensorflow_torch.train import gspmd, mlm_loop

S, B = 16, 4
# BERT_TINY at one layer (the compiles scale with the depth), the CE
# over vocabulary tiles of 256
JCFG = dataclasses.replace(jax_bert.BERT_TINY, ce_chunk=256, layers=1)
TCFG = dataclasses.replace(bert.BERT_TINY, ce_chunk=256, layers=1)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _fast(jitted):
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(FAST_COMPILE))
        return compiled[0](*args)
    return call


def _np_params(cfg, seed):
    """The reference's tree with every leaf redrawn from numpy:
    LayerNorm scales near 1, everything else normal x 0.1."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(jax_gpt.CausalLm(cfg).init, jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def _assert_trees_close(want, got, atol, rtol=0.0):
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), atol=atol, rtol=rtol), want, got)


# ------------------------------------------------------ the chunked CE

def test_tied_softmax_ce_matches_reference():
    rng = np.random.default_rng(0)
    V, E = 1000, 16
    t = rng.normal(size=(2, 3, E)).astype(np.float32)
    emb = (0.3 * rng.normal(size=(V, E))).astype(np.float32)
    out_b = (0.1 * rng.normal(size=V)).astype(np.float32)
    labels = rng.integers(0, V, (2, 3)).astype(np.int32)
    w = rng.uniform(size=(2, 3)).astype(np.float32)

    def f(t, emb, out_b):
        ce = jax_mlm_head.tied_softmax_ce(t, emb, out_b, labels, chunk=256)
        return jnp.sum(ce * w), ce

    (_, want_ce), want_g = _fast(jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)))(t, emb, out_b)
    tt, te, tb = (torch.tensor(x, requires_grad=True) for x in (t, emb,
                                                                out_b))
    ce = mlm_head.tied_softmax_ce(tt, te, tb, torch.from_numpy(labels),
                                  chunk=256)
    (ce * torch.from_numpy(w)).sum().backward()
    assert ce.dtype == torch.float32 and ce.shape == (2, 3)
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(want_ce),
                               atol=1e-5, rtol=0)
    for got, want in zip((tt.grad, te.grad, tb.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_ce_route_rule():
    """``auto`` is chunked when every position reaches the head (the
    causal family, or ``ce_positions="all"``), dense under packing."""
    causal = gpt.TrainableCausalLm.from_seed(TCFG, 0)
    assert causal._use_chunked_ce() and not causal._packs_positions()
    assert not bert.BertMlm.from_seed(TCFG, 0)._use_chunked_ce()
    assert bert.BertMlm.from_seed(dataclasses.replace(
        TCFG, ce_positions="all"), 0)._use_chunked_ce()
    assert not gpt.TrainableCausalLm.from_seed(dataclasses.replace(
        TCFG, ce_impl="dense"), 0)._use_chunked_ce()
    targets, w = gpt.shift_targets(torch.tensor([[5, 6, 7], [8, 9, 1]]))
    jt, jw = jax_gpt._shift_targets(jnp.array([[5, 6, 7], [8, 9, 1]]))
    assert targets.tolist() == np.asarray(jt).tolist()
    assert w.tolist() == np.asarray(jw).tolist()


# ------------------------------------------------- the causal loss

@pytest.fixture(scope="module")
def params_np():
    return _np_params(JCFG, 1)


@pytest.fixture(scope="module")
def jax_loss_and_grads(params_np):
    tokens = synthetic.mlm_batches(B, seq_len=S, vocab_size=1024,
                                   seed=5)[0]
    model = jax_gpt.CausalLm(JCFG)

    def f(p):
        return model.loss(p, {}, {"tokens": tokens}, train=True)[0]

    loss, grads = _fast(jax.jit(jax.value_and_grad(f)))(
        jax.tree.map(jnp.asarray, params_np))
    return tokens, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_causal_loss_and_grads_match_reference(params_np,
                                               jax_loss_and_grads,
                                               attention):
    tokens, want_loss, want_grads = jax_loss_and_grads
    model = gpt.TrainableCausalLm(TCFG, convert.params_from_jax(params_np),
                                  attention)
    seen = []
    flash = gpt.bert_lib.flash_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpt.bert_lib, "flash_attention",
                   lambda q, k, v, causal: seen.append(causal)
                   or flash(q, k, v, causal))
        loss = model.loss({"tokens": torch.from_numpy(tokens)}, None,
                          train=True)
    loss.backward()
    assert seen == ([True] * TCFG.layers if attention == "flash" else [])
    assert abs(loss.item() - want_loss) < 1e-5
    got = convert.params_to_numpy(_grad_tree(model.param_tree()))
    _assert_trees_close(want_grads, got, atol=1e-5, rtol=1e-4)


# ------------------------------------------------------- train_mlm

@pytest.fixture(scope="module")
def train_runs():
    """``train_mlm(model="gpt_base")`` on both sides, one microbatch and
    two, from one set of numpy-drawn parameters; each run records its
    train/eval inputs and its parameters after the third step."""
    lr = 1e-3
    jcfg, tcfg = JCFG, TCFG
    init_np = _np_params(jcfg, 2)
    common = dict(seq_len=S, train_n=12, test_n=15, verbose=False,
                  learning_rate=lr)
    evals = []

    def init_state(model, tx, rng, mesh, **kw):
        params = jax.tree.map(jnp.asarray, init_np)
        return jax_gspmd.GspmdState(params, tx.init(params), {},
                                    jnp.zeros((), jnp.int32))

    def recorder(make, rec, params_of, fast, shared=None):
        def wrapped_make(*a, **kw):
            if shared is not None and shared:
                step = shared[0]
            else:
                step = make(*a, **kw)
                step = _fast(step) if fast else step
                if shared is not None:
                    shared.append(step)

            def call(state, batch, *rest):
                train = len(rest) > 0
                tok = batch["tokens"] if train else batch
                rec["rows"].append((train, np.asarray(tok).copy()))
                out = step(state, batch, *rest)
                if train and sum(t for t, _ in rec["rows"]) == 3:
                    rec["step3"] = params_of(out[0])
                return out
            return call
        return wrapped_make

    out = {"lr": lr, "evals": evals}
    jparams = lambda st: jax.tree.map(np.asarray, st.params)
    params = lambda st: convert.params_to_numpy(st.model.param_tree())
    for accum in (1, 2):
        jrec, rec = {"rows": []}, {"rows": []}
        if accum == 2:
            # the reference's one-microbatch run stands for its own
            # two-microbatch run (module note)
            jrec, want = out[1]["jrec"], out[1]["want"]
        with pytest.MonkeyPatch.context() as mp:
            for mod, name, r, p, fast, shared in (
                    (jax_gspmd, "make_gspmd_train_step", jrec, jparams,
                     True, None),
                    (jax_gspmd, "make_gspmd_eval_step", jrec, jparams, True,
                     evals),
                    (gspmd, "make_train_step", rec, params, False, None),
                    (gspmd, "make_eval_step", rec, params, False, None)):
                mp.setattr(mod, name, recorder(getattr(mod, name), r, p,
                                               fast, shared))
            mp.setattr(jax_gspmd, "init_gspmd_state", init_state)
            mp.setattr(bert, "init_params",
                       lambda cfg, gen: convert.params_from_jax(init_np))
            kw = dict(model="gpt_base", epochs=1, batch_size=B,
                      log_every=2, seed=1, grad_accum=accum)
            if accum == 1:
                want = jax_mlm_loop.train_mlm(
                    JaxConfig(**kw), jcfg,
                    mesh=jax_mesh.make_mesh({"data": 1},
                                            devices=jax.devices()[:1]),
                    **common)
            got = mlm_loop.train_mlm(Config(**kw), tcfg, device="cpu",
                                     **common)
        out[accum] = {"want": want, "got": got, "jrec": jrec, "rec": rec}
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_reference(train_runs, accum):
    lr, run = train_runs["lr"], train_runs[accum]
    want, got = (copy.deepcopy(run["jrec"]["step3"]),
                 copy.deepcopy(run["rec"]["step3"]))
    assert run["got"].num_steps == run["want"].num_steps == 3
    for w, g in zip(want["layers"], got["layers"]):
        np.testing.assert_allclose(g.pop("bk"), w.pop("bk"), atol=3 * lr)
    _assert_trees_close(want, got, atol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_windows_and_causal_error_match_reference(train_runs, accum):
    run = train_runs[accum]
    rows, jrows = run["rec"]["rows"], run["jrec"]["rows"]
    assert [t for t, _ in rows] == [t for t, _ in jrows]
    for (_, g), (_, w) in zip(rows, jrows):
        assert g.tobytes() == w.tobytes()
    want, got = run["want"], run["got"]
    assert [t for t, _ in got.history] == [t for t, _ in want.history] \
        == [2]
    for (_, e_got), (_, e_want) in zip(got.history, want.history):
        assert abs(e_got - e_want) <= 1.5


def test_trained_state_feeds_generate_and_the_engine(train_runs):
    run = train_runs[1]
    prompt = np.random.default_rng(3).integers(0, 1024, (B, 6)).astype(
        np.int32)
    lm = run["got"].state.model.serving()
    assert isinstance(lm, gpt.CausalLm)
    got = lm.generate(torch.from_numpy(prompt).long(), S - 6).numpy()
    # the reference's eval forward (compiled in the loop) on the same
    # sequences: each generated token is the argmax of its position
    logits = np.asarray(train_runs["evals"][0](run["want"].state,
                                               got.astype(np.int32)))
    assert got[:, 6:].tolist() == logits[:, 5:-1].argmax(-1).tolist()
    eng = engine.PagedDecodeEngine(lm, engine.ServeConfig(
        num_blocks=9, block_size=4, max_slots=B, max_seq_len=16),
        device="cpu")
    res = eng.run([engine.sched_lib.Request(i, prompt[i].tolist(), S - 6)
                   for i in range(B)])
    assert [res["outputs"][i] for i in range(B)] == got[:, 6:].tolist()


def test_model_flops_count_every_position():
    from mpi_tensorflow_tpu.utils import flops as jax_flops
    from mpi_tensorflow_torch.utils import flops

    for b, s in ((4, 4096), (8, 128)):
        assert flops.transformer_train_flops(bert.BERT_BASE, b, s, s) == \
            jax_flops.transformer_train_flops(jax_bert.BERT_BASE, b, s,
                                              head_positions=s)
