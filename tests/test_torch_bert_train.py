"""The port's MLM training path against the JAX reference, on the CPU.

Integer and host logic must match exactly: the synthetic MLM bytes,
``gather_masked_rows``, the decay mask, ``ce_capacity``, the
``warmup_linear`` values in float32, the CLI's ``Config``, and the
train/eval batch windows ``train_mlm`` feeds.

Float parity at BERT_TINY, S = 32, B = 4, float32, dropout 0, with every
parameter leaf drawn from numpy (so a dropped bias or a swapped layout
shows):

- ``BertMlm.loss`` and its gradients with ``attention="dense"`` and
  ``"flash"`` (the flash kernels' plain versions on CPU tensors) against
  the reference's ``BertMlm.loss`` (dense attention off the TPU): loss to
  1e-5, gradients to 1e-5 absolute + 1e-4 relative — two layers of
  float32 matmuls summed in another order by another library;
- ``train_mlm`` (64 train, 16 held-out sequences, 16 steps, learning
  rate 1e-3) against the reference's on a one-device mesh (its GSPMD
  step) from the same initial parameters: the parameters after three
  ``transformer_tx`` steps to 1e-5 (adamw's normalised step moves each
  parameter by about the learning rate, so an error in the schedule, the
  clipping or the moments is far above it); the same history steps;
  held-out errors within 1.5 percentage points (one of the ~77 held-out
  masked positions flipping its argmax); and the last step's loss within
  1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu import cli as jax_cli
from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.data import synthetic as jax_synthetic
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.ops import mlm_head as jax_mlm_head
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import mlm_loop as jax_mlm_loop
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_torch import cli
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import bert, convert
from mpi_tensorflow_torch.ops import mlm_head
from mpi_tensorflow_torch.train import gspmd, mlm_loop, optimizer

S, B = 32, 4
JCFG = jax_bert.BERT_TINY               # float32, dropout 0
TCFG = bert.BERT_TINY


# XLA's optimisation passes take most of the reference's compile time on
# the CPU at this size; the arithmetic is the same without them
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _fast(jitted):
    """``jitted`` (a ``jax.jit`` function), compiled at its first call
    with ``FAST_COMPILE``."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(FAST_COMPILE))
        return compiled[0](*args)
    return call


def _mesh1():
    return jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])


def _np_params(seed):
    """The reference's BertMlm tree with every leaf redrawn from numpy:
    LayerNorm scales near 1, everything else normal x 0.1."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(jax_bert.BertMlm(JCFG).init, jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def _batches(n, seed):
    tokens, targets, mask = synthetic.mlm_batches(
        n * B, seq_len=S, vocab_size=TCFG.vocab_size, seed=seed)
    return [(tokens[i * B:(i + 1) * B], targets[i * B:(i + 1) * B],
             mask[i * B:(i + 1) * B]) for i in range(n)]


def _torch_batch(tokens, targets, mask):
    return ({"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}, torch.from_numpy(targets))


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def _assert_trees_close(want, got, atol, rtol=0.0):
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), atol=atol, rtol=rtol), want, got)


# ------------------------------------------------------ exact host logic

@pytest.mark.parametrize("n,seq_len,vocab,seed",
                         [(16, 32, 1024, 0), (5, 100, 30522, 3)])
def test_mlm_batches_byte_identical(n, seq_len, vocab, seed):
    want = jax_synthetic.mlm_batches(n, seq_len=seq_len, vocab_size=vocab,
                                     seed=seed)
    got = synthetic.mlm_batches(n, seq_len=seq_len, vocab_size=vocab,
                                seed=seed)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()


def test_gather_masked_rows_exact():
    rng = np.random.default_rng(4)
    h = rng.normal(size=(3, 40, 8)).astype(np.float32)
    labels = rng.integers(0, 1000, size=(3, 40)).astype(np.int32)
    mask = rng.random((3, 40)) < np.array([[0.6], [0.0], [0.15]])
    cap = 8                                   # row 0 overflows, row 1 empty
    want = _fast(jax.jit(lambda *a: jax_mlm_head.gather_masked_rows(
        *a, cap)))(jnp.asarray(h), jnp.asarray(labels), jnp.asarray(mask))
    got = mlm_head.gather_masked_rows(
        torch.from_numpy(h), torch.from_numpy(labels),
        torch.from_numpy(mask), cap)
    assert mask[0].sum() > cap and mask[1].sum() == 0
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


def test_decay_mask_matches_by_leaf():
    want = jax_opt.decay_mask(_np_params(0))
    got = optimizer.decay_mask(bert.BertMlm.from_seed(TCFG).param_tree())
    assert got == want


@pytest.mark.parametrize("frac", [0.25, 0.15, 1.0])
def test_ce_capacity_exact(frac):
    for s in (1, 7, 8, 32, 100, 512, 4096):
        want = jax_bert.ce_capacity(
            dataclasses.replace(JCFG, ce_capacity_frac=frac), s)
        got = bert.ce_capacity(
            dataclasses.replace(TCFG, ce_capacity_frac=frac), s)
        assert got == want


@pytest.mark.parametrize("base_lr,warmup,total",
                         [(1e-4, 1, 8), (3e-4, 10, 100), (1.0, 3, 7)])
def test_warmup_linear_float32_exact(base_lr, warmup, total):
    want = jax_opt.warmup_linear(base_lr, warmup, total)
    got = optimizer.warmup_linear(base_lr, warmup, total)
    for step in range(total + 3):
        w, g = np.asarray(want(step)), got(step)
        assert g.dtype == np.float32 and w.tobytes() == g.tobytes(), step


@pytest.mark.parametrize("argv", [
    [],
    ["--model", "bert_base", "--dataset", "mlm_synthetic", "--epochs", "1",
     "--batch-size", "4", "--seed", "3", "--log-every", "7",
     "--precision", "bf16", "--optimizer", "adamw"],
])
def test_cli_config_field_by_field(argv):
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("seq_len,want", [(32, 128), (128, 128),
                                          (4096, 4096)])
def test_cli_seq_len_raises_max_positions(monkeypatch, seq_len, want):
    """A ``--seq-len`` past the geometry's positions reaches ``train_mlm``
    with ``max_positions`` raised to it, so the CLI can run the lengths
    where the card takes the flash kernels."""
    from mpi_tensorflow_torch.train import mlm_loop

    seen = []
    monkeypatch.setattr(mlm_loop, "train_mlm",
                        lambda config, bert_cfg, **kw: seen.append(
                            (bert_cfg, kw["seq_len"])))
    assert cli.main(["--model", "bert_base", "--dataset", "mlm_synthetic",
                     "--device", "cpu", "--tiny", "--seq-len",
                     str(seq_len)]) == 0
    (cfg, got_len), = seen
    assert got_len == seq_len and cfg.max_positions == want
    assert cfg.hidden == bert.BERT_TINY.hidden


def test_config_defaults_and_unported_values():
    want, got = JaxConfig(), Config()
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    # remat, lamb and the text corpus are ported: they construct
    for kw in ({"remat": True}, {"optimizer": "lamb"},
               {"text_file": "x.txt", "vocab_file": "v.txt"}):
        assert all(getattr(Config(**kw), k) == v for k, v in kw.items())
    # grad_accum and zero1/fsdp are ported: what raises now is a value
    # the reference's CLI refuses too
    for kw, what in (({"grad_accum": 0}, "grad_accum"),
                     ({"param_sharding": "zero3"}, "param_sharding")):
        with pytest.raises(ValueError, match=what):
            Config(**kw)
    assert Config(grad_accum=2, param_sharding="fsdp").grad_accum == 2
    # the model and seq axes are ported (tests/test_torch_tp_sp.py); the
    # pipe axis still raises, naming its item (14d)
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(["--device", "cpu", "--model", "bert_base", "--mesh",
                  "data=1,pipe=2"])


# ------------------------------------------------------- float parity

@pytest.fixture(scope="module")
def params_np():
    return _np_params(1)


@pytest.fixture(scope="module")
def jax_loss_and_grads(params_np):
    """The reference's loss, its gradients and the eval logits of
    ``apply`` on one batch, under one compile."""
    model = jax_bert.BertMlm(JCFG)
    tokens, targets, mask = _batches(1, 5)[0]

    def f(p):
        return model.loss(p, {}, {"tokens": tokens, "mask": mask}, targets,
                          train=True)[0]

    def run(p):
        return jax.value_and_grad(f)(p), model.apply(p, tokens)

    (loss, grads), logits = _fast(jax.jit(run))(
        jax.tree.map(jnp.asarray, params_np))
    return float(loss), jax.tree.map(np.asarray, grads), np.asarray(logits)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_loss_and_grads_match_reference(params_np, jax_loss_and_grads,
                                        attention):
    want_loss, want_grads, _ = jax_loss_and_grads
    model = bert.BertMlm(TCFG, convert.params_from_jax(params_np),
                         attention)
    batch, labels = _torch_batch(*_batches(1, 5)[0])
    loss = model.loss(batch, labels, train=True)
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-5
    got = convert.params_to_numpy(_grad_tree(model.param_tree()))
    _assert_trees_close(want_grads, got, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("attention,want", [("auto", "dense"),
                                            ("flash", "flash"),
                                            ("dense", "dense")])
def test_attention_choice_on_the_cpu(monkeypatch, attention, want):
    """``auto`` stays dense for CPU tensors even at S >= flash_min_seq
    (the reference is dense off the TPU); ``flash``/``dense`` force one
    side."""
    ran = []
    monkeypatch.setattr(bert, "flash_attention",
                        lambda q, k, v, causal: ran.append(
                            ("flash", causal)) or q)
    monkeypatch.setattr(bert, "dense_attention",
                        lambda q, k, v, causal: ran.append(
                            ("dense", causal)) or q)
    cfg = dataclasses.replace(TCFG, flash_min_seq=4)
    model = bert.BertMlm.from_seed(cfg, 0, attention)
    model.encode(torch.zeros((1, 8), dtype=torch.int32))
    assert ran == [(want, False)] * cfg.layers
    # the chunked CE is ported (ROADMAP item 13): a model builds with it
    assert bert.BertMlm.from_seed(dataclasses.replace(
        cfg, ce_impl="chunked"), 0, attention)._use_chunked_ce()


def test_eval_step_logits_match_reference(params_np, jax_loss_and_grads):
    """``eval_step`` (``BertMlm.apply`` in eval mode): float32 logits
    (B, S, V) to 1e-5."""
    model = bert.BertMlm(TCFG, convert.params_from_jax(params_np))
    state = gspmd.TrainState(model, None)
    tokens = torch.from_numpy(_batches(1, 5)[0][0])
    got = gspmd.make_eval_step()(state, tokens)
    assert got.dtype == torch.float32 and got.shape == (B, S, 1024)
    np.testing.assert_allclose(got.numpy(), jax_loss_and_grads[2],
                               atol=1e-5, rtol=0)


def test_trace_lines_match_reference(capsys):
    from mpi_tensorflow_tpu.utils import logging as jax_logs
    from mpi_tensorflow_torch.utils import logging as logs

    lines = []
    for mod in (jax_logs, logs):
        mod.session_start(0)
        mod.step_trace(0, 50, 12.345)
        mod.timing_summary(12345.6, 78.9, 1)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]


@pytest.mark.parametrize("cfg", ["base", "tiny", "base-all"])
def test_model_flops_match_reference(cfg):
    from mpi_tensorflow_tpu.utils import flops as jax_flops
    from mpi_tensorflow_torch.utils import flops

    jcfg, tcfg = {"base": (jax_bert.BERT_BASE, bert.BERT_BASE),
                  "tiny": (JCFG, TCFG)}.get(cfg, (
                      dataclasses.replace(jax_bert.BERT_BASE,
                                          ce_positions="all"),
                      dataclasses.replace(bert.BERT_BASE,
                                          ce_positions="all")))
    for b, s in ((4, 4096), (64, 128)):
        assert flops.transformer_train_flops(tcfg, b, s) == \
            jax_flops.transformer_train_flops(jcfg, b, s)


@pytest.fixture(scope="module")
def train_runs():
    """``train_mlm`` on both sides from one set of numpy-drawn initial
    parameters, recording each side's train and eval inputs and
    its parameters after the third step.  The learning rate is 1e-3, so
    adamw's steps move the parameters well past the tolerances."""
    seed, lr = 1, 1e-3
    common = dict(seq_len=S, train_n=64, test_n=16, verbose=False,
                  learning_rate=lr)
    init_np = _np_params(2)

    def init_state(model, tx, rng, mesh, **kw):
        # the reference's state on a one-device mesh (nothing to shard),
        # from the numpy parameters instead of model.init(rng); the port
        # draws them in place of bert.init_params below
        params = jax.tree.map(jnp.asarray, init_np)
        return jax_gspmd.GspmdState(params, tx.init(params), {},
                                    jnp.zeros((), jnp.int32))

    def recorder(make, rec, params_of, fast):
        """``make``'s step, recording the token rows it is fed and the
        parameters after its third train step."""
        def wrapped_make(*a, **kw):
            step = make(*a, **kw)
            step = _fast(step) if fast else step

            def call(state, batch, *rest):
                train = len(rest) > 0
                tok = batch["tokens"] if train else batch
                rec["rows"].append((train, np.asarray(tok).copy()))
                out = step(state, batch, *rest)
                if train and sum(t for t, _ in rec["rows"]) == 3:
                    rec["step3"] = params_of(out[0])
                if train:
                    rec["loss"] = float(out[1]["loss"])
                return out
            return call
        return wrapped_make

    jrec = {"rows": []}
    rec = {"rows": []}
    jparams = lambda st: jax.tree.map(np.asarray, st.params)
    params = lambda st: convert.params_to_numpy(st.model.param_tree())
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, r, p, fast in (
                (jax_gspmd, "make_gspmd_train_step", jrec, jparams, True),
                (jax_gspmd, "make_gspmd_eval_step", jrec, jparams, True),
                (gspmd, "make_train_step", rec, params, False),
                (gspmd, "make_eval_step", rec, params, False)):
            mp.setattr(mod, name, recorder(getattr(mod, name), r, p, fast))
        mp.setattr(jax_gspmd, "init_gspmd_state", init_state)
        mp.setattr(bert, "init_params",
                   lambda cfg, gen: convert.params_from_jax(init_np))
        want = jax_mlm_loop.train_mlm(
            JaxConfig(model="bert_base", epochs=1, batch_size=B,
                      log_every=4, seed=seed), JCFG, mesh=_mesh1(),
            **common)
        got = mlm_loop.train_mlm(
            Config(model="bert_base", epochs=1, batch_size=B, log_every=4,
                   seed=seed), TCFG, device="cpu", **common)
    return {"lr": lr, "want": want, "got": got, "jrec": jrec, "rec": rec}


def test_three_adamw_steps_match_reference(train_runs):
    """Parameters after three ``transformer_tx`` steps (clipping, the
    warmup schedule's LR 0 at step 0, adamw moments and decay)."""
    lr = train_runs["lr"]
    want, got = train_runs["jrec"]["step3"], train_runs["rec"]["step3"]
    # bk's gradient is zero in exact arithmetic (the softmax ignores a
    # per-query constant), so each side's adamw step normalises its own
    # float noise: hold it only to the steps' reach, 3 x lr
    for w, g in zip(want["layers"], got["layers"]):
        np.testing.assert_allclose(g.pop("bk"), w.pop("bk"), atol=3 * lr)
    _assert_trees_close(want, got, atol=1e-5)


def test_train_mlm_feeds_the_same_windows(train_runs):
    """The wraparound train windows and the capped eval windows, in the
    same order, byte for byte."""
    rows, jrows = train_runs["rec"]["rows"], train_runs["jrec"]["rows"]
    assert [t for t, _ in rows] == [t for t, _ in jrows]
    assert sum(t for t, _ in rows) == 16 and len(rows) == 16 + 4 * 4
    for (_, g), (_, w) in zip(rows, jrows):
        assert g.tobytes() == w.tobytes()


def test_train_mlm_history_and_loss_match(train_runs):
    want, got = train_runs["want"], train_runs["got"]
    assert got.num_steps == want.num_steps == 16
    assert [t for t, _ in got.history] == [t for t, _ in want.history] \
        == [4, 8, 12, 15]
    for (_, e_got), (_, e_want) in zip(got.history, want.history):
        assert abs(e_got - e_want) <= 1.5
    assert got.final_loss == train_runs["rec"]["loss"]
    assert abs(got.final_loss - train_runs["jrec"]["loss"]) < 1e-4
