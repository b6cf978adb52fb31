"""What the parity files of the MoE, encoder-decoder, remat and LAMB
paths share (imported by ``tests/test_torch_moe.py``,
``test_torch_encdec.py``, ``test_torch_remat.py`` and
``test_torch_lamb_corpus.py``; conftest has set up JAX's CPU platform).

- ``fast``: a jitted reference function compiled once, with XLA's
  optimisation passes off (``FAST_COMPILE``);
- ``np_params``: a reference model's tree with every leaf redrawn from
  numpy (LayerNorm scales near 1, the rest normal x 0.1), so both
  packages start from the same float32 arrays;
- ``train_pair``: ``train_mlm`` of one family on both sides from those
  parameters, each side's parameters kept after its third train step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_tensorflow_tpu.config import Config as JaxConfig
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import mlm_loop as jax_mlm_loop
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.models import bert, convert
from mpi_tensorflow_torch.train import gspmd, mlm_loop

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# BERT_TINY's widths at two layers (the MoE's second is its expert
# layer), the chunked CE over vocabulary tiles of 256
JCFG = dataclasses.replace(jax_bert.BERT_TINY, ce_chunk=256)
TCFG = dataclasses.replace(bert.BERT_TINY, ce_chunk=256)


def fast(jitted):
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(FAST_COMPILE))
        return compiled[0](*args)
    return call


def np_params(init, seed):
    """``init(key)``'s tree with every leaf redrawn from numpy."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(init, jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def grad_tree(tree):
    if isinstance(tree, dict):
        return {k: grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [grad_tree(v) for v in tree]
    return tree.grad


def assert_trees_close(want, got, atol, rtol=0.0):
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), atol=atol, rtol=rtol), want, got)


def assert_steps_close(want, got, lr):
    """Parameters after the steps within 1e-5, every key bias (``bk``,
    the cross-attention's ``xbk``) within 3 x lr: its gradient is zero
    in exact arithmetic (the softmax ignores a per-query constant) and
    adam normalises each side's float noise."""
    want, got = jax.tree.map(np.array, want), jax.tree.map(np.array, got)
    for key in ("layers", "dec_layers"):
        for w, g in zip(want.get(key, []), got.get(key, [])):
            for name in ("bk", "xbk"):
                if name in w:
                    np.testing.assert_allclose(g.pop(name), w.pop(name),
                                               atol=3 * lr)
    assert_trees_close(want, got, atol=1e-5)


def train_pair(family, init_np, *, model: str, lr: float = 1e-3,
               jcfg=JCFG, tcfg=TCFG, seq_len: int = 16, batch: int = 4,
               train_n: int = 12, test_n: int = 8,
               lr_schedule: str = "warmup_linear", **config):
    """``train_mlm`` of ``model`` on both sides (one device, three
    steps) from ``init_np``; ``family`` is the port's class whose
    ``init_params`` is replaced.  Returns ``(want, got, want_step3,
    got_step3)``: the two results and each side's parameters after its
    third step."""
    kept = {}
    common = dict(seq_len=seq_len, train_n=train_n, test_n=test_n,
                  verbose=False, learning_rate=lr, lr_schedule=lr_schedule)

    def init_state(model_, tx, rng, mesh, **kw):
        params = jax.tree.map(jnp.asarray, init_np)
        return jax_gspmd.GspmdState(params, tx.init(params), {},
                                    jnp.zeros((), jnp.int32))

    def keeping(make, side, params_of, compile_fast):
        def wrapped(*a, **kw):
            step = make(*a, **kw)
            step = fast(step) if compile_fast else step
            seen = []

            def call(state, *rest):
                out = step(state, *rest)
                if len(rest) > 1:              # a train step
                    seen.append(1)
                    if len(seen) == 3:
                        kept[side] = params_of(out[0])
                return out
            return call
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gspmd, "make_gspmd_train_step", keeping(
            jax_gspmd.make_gspmd_train_step, "want",
            lambda st: jax.tree.map(np.asarray, st.params), True))
        mp.setattr(jax_gspmd, "make_gspmd_eval_step", keeping(
            jax_gspmd.make_gspmd_eval_step, "want_eval", None, True))
        mp.setattr(gspmd, "make_train_step", keeping(
            gspmd.make_train_step, "got",
            lambda st: convert.params_to_numpy(st.model.param_tree()),
            False))
        mp.setattr(jax_gspmd, "init_gspmd_state", init_state)
        mp.setattr(family, "init_params", classmethod(
            lambda cls, cfg, gen, *a: convert.params_from_jax(init_np)))
        kw = dict(model=model, epochs=1, batch_size=batch, log_every=2,
                  seed=1, **config)
        want = jax_mlm_loop.train_mlm(
            JaxConfig(**kw), jcfg,
            mesh=jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1]),
            **common)
        got = mlm_loop.train_mlm(Config(**kw), tcfg, device="cpu", **common)
    return want, got, kept["want"], kept["got"]
