"""The port's MoE BERT (``models/moe.py``) against the JAX reference's
``MoeBertMlm``, on the CPU, at BERT_TINY's widths over 4 experts:

- the loss (the MLM CE plus the load-balance loss at 0.01) and every
  gradient, top-1 and top-2, at one layer, routed
  (``every_other=False``), with ``attention="dense"`` and ``"flash"``
  (the flash kernels' plain versions on CPU tensors), from the same
  numpy-drawn parameters: loss 1e-5, gradients 1e-5 absolute + 1e-4
  relative, float32 (another library sums the products in another
  order);
- a capacity factor of 0.5, which drops tokens: the buffer slots and
  the keep masks of each choice equal the reference's exactly (read
  from the reference's own ``jnp.where`` calls), the expert MLP's output
  within 1e-5 and zero on the same rows; and the integer rules alone
  (capacity rounding, first-maximum argmax);
- ``train_mlm(model="moe_bert")`` (two layers, the second routed)
  against the reference's: parameters
  after three adamw steps within 1e-5 (each key bias within 3 x lr),
  the held-out error within 1.5 points.

The reference compiles with XLA's optimisation passes off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import (JCFG, TCFG, assert_steps_close,
                                 assert_trees_close, fast, grad_tree,
                                 np_params, train_pair)
from mpi_tensorflow_tpu.models import moe as jax_moe
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import convert, moe

S, B = 16, 4


def _models(top_k, cf=1.25, seed=1, layers=2):
    """The reference model, its numpy-drawn parameters and the port's
    MoE config; at one layer that layer is routed."""
    kw = dict(top_k=top_k, capacity_factor=cf, every_other=layers > 1)
    jm = jax_moe.MoeBertMlm(dataclasses.replace(JCFG, layers=layers),
                            moe=jax_moe.MoeConfig(**kw))
    return jm, np_params(jm.init, seed), moe.MoeConfig(**kw)


def _batch():
    tokens, targets, mask = synthetic.mlm_batches(B, seq_len=S,
                                                  vocab_size=1024, seed=5)
    return {"tokens": tokens, "mask": mask}, targets


@pytest.fixture(scope="module")
def reference():
    """The reference's loss and gradients, top-1 and top-2."""
    out = {}
    batch, labels = _batch()
    for k in (1, 2):
        jm, params, _ = _models(k, layers=1)

        def f(p):
            return jm.loss(p, {}, batch, labels, train=True)[0]

        loss, grads = fast(jax.jit(jax.value_and_grad(f)))(
            jax.tree.map(jnp.asarray, params))
        out[k] = (params, float(loss), jax.tree.map(np.asarray, grads))
    return out


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_loss_and_grads_match_reference(reference, top_k, attention):
    params, want_loss, want_grads = reference[top_k]
    batch, labels = _batch()
    model = moe.MoeBertMlm(dataclasses.replace(TCFG, layers=1),
                           convert.params_from_jax(params), attention,
                           moe=moe.MoeConfig(top_k=top_k, every_other=False))
    assert [type(layer).__name__ for layer in model.layers] == ["MoeLayer"]
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                      torch.from_numpy(labels), train=True)
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-5
    got = convert.params_to_numpy(grad_tree(model.param_tree()))
    assert_trees_close(want_grads, got, atol=1e-5, rtol=1e-4)


class _Recording:
    """``jax.numpy`` with ``where`` recording what it returns: the
    reference's MoE computes each choice's slots with ``jnp.where`` and
    nothing else there."""

    def __init__(self):
        self.wheres = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, *args):
        out = jnp.where(*args)
        self.wheres.append(np.asarray(out))
        return out


@pytest.mark.parametrize("top_k", [1, 2])
def test_dropping_capacity_slots_match_exactly(top_k):
    jm, params, mcfg = _models(top_k, cf=0.5, seed=3)
    lp = params["layers"][1]
    h = np.random.default_rng(7).normal(size=(B, S, JCFG.hidden)).astype(
        np.float32)
    rec = _Recording()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe, "jnp", rec)
        want_out, want_aux = jm._moe_mlp(jnp.asarray(h), jax.tree.map(
            jnp.asarray, lp))
    N, X = B * S, mcfg.num_experts
    C = moe.capacity(mcfg, N)
    assert C == jm.capacity(N) == 8
    layer = moe.MoeLayer(convert.params_from_jax(lp), torch.float32, mcfg)
    hf = torch.from_numpy(h).reshape(N, -1)
    gates = torch.softmax(hf @ layer.router, -1)
    routes = moe.route(gates, C, top_k)
    assert len(routes) == len(rec.wheres) == top_k
    for (slot, keep, _), want_slot in zip(routes, rec.wheres):
        assert slot.numpy().tolist() == want_slot.tolist()
        assert keep.numpy().tolist() == (want_slot != X * C).tolist()
    dropped = sum(int((~keep).sum()) for _, keep, _ in routes)
    assert dropped > 0                        # the factor does drop
    with torch.no_grad():
        out, aux = layer.mlp_block(torch.from_numpy(h), torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    assert abs(aux.item() - float(want_aux)) < 1e-6
    zero = ~np.asarray(want_out).reshape(N, -1).any(-1)
    assert zero.tolist() == (~out.detach().reshape(N, -1).numpy().any(-1)
                             ).tolist()
    assert zero.sum() > 0
    assert layer.dropped == dropped and layer.routed == N * top_k


def test_capacity_rounding_and_first_maximum():
    for n, cf, x in ((64, 1.25, 4), (7, 1.0, 4), (16384, 1.25, 4),
                     (100, 2.0, 3), (1, 0.1, 8)):
        want = jax_moe.MoeBertMlm(JCFG, moe=jax_moe.MoeConfig(
            num_experts=x, capacity_factor=cf)).capacity(n)
        assert moe.capacity(moe.MoeConfig(num_experts=x,
                                          capacity_factor=cf), n) == want
    # ties: both take the first maximum
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]],
                     np.float32)
    slot = moe.route(torch.from_numpy(gates), 8, 2)
    assert [s.tolist() for s, _, _ in slot] == [[0, 8], [9, 16]]
    assert np.asarray(jnp.argmax(gates, -1)).tolist() == [0, 1]


def test_three_steps_match_reference():
    jm, init, _ = _models(1, seed=2)
    assert [type(layer).__name__ for layer in moe.MoeBertMlm.from_seed(
        TCFG).layers] == ["EncoderLayer", "MoeLayer"]
    lr = 1e-3
    want, got, w3, g3 = train_pair(moe.MoeBertMlm, init, model="moe_bert",
                                   lr=lr)
    assert got.num_steps == want.num_steps == 3
    assert_steps_close(w3, g3, lr)
    assert [t for t, _ in got.history] == [t for t, _ in want.history]
    for (_, e_got), (_, e_want) in zip(got.history, want.history):
        assert abs(e_got - e_want) <= 1.5
