"""The port's encoder-decoder LM (``models/encdec.py``) against the JAX
reference's ``EncDecLm``, on the CPU, at BERT_TINY's widths (one encoder
and one decoder layer), float32:

- teacher-forced logits and loss, and every gradient, with
  ``attention="dense"`` and ``"flash"`` (the flash kernels' plain
  versions on CPU tensors: the encoder's bidirectional and the decoder's
  causal self-attention; the cross-attention stays dense), from the same
  numpy-drawn parameters: logits and loss 1e-5, gradients 1e-5 absolute
  + 1e-4 relative;
- ``generate``'s greedy tokens equal the reference's, and both refuse
  ``max_new_tokens`` past the decoder's positions;
- ``train_mlm(model="encdec_t5")`` (the reversal pairs) against the
  reference's: parameters after three adamw steps within 1e-5 (each key
  bias, the cross-attention's too, within 3 x lr), the target side's
  held-out error within 1.5 points; and the pair data equal to the
  reference's bytes.

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
from mpi_tensorflow_tpu.data import synthetic as jax_synthetic
from mpi_tensorflow_tpu.models import encdec as jax_encdec
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import convert, encdec

S, B, NEW = 16, 4, 6
JCFG1, TCFG1 = (dataclasses.replace(c, layers=1) for c in (JCFG, TCFG))


def _pairs(n=B, seed=5):
    src, tgt = synthetic.seq2seq_batches(n, src_len=S, tgt_len=S,
                                         vocab_size=1024, seed=seed)
    return {"src": src, "tgt": tgt}


@pytest.fixture(scope="module")
def reference():
    jm = jax_encdec.EncDecLm(JCFG1)
    params = np_params(jm.init, 1)
    batch = _pairs()

    def f(p):
        return jm.loss(p, {}, batch, train=True)[0]

    p = jax.tree.map(jnp.asarray, params)
    loss, grads = fast(jax.jit(jax.value_and_grad(f)))(p)
    logits = fast(jax.jit(lambda p: jm.apply(p, batch)))(p)
    tokens = jm.generate(p, jnp.asarray(batch["src"]), NEW)
    return {"params": params, "loss": float(loss), "logits": np.asarray(
        logits), "grads": jax.tree.map(np.asarray, grads),
        "tokens": np.asarray(tokens), "model": jm}


def _port(params, attention="dense"):
    return encdec.EncDecLm(TCFG1, convert.params_from_jax(params), attention)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_teacher_forced_loss_and_grads_match_reference(reference, attention):
    model = _port(reference["params"], attention)
    batch = _torch(_pairs())
    seen = []
    flash = encdec.bert_lib.flash_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(encdec.bert_lib, "flash_attention",
                   lambda q, k, v, causal: seen.append(causal)
                   or flash(q, k, v, causal))
        loss = model.loss(batch, None, train=True)
        logits = model.apply(batch)
    loss.backward()
    n = TCFG1.layers
    # per loss and per apply: the encoder's layers bidirectional, then
    # the decoder's causal
    assert seen == ([False] * n + [True] * n) * 2 if attention == "flash" \
        else not seen
    assert abs(loss.item() - reference["loss"]) < 1e-5
    np.testing.assert_allclose(logits.detach().numpy(), reference["logits"],
                               atol=1e-5, rtol=0)
    got = convert.params_to_numpy(grad_tree(model.param_tree()))
    assert_trees_close(reference["grads"], got, atol=1e-5, rtol=1e-4)


def test_generate_greedy_tokens_match_reference(reference):
    model = _port(reference["params"])
    got = model.generate(torch.from_numpy(_pairs()["src"]), NEW)
    assert got.shape == (B, NEW)
    assert got.numpy().tolist() == reference["tokens"].tolist()


def test_generate_refuses_past_the_positions(reference):
    model = _port(reference["params"])
    src = _pairs()["src"]
    too_many = TCFG1.max_positions + 1
    with pytest.raises(ValueError, match="max_positions"):
        reference["model"].generate(jax.tree.map(jnp.asarray,
                                                 reference["params"]),
                                    jnp.asarray(src), too_many)
    with pytest.raises(ValueError, match="max_positions"):
        model.generate(torch.from_numpy(src), too_many)
    with pytest.raises(ValueError, match=">= 1"):
        model.generate(torch.from_numpy(src), 0)


def test_seq2seq_batches_equal_reference():
    for kw in (dict(src_len=7, tgt_len=8), dict(src_len=16, tgt_len=5)):
        got = synthetic.seq2seq_batches(9, vocab_size=50, seed=3, **kw)
        want = jax_synthetic.seq2seq_batches(9, vocab_size=50, seed=3, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    with pytest.raises(ValueError):
        synthetic.seq2seq_batches(2, src_len=4, tgt_len=6, vocab_size=9)


def test_three_steps_match_reference():
    init = np_params(jax_encdec.EncDecLm(JCFG1).init, 2)
    lr = 1e-3
    want, got, w3, g3 = train_pair(encdec.EncDecLm, init, model="encdec_t5",
                                   lr=lr, jcfg=JCFG1, tcfg=TCFG1)
    assert got.num_steps == want.num_steps == 3
    assert_steps_close(w3, g3, lr)
    assert [t for t, _ in got.history] == [t for t, _ in want.history]
    for (_, e_got), (_, e_want) in zip(got.history, want.history):
        assert abs(e_got - e_want) <= 1.5
