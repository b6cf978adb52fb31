"""Rematerialisation in the port (``bert.run_layer``, the ResNet's
checkpointed blocks), on the CPU:

- remat ``full`` and ``dots`` against remat off at dropout 0.1, with
  the flash kernels' plain versions: BERT_TINY's MLM, the MoE and the
  encoder-decoder, two train steps each, losses and parameters
  bit-equal, and the dropout generator left where the plain forward
  leaves it.  A rematted layer draws its masks again from its start
  state, so the recomputation draws the forward's masks;
- the flash forward runs again in each rematted layer's backward (the
  launch count ``chip_smoke.py`` holds on the card: layers x 2 a step);
- ``_dots_policy`` saves the products without batch dimensions and
  recomputes the batched ones;
- against the reference's ``remat=True`` at dropout 0 (one layer), both
  policies: loss 1e-5, gradients 1e-5 absolute + 1e-4 relative;
- ResNet-20 (8x8 inputs): one momentum step with remat against one
  without, the parameters, the loss and the BatchNorm state bit-equal:
  the recomputation's statistics are dropped, not applied twice.

The reference compiles with XLA's optimisation passes off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import (JCFG, TCFG, assert_trees_close, fast,
                                 grad_tree, np_params)
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import bert, convert, encdec, moe, resnet
from mpi_tensorflow_torch.ops import flash_attention as fa
from mpi_tensorflow_torch.train import gspmd, optimizer
from mpi_tensorflow_torch.train import step as step_lib
from mpi_tensorflow_torch.utils import tree as tree_lib

S, B = 16, 4
FAMILIES = {"bert": bert.BertMlm, "moe": moe.MoeBertMlm,
            "encdec": encdec.EncDecLm}


def _batches(family, n=2):
    if family == "encdec":
        src, tgt = synthetic.seq2seq_batches(n * B, src_len=S, tgt_len=S,
                                             vocab_size=1024, seed=4)
        return [({"src": torch.from_numpy(src[i * B:(i + 1) * B]),
                  "tgt": torch.from_numpy(tgt[i * B:(i + 1) * B])},
                 torch.from_numpy(tgt[i * B:(i + 1) * B])) for i in range(n)]
    tokens, targets, mask = synthetic.mlm_batches(n * B, seq_len=S,
                                                  vocab_size=1024, seed=4)
    return [({"tokens": torch.from_numpy(tokens[i * B:(i + 1) * B]),
              "mask": torch.from_numpy(mask[i * B:(i + 1) * B])},
             torch.from_numpy(targets[i * B:(i + 1) * B])) for i in range(n)]


def _steps(family, remat, policy="full"):
    cfg = dataclasses.replace(TCFG, dropout=0.1, remat=remat,
                              remat_policy=policy)
    model = FAMILIES[family].from_seed(cfg, 3, attention="flash")
    tx = optimizer.transformer_tx(1e-3, 10)
    state = gspmd.init_state(model, tx)
    step = gspmd.make_train_step(tx)
    losses, ends = [], []
    for t, (batch, labels) in enumerate(_batches(family)):
        gen = gspmd.step_generator(7, t, "cpu")
        losses.append(step(state, batch, labels, gen)[1]["loss"].item())
        ends.append(gen.get_state())
    return losses, tree_lib.leaves(model.param_tree()), ends


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_is_bit_equal_with_dropout(family, policy):
    want_losses, want_params, want_ends = _steps(family, False)
    losses, params, ends = _steps(family, True, policy)
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
    assert all(torch.equal(a, b) for a, b in zip(ends, want_ends))


@pytest.mark.parametrize("remat", [False, True])
def test_flash_forward_runs_again_in_the_backward(remat):
    cfg = dataclasses.replace(TCFG, remat=remat)
    model = bert.BertMlm.from_seed(cfg, 3, attention="flash")
    calls = []
    plain = fa.flash_forward_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "flash_forward_reference",
                   lambda *a, **kw: calls.append(1) or plain(*a, **kw))
        batch, labels = _batches("bert", 1)[0]
        model.loss(batch, labels, train=True).backward()
    assert len(calls) == cfg.layers * (2 if remat else 1)


def test_dots_policy_saves_the_unbatched_products():
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    save, again = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    one, many = torch.zeros(1, 4, 3), torch.zeros(6, 4, 3)
    assert bert._dots_policy(None, aten.mm.default, one[0]) == save
    assert bert._dots_policy(None, aten.addmm.default, one[0]) == save
    assert bert._dots_policy(None, aten.bmm.default, one, one) == save
    assert bert._dots_policy(None, aten.bmm.default, many, many) == again
    assert bert._dots_policy(None, aten.add.Tensor, one, one) == again


@pytest.fixture(scope="module")
def reference_params():
    return np_params(jax_bert.BertMlm(dataclasses.replace(
        JCFG, layers=1)).init, 1)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_reference(reference_params, policy):
    jcfg = dataclasses.replace(JCFG, layers=1, remat=True,
                               remat_policy=policy)
    tokens, targets, mask = synthetic.mlm_batches(B, seq_len=S,
                                                  vocab_size=1024, seed=5)
    jm = jax_bert.BertMlm(jcfg)

    def f(p):
        return jm.loss(p, {}, {"tokens": tokens, "mask": mask}, targets,
                       train=True)[0]

    want_loss, want_grads = fast(jax.jit(jax.value_and_grad(f)))(
        jax.tree.map(jnp.asarray, reference_params))
    tcfg = dataclasses.replace(TCFG, layers=1, remat=True,
                               remat_policy=policy)
    model = bert.BertMlm(tcfg, convert.params_from_jax(reference_params))
    loss = model.loss({"tokens": torch.from_numpy(tokens),
                       "mask": torch.from_numpy(mask)},
                      torch.from_numpy(targets), train=True)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < 1e-5
    assert_trees_close(jax.tree.map(np.asarray, want_grads),
                       convert.params_to_numpy(grad_tree(model.param_tree())),
                       atol=1e-5, rtol=1e-4)


def _resnet_step(remat):
    cfg = Config(model="resnet20", batch_size=B)
    model = resnet.build("resnet20", 10, seed=2, remat=remat)
    state = step_lib.init_state(model)
    step = step_lib.make_train_step(model, cfg, 1, decay_steps=100)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(B, 8, 8, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, B))
    loss = step(state, x, y, None)[1]["loss"]
    return (loss, tree_lib.leaves(model.param_tree()),
            tree_lib.leaves(state.model_state))


def test_resnet_remat_step_and_batchnorm_state_bit_equal():
    loss, params, stats = _resnet_step(True)
    want_loss, want_params, want_stats = _resnet_step(False)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
    assert len(stats) == len(want_stats) > 0
    assert all(torch.equal(a, b) for a, b in zip(stats, want_stats))
    fresh = tree_lib.leaves(resnet.build("resnet20", 10).init_state())
    assert not all(torch.equal(a, b) for a, b in zip(stats, fresh))
