"""The scanned arm of the transformer family (``gspmd.make_multi_step``),
on the CPU:

- K = 3 steps of BERT_TINY's MLM (one layer) through the port's
  multi-step against the reference's ``make_gspmd_multi_step`` on a
  1-device mesh from one set of numpy-drawn parameters, adamw under
  warmup_linear (the LR and bias corrections read from the device
  tables): the three losses and the parameters within 1e-5 (the key
  bias ``bk``, whose gradient is 0 in exact arithmetic, within 3 x lr);
  the same for ``gpt_base``'s causal LM through the flash kernels'
  plain versions (``flash_min_seq`` 0);
- dropout on (0.1) and two microbatches: the multi-step equals K single
  steps fed ``step_generator``'s generators, bit for bit (the window's
  generators are seeded by the step and microbatch, as the one-step
  path's are), and the host counters advance by K.

The reference compiles with XLA's optimisation passes off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import fast
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import bert, convert, gpt
from mpi_tensorflow_torch.train import gspmd, optimizer
from mpi_tensorflow_torch.utils import tree as tree_lib

K, B, S = 3, 4, 16
LR = 1e-3
JCFG = dataclasses.replace(jax_bert.BERT_TINY, ce_chunk=256, layers=1)
TCFG = dataclasses.replace(bert.BERT_TINY, ce_chunk=256, layers=1)
FAMILIES = {"bert": (jax_bert.BertMlm, bert.BertMlm, {}),
            "gpt": (jax_gpt.CausalLm, gpt.TrainableCausalLm,
                    {"flash_min_seq": 0})}


def _np_params(jmodel, seed):
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(jmodel.init, jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def _window(n=K):
    tokens, targets, mask = synthetic.mlm_batches(n * B, seq_len=S,
                                                  vocab_size=1024, seed=6)
    return (tokens.reshape(n, B, S), mask.reshape(n, B, S),
            targets.reshape(n, B, S))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_multi_step_matches_reference(family):
    jcls, tcls, extra = FAMILIES[family]
    jmodel = jcls(JCFG)
    params = _np_params(jmodel, 2)
    tokens, mask, targets = _window()
    tx = jax_opt.transformer_tx(LR, 10)
    mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate = jax_gspmd.GspmdState(jax.tree.map(jnp.asarray, params),
                                  tx.init(params), {},
                                  jnp.zeros((), jnp.int32))
    multi = fast(jax_gspmd.make_gspmd_multi_step(jmodel, mesh, tx))
    jstate, jm = multi(jstate, {"tokens": tokens, "mask": mask}, targets,
                       jax.random.key(0))

    model = tcls(dataclasses.replace(TCFG, **extra),
                 convert.params_from_jax(params))
    ttx = optimizer.transformer_tx(LR, 10)
    state = gspmd.init_state(model, ttx)
    step = gspmd.make_multi_step(ttx)
    state, m = step(state, {"tokens": torch.from_numpy(tokens),
                            "mask": torch.from_numpy(mask)},
                    torch.from_numpy(targets))
    assert state.step == K and state.opt.count == K
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=1e-5, rtol=0)
    want = jax.tree.map(np.asarray, jstate.params)
    got = convert.params_to_numpy(model.param_tree())
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key] if hasattr(p, "key") else g[p.idx]
        tol = 3 * LR if getattr(path[-1], "key", None) == "bk" else 1e-5
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=str(path))


def test_multi_step_with_dropout_is_k_single_steps():
    cfg = dataclasses.replace(TCFG, dropout=0.1)
    tokens, mask, targets = _window()
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    labels = torch.from_numpy(targets)
    runs = []
    for multi in (False, True):
        model = bert.BertMlm.from_seed(cfg, 3)
        tx = optimizer.transformer_tx(LR, 10)
        state = gspmd.init_state(model, tx)
        if multi:
            state, m = gspmd.make_multi_step(tx, grad_accum=2, seed=9)(
                state, batch, labels)
            losses = m["loss"].tolist()
        else:
            one = gspmd.make_train_step(tx, grad_accum=2)
            losses = []
            for t in range(K):
                gens = [gspmd.step_generator(9, t, "cpu", 0, i)
                        for i in range(2)]
                state, m = one(state, {k: v[t] for k, v in batch.items()},
                               labels[t], gens)
                losses.append(m["loss"].item())
        runs.append((losses, [p.detach().clone() for p in
                              tree_lib.leaves(model.param_tree())],
                     state.step, state.opt.count))
    (l0, p0, s0, c0), (l1, p1, s1, c1) = runs
    assert l0 == l1 and (s0, c0) == (s1, c1) == (K, K)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
