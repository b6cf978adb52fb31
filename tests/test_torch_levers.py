"""The reference bench's transformer levers in the port, against the JAX
reference, on the CPU, at BERT_TINY's widths (one layer, S = 16, B = 4,
float32 unless stated, dropout 0, parameters drawn from numpy):

- ``fused_qkv``: each family's loss and gradients (``bert_base``,
  ``moe_bert`` with its layer routed, ``gpt_base``, ``encdec_t5`` at one
  layer a stack) against the reference's with ``fused_qkv`` on,
  loss 1e-5, gradients 1e-5 absolute + 1e-4 relative (another library
  sums the products in another order); and the port's fused path
  against its own three products within ``SELF_TOL``, loss and every
  gradient;
- ``param_dtype=torch.bfloat16`` (``--params-bf16``): three
  ``make_train_step`` steps of BERT_TINY in bf16 from
  ``gspmd.init_state(param_dtype=)`` against the reference's
  ``init_gspmd_state(param_dtype=jnp.bfloat16)`` and
  ``make_gspmd_train_step`` under the same ``transformer_tx`` (constant
  lr): the masters float32 and the live parameters bfloat16, the live
  parameters equal to the masters cast to bf16 after every step, the
  losses within ``BF16_LOSS_TOL`` (relative), and the masters, leaf by
  leaf, held to the reference's: every element moved where the
  reference's moved, and each leaf's median difference within a tenth
  of its median move (measured at most 0.0045 of it) but ``bk``'s, whose
  gradient is zero in exact arithmetic, so each package's adam follows
  its own float noise: its elements may part by 2 x lr a step,
  ``BF16_BK_TOL`` (measured 5.3e-3); 99 % of all elements within
  ``BF16_MASTER_Q99`` (a bf16 gradient near zero may point the other
  way in the other package, so a few elements part by ~lr a step);
- the bench's refusals: every ``ap.error`` of the reference's bench for
  ``--fused-qkv``, ``--flash-min-seq`` and ``--params-bf16`` is raised by
  the port's for the same arguments, the reference's bench beside it,
  and the port's own refusal of ``--params-bf16`` beside a sharded
  layout; the bench's line carries the reference's lever keys.

The reference compiles with XLA's optimisation passes off.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from _torch_family_cases import (JCFG, TCFG, assert_trees_close, fast,
                                 grad_tree, np_params)
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import encdec as jax_encdec
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.models import moe as jax_moe
from mpi_tensorflow_tpu.parallel import mesh as jax_mesh
from mpi_tensorflow_tpu.train import gspmd as jax_gspmd
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_torch import bench
from mpi_tensorflow_torch.data import synthetic
from mpi_tensorflow_torch.models import bert, convert, encdec, gpt, moe
from mpi_tensorflow_torch.train import gspmd
from mpi_tensorflow_torch.train import optimizer as opt_lib
from mpi_tensorflow_torch.train.optimizer import MasterOpt
from mpi_tensorflow_torch.utils import tree as tree_lib

S, B = 16, 4
# the fused product against the port's three: one (E, 3HD) product and
# three (E, HD) ones sum the same E terms of each output
SELF_TOL = 1e-6
LR, STEPS = 1e-3, 3
BF16_LOSS_TOL = 2 ** -7
BF16_BK_TOL = 2 * LR * STEPS
BF16_MASTER_Q99 = LR / 4        # measured 9.7e-5

# family: its reference model and the port's, each at one layer (the
# MoE's routed; the enc-dec's one a stack)
ROUTED = dict(every_other=False)
FAMILIES = {
    "bert_base": (jax_bert.BertMlm, bert.BertMlm),
    "moe_bert": (lambda c: jax_moe.MoeBertMlm(
        c, moe=jax_moe.MoeConfig(**ROUTED)), lambda c, p: moe.MoeBertMlm(
            c, p, moe=moe.MoeConfig(**ROUTED))),
    "gpt_base": (jax_gpt.CausalLm, gpt.TrainableCausalLm),
    "encdec_t5": (jax_encdec.EncDecLm, encdec.EncDecLm),
}


def _batch(family):
    if family == "encdec_t5":
        src, tgt = synthetic.seq2seq_batches(B, src_len=S, tgt_len=S,
                                             vocab_size=1024, seed=5)
        return {"src": src, "tgt": tgt}, tgt
    tokens, targets, mask = synthetic.mlm_batches(B, seq_len=S,
                                                  vocab_size=1024, seed=5)
    if family == "gpt_base":
        return {"tokens": tokens}, None
    return {"tokens": tokens, "mask": mask}, targets


def _reference_loss(family, jcfg, params):
    jm = FAMILIES[family][0](jcfg)
    batch, labels = _batch(family)

    def f(p):
        if labels is None or family == "encdec_t5":
            return jm.loss(p, {}, batch, train=True)[0]
        return jm.loss(p, {}, batch, labels, train=True)[0]

    loss, grads = fast(jax.jit(jax.value_and_grad(f)))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss(family, tcfg, params):
    model = FAMILIES[family][1](tcfg, convert.params_from_jax(params))
    batch, labels = _batch(family)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                      None if labels is None else torch.from_numpy(labels),
                      train=True)
    loss.backward()
    return loss.item(), convert.params_to_numpy(grad_tree(
        model.param_tree()))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fused_qkv_matches_reference_and_unfused(family):
    jcfg = dataclasses.replace(JCFG, layers=1, fused_qkv=True)
    tcfg = dataclasses.replace(TCFG, layers=1, fused_qkv=True)
    params = np_params(FAMILIES[family][0](jcfg).init, 1)
    want_loss, want_grads = _reference_loss(family, jcfg, params)
    seen = []
    einsum = torch.einsum
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "einsum", lambda eq, *a: seen.append(eq)
                   or einsum(eq, *a))
        loss, grads = _port_loss(family, tcfg, params)
    # every layer's q, k, v from the one stacked product
    assert seen.count("bse,cehd->cbhsd") == (
        2 if family == "encdec_t5" else 1)
    assert "bse,ehd->bhsd" not in seen or family == "encdec_t5"
    assert abs(loss - want_loss) < 1e-5
    assert_trees_close(want_grads, grads, atol=1e-5, rtol=1e-4)
    plain_loss, plain_grads = _port_loss(
        family, dataclasses.replace(tcfg, fused_qkv=False), params)
    assert abs(loss - plain_loss) < SELF_TOL
    assert_trees_close(plain_grads, grads, atol=SELF_TOL)


def test_params_bf16_steps_match_reference():
    jcfg = dataclasses.replace(JCFG, layers=1, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TCFG, layers=1, dtype=torch.bfloat16)
    params = np_params(jax_bert.BertMlm(jcfg).init, 2)
    tokens, targets, mask = synthetic.mlm_batches(STEPS * B, seq_len=S,
                                                  vocab_size=1024, seed=6)
    rows = [slice(t * B, (t + 1) * B) for t in range(STEPS)]

    jtx = jax_opt.transformer_tx(LR, STEPS, schedule="constant")
    mesh = jax_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bert.BertMlm, "init", lambda self, rng: jax.tree.map(
            jnp.asarray, params))
        jstate = jax_gspmd.init_gspmd_state(
            jax_bert.BertMlm(jcfg), jtx, jax.random.key(0), mesh,
            param_dtype=jnp.bfloat16)
    jstep = fast(jax_gspmd.make_gspmd_train_step(jax_bert.BertMlm(jcfg),
                                                 mesh, jtx))
    want_losses = []
    for r in rows:
        jstate, m = jstep(jstate, {"tokens": tokens[r], "mask": mask[r]},
                          targets[r], jax.random.key(1))
        want_losses.append(float(m["loss"]))
    assert isinstance(jstate.opt, jax_gspmd.MasterOpt)

    model = bert.BertMlm(tcfg, convert.params_from_jax(params))
    tx = opt_lib.transformer_tx(LR, STEPS, schedule="constant")
    state = gspmd.init_state(model, tx, param_dtype=torch.bfloat16)
    assert isinstance(state.opt, MasterOpt)
    train_step = gspmd.make_train_step(tx)
    leaves = tree_lib.leaves(model.param_tree())
    losses = []
    for r in rows:
        state, m = train_step(state, {"tokens": torch.from_numpy(tokens[r]),
                                      "mask": torch.from_numpy(mask[r])},
                              torch.from_numpy(targets[r]))
        losses.append(float(m["loss"]))
        for p, master in zip(leaves, state.opt.master):
            assert p.dtype == torch.bfloat16
            assert master.dtype == torch.float32
            assert torch.equal(p, master.to(torch.bfloat16))
    np.testing.assert_allclose(losses, want_losses, rtol=BF16_LOSS_TOL)
    masters = convert.params_to_numpy(tree_lib.unflatten(
        model.param_tree(), state.opt.master))
    diffs = []
    for (path, want), got, start in zip(
            jax.tree_util.tree_flatten_with_path(jstate.opt.master)[0],
            jax.tree.leaves(masters), jax.tree.leaves(params)):
        name = jax.tree_util.keystr(path)
        want, start = np.asarray(want), np.asarray(start)
        assert got.shape == want.shape, name
        d = np.abs(got - want)
        moved = np.abs(want - start)
        np.testing.assert_array_equal(got != start, want != start, name)
        if name.endswith("['bk']"):
            assert d.max() <= BF16_BK_TOL, name
        else:
            assert np.median(d) < 0.1 * np.median(moved), name
        diffs.append(d.ravel())
    assert np.quantile(np.concatenate(diffs), 0.99) < BF16_MASTER_Q99
    rest = gspmd.bytes_at_rest(state)
    assert rest["masters"] == rest["replica_params"] == 2 * rest["params"]


# the reference's bench refusals, each with its argument list
REFUSED = {
    "fused_qkv_image": ["--mode", "train", "--model", "mnist_cnn",
                        "--fused-qkv"],
    "fused_qkv_allreduce": ["--mode", "allreduce", "--model", "bert_base",
                            "--fused-qkv"],
    "flash_min_seq_image": ["--mode", "train", "--model", "resnet20",
                            "--flash-min-seq", "0"],
    "flash_min_seq_allreduce": ["--mode", "allreduce", "--flash-min-seq",
                                "0"],
    "params_bf16_fp32": ["--mode", "train", "--model", "bert_base",
                         "--params-bf16"],
    "params_bf16_image": ["--mode", "train", "--model", "vit",
                          "--precision", "bf16", "--params-bf16"],
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_bench_refuses_as_the_reference(case, capsys, monkeypatch):
    # the reference's accelerator probe: nothing to probe on the CPU
    monkeypatch.setattr(jax_bench, "_backend_reachable", lambda *a: True)
    argv = REFUSED[case] + ["--device", "cpu"]
    with pytest.raises(SystemExit):
        bench.main(argv)
    port_err = capsys.readouterr().err
    with pytest.raises(SystemExit):
        jax_bench.main(REFUSED[case])
    ref_err = capsys.readouterr().err
    flag = next(a for a in REFUSED[case] if a in (
        "--fused-qkv", "--flash-min-seq", "--params-bf16"))
    assert flag in port_err and flag in ref_err


def test_bench_refuses_params_bf16_beside_sharding(capsys):
    for layout in ("zero1", "fsdp"):
        with pytest.raises(SystemExit):
            bench.main(["--mode", "train", "--model", "bert_base",
                        "--precision", "bf16", "--params-bf16",
                        "--param-sharding", layout, "--device", "cpu"])
        assert f"--param-sharding {layout}" in capsys.readouterr().err
    with pytest.raises(ValueError, match="masters"):
        gspmd.init_for("zero1", bert.BertMlm.from_seed(TCFG), None,
                       torch.bfloat16)


def test_bench_line_carries_the_levers(capsys, monkeypatch):
    monkeypatch.setattr(bert, "BERT_BASE", TCFG)
    assert bench.main(["--mode", "train", "--model", "bert_base",
                       "--device", "cpu", "--seq-len", "16",
                       "--batch-size", "2", "--steps", "1", "--warmup", "1",
                       "--precision", "bf16", "--params-bf16", "--fused-qkv",
                       "--ce", "chunked", "--ce-chunk", "256",
                       "--flash-min-seq", "0"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert {k: line[k] for k in ("ce_impl", "ce_chunk", "params_bf16",
                                 "fused_qkv", "flash_min_seq")} == {
        "ce_impl": "chunked", "ce_chunk": 256, "params_bf16": True,
        "fused_qkv": True, "flash_min_seq": 0}
    assert np.isfinite(line["final_loss"])
    assert line["bytes_at_rest"]["masters"] == \
        2 * line["bytes_at_rest"]["params"]
