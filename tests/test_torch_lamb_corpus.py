"""LAMB and the warmup-cosine schedule (``train/optimizer.py``), the
real-text corpus (``data/corpus.py``), the trainer's flag checks
(``cli.py``) and resume for the new families, on the CPU:

- ``warmup_cosine`` against the reference's schedule as optax runs it
  (jitted) at every step of a 100-step horizon: within one float32 ulp
  of the base rate (XLA's float32 cosine is not correctly rounded, and
  its jitted division not the numpy one; the port's cosine is the
  float64 one rounded);
- ``train_mlm`` with ``optimizer="lamb"``, ``lr_schedule=
  "warmup_cosine"``, ``--text-file`` and ``--vocab-file`` (a corpus and a
  WordPiece vocabulary the test writes; the model adopts the
  vocabulary's size) against the reference's ``optax.lamb`` run:
  parameters after three steps within 1e-5 (each key bias within 3 x
  lr), the held-out rows the trailing 10 %;
- LAMB under zero1 and fsdp over two gloo ranks
  (``tests/_torch_lamb_worker.py``, on ``tests/_torch_tdp_worker.py``'s
  inputs) against one process: the trust ratios' norms are the whole
  leaves', losses and parameters within 1e-5 (each key bias within 3 x
  lr);
- the corpus arrays (byte-level and WordPiece rows, capped rows, MLM
  masking, causal rows) exactly equal to the reference's;
- the CLI's refusals, word for word the reference's, before any device
  is touched;
- the weight-decay mask over the MoE and enc-dec trees (their ``eb*``
  and ``xb*`` biases undecayed) and ``encdec_train_flops`` equal to the
  reference's;
- ``moe_bert``, ``encdec_t5`` and a LAMB run stopped after step 5 and
  resumed: the uninterrupted run's history and state, bit-equal.

The reference compiles with XLA's optimisation passes off.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_ckpt_worker as ckpt_worker
import _torch_lamb_worker as lamb_worker
from _torch_family_cases import (JCFG, TCFG, assert_steps_close, np_params,
                                 train_pair)
from mpi_tensorflow_tpu import cli as jax_cli
from mpi_tensorflow_tpu.data import corpus as jax_corpus
from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import encdec as jax_encdec
from mpi_tensorflow_tpu.models import moe as jax_moe
from mpi_tensorflow_tpu.train import optimizer as jax_opt
from mpi_tensorflow_tpu.utils import flops as jax_flops
from mpi_tensorflow_torch import cli
from mpi_tensorflow_torch.config import Config
from mpi_tensorflow_torch.data import corpus, synthetic
from mpi_tensorflow_torch.models import bert, convert, encdec, moe
from mpi_tensorflow_torch.parallel import mesh
from mpi_tensorflow_torch.train import checkpoint, gspmd, mlm_loop, optimizer
from mpi_tensorflow_torch.train import state_io
from mpi_tensorflow_torch.utils import flops
from mpi_tensorflow_torch.utils import tree as tree_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tdp = lamb_worker.tdp
WORDS = ("the quick brown fox jumps over a lazy dog while seven "
         "wizards quietly hex jovial bakers. unbelievable! it's "
         "running, jumping; and ran").split()


def test_warmup_cosine_within_an_ulp_of_reference():
    for base, warm, total in ((1e-4, 10, 100), (3e-3, 1, 100),
                              (5e-4, 7, 37)):
        ref = jax.jit(jax_opt.warmup_cosine(base, warm, total))
        mine = optimizer.warmup_cosine(base, warm, total)
        want = np.array([ref(s) for s in range(total + 3)], np.float32)
        got = np.array([mine(s) for s in range(total + 3)], np.float32)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=base * np.finfo(np.float32).eps)
    tx = optimizer.transformer_tx(1.0, 100, schedule="warmup_cosine")
    assert tx.lr(0) == 0 and tx.lr(10) == 1 and tx.lr(100) == 0
    with pytest.raises(ValueError):
        optimizer.transformer_tx(1.0, 10, optimizer="sgd")


@pytest.mark.parametrize("family", ["moe", "encdec"])
def test_decay_mask_over_the_new_trees_matches_reference(family):
    jm, port = {"moe": (jax_moe.MoeBertMlm(JCFG), moe.MoeBertMlm),
                "encdec": (jax_encdec.EncDecLm(JCFG), encdec.EncDecLm)}[family]
    params = np_params(jm.init, 0)
    want = jax_opt.decay_mask(params)
    model = port(TCFG, convert.params_from_jax(params))
    got = optimizer.decay_mask(model.param_tree())
    named = {}
    for path, flag in tree_lib.leaves_with_path(got):
        assert flag == bool(tree_lib.at(want, path)), path
        named.setdefault(tree_lib.leaf_name(path), set()).add(flag)
    biases = {"eb1", "eb2"} if family == "moe" else {"xbq", "xbk", "xbv",
                                                      "xbo"}
    assert all(named[b] == {False} for b in biases)
    assert named["ew1" if family == "moe" else "xq"] == {True}
    if family == "encdec":
        for b, s, t in ((4, 4096, 4096), (2, 128, 96)):
            assert flops.encdec_train_flops(bert.BERT_BASE, 12, b, s, t) \
                == jax_flops.encdec_train_flops(jax_bert.BERT_BASE, 12, b,
                                                s, t)


# ------------------------------------------------------------ corpora

def _write_corpus(tmp_path, lines=40):
    rng = np.random.default_rng(0)
    text = "\n".join(" ".join(rng.choice(WORDS, 12)) for _ in range(lines))
    text += "\nnon-ascii: café naïve zzzz\n"
    path = tmp_path / "corpus.txt"
    path.write_text(text, encoding="utf-8")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[unused0]",
             ".", "!", ",", ";", "'", ":", "-", "s", "un", "##believ",
             "##able", "##ing", "##s", "##ed", "caf", "##é", "na", "##ï",
             "##ve", *sorted(set(w.strip(".!,;") for w in WORDS))]
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\r\n".join(dict.fromkeys(vocab)) + "\r\n")
    return str(path), str(vpath)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_corpus_arrays_equal_reference(tmp_path):
    path, vpath = _write_corpus(tmp_path)
    vocab, jvocab = (corpus.WordPieceVocab.from_file(vpath),
                     jax_corpus.WordPieceVocab.from_file(vpath))
    assert vocab.size == jvocab.size and vocab.mask == jvocab.mask == 4
    _same(vocab.random_replacement_ids(), jvocab.random_replacement_ids())
    for text in ("Unbelievable!  it's café zzzz", "jumping,ran", ""):
        _same(vocab.encode(text), jvocab.encode(text))
        _same(corpus.encode_bytes(text), jax_corpus.encode_bytes(text))
    assert corpus.decode_bytes(corpus.encode_bytes("fox")) == b"fox"
    for kw in (dict(seq_len=16), dict(seq_len=16, max_sequences=3),
               dict(seq_len=7, vocab_file=vpath),
               dict(seq_len=7, vocab_file=vpath, max_sequences=5)):
        if "vocab_file" not in kw:
            _same(corpus.sequences_from_file(path, **kw),
                  jax_corpus.sequences_from_file(path, **kw))
        _same(corpus.load_causal(path, **kw), jax_corpus.load_causal(path,
                                                                     **kw))
        for g, w in zip(corpus.load_mlm(path, seed=3, **kw),
                        jax_corpus.load_mlm(path, seed=3, **kw)):
            _same(g, w)
    with pytest.raises(ValueError, match="shorter than one sequence"):
        corpus.sequences_from_file(path, seq_len=10**6)


@pytest.fixture(scope="module")
def lamb_runs(tmp_path_factory):
    path, vpath = _write_corpus(tmp_path_factory.mktemp("corpus"), lines=16)
    V = corpus.WordPieceVocab.from_file(vpath).size
    jcfg = dataclasses.replace(JCFG, layers=1, vocab_size=V, ce_chunk=32)
    tcfg = dataclasses.replace(TCFG, layers=1, vocab_size=V, ce_chunk=32)
    init = np_params(jax_bert.BertMlm(jcfg).init, 4)
    rows = corpus.load_mlm(path, seq_len=16, seed=1, vocab_file=vpath)[0]
    seen = []
    step = gspmd.make_train_step

    def feeding(*a, **kw):
        fn = step(*a, **kw)

        def call(state, batch, *rest):
            seen.append(batch["tokens"].numpy().copy())
            return fn(state, batch, *rest)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gspmd, "make_train_step", feeding)
        out = train_pair(bert.BertMlm, init, model="bert_base", lr=1e-3,
                         jcfg=dataclasses.replace(jcfg, vocab_size=30522),
                         tcfg=dataclasses.replace(tcfg, vocab_size=30522),
                         lr_schedule="warmup_cosine", optimizer="lamb",
                         text_file=path, vocab_file=vpath)
    return out, rows, seen, V


def test_lamb_text_file_steps_match_reference(lamb_runs):
    (want, got, w3, g3), rows, seen, V = lamb_runs
    n_test = max(len(rows) // 10, 1)
    assert got.num_steps == want.num_steps == (len(rows) - n_test) // 4 == 3
    assert_steps_close(w3, g3, 1e-3)
    assert got.state.model.tok_emb.shape[0] == V
    # the trailing 10 % is held out: no train step reads those rows
    fed = np.concatenate(seen)
    held = rows[len(rows) - n_test:]
    assert not any((fed == r).all(-1).any() for r in held)
    assert [t for t, _ in got.history] == [t for t, _ in want.history]
    for (_, e_got), (_, e_want) in zip(got.history, want.history):
        assert abs(e_got - e_want) <= 1.5


# ------------------------------------------------- LAMB across ranks

@pytest.fixture(scope="module")
def lamb_world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("lamb_dp")
    init = convert.params_to_numpy(bert.init_params(
        tdp.tiny(), torch.Generator().manual_seed(7)))
    tokens, targets, mask = synthetic.mlm_batches(
        tdp.STEPS * tdp.GLOBAL_B, seq_len=tdp.S, vocab_size=1024, seed=11)
    shape = (tdp.STEPS, tdp.GLOBAL_B, tdp.S)
    inputs = {"tokens": tokens.reshape(shape), "mask": mask.reshape(shape),
              "targets": targets.reshape(shape),
              **tdp.flatten(init, "init")}
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in mesh.LAUNCH_ENV:
        env.pop(k, None)
    port = mesh.free_port()
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, lamb_worker.__file__, str(r), "2", str(port),
         str(workdir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        # the one-process run, while the ranks run
        inputs = dict(np.load(workdir / "inputs.npz"))
        tx = optimizer.transformer_tx(tdp.LR, tdp.NUM_STEPS,
                                      optimizer="lamb",
                                      schedule="warmup_cosine")
        state = gspmd.init_state(tdp._model(inputs), tx)
        step = gspmd.make_train_step(tx)
        rows = mlm_loop.rank_rows(0, tdp.GLOBAL_B, 1, 0, 1)
        losses = [float(step(state, *tdp._batch(inputs, t, rows))[1]["loss"])
                  for t in range(tdp.STEPS)]
        want = (np.array(losses), tdp._params(state))
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        log.seek(0)
        assert rc == 0, f"rank {r} exited {rc}:\n{log.read()[-4000:]}"
        log.close()
    return want, [np.load(workdir / f"rank{r}.npz") for r in range(2)]


@pytest.mark.parametrize("kind", lamb_worker.KINDS)
def test_lamb_sharded_over_two_ranks_matches_one_process(lamb_world, kind):
    (losses, params), ranks = lamb_world
    for npz in ranks:
        np.testing.assert_allclose(npz[f"{kind}/losses"], losses, atol=1e-5,
                                   rtol=0)
        for key, w in tdp.flatten(params, "").items():
            np.testing.assert_allclose(
                npz[f"{kind}/params{key}"], w, rtol=0,
                atol=3 * tdp.LR if key.endswith("/bk") else 1e-5,
                err_msg=f"{kind}{key}")


# -------------------------------------------------------------- the CLI

@pytest.mark.parametrize("argv", [
    ["--model", "encdec_t5", "--text-file", "c.txt"],
    ["--model", "resnet20", "--text-file", "c.txt"],
    ["--vocab-file", "v.txt"],
    ["--model", "bert_base", "--vocab-file", "v.txt"],
    ["--optimizer", "lamb"],
    ["--model", "resnet50", "--optimizer", "lamb"],
])
def test_cli_refusals_match_reference(argv):
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cuda"])
    assert str(got.value) == str(want.value) and str(got.value)


def test_encdec_refuses_a_text_file(tmp_path):
    path, _ = _write_corpus(tmp_path)
    with pytest.raises(ValueError, match="single-stream"):
        mlm_loop.train_mlm(Config(model="encdec_t5", text_file=path),
                           TCFG, seq_len=16, device="cpu")


# ---------------------------------------------------------------- resume

RESUME = [("moe_bert", {}), ("encdec_t5", {}), ("bert_base",
                                                 {"optimizer": "lamb"})]


def _run(model, extra, ckpt_dir, resume=False, stop=None):
    cfg = Config(model=model, epochs=1, batch_size=4, log_every=3, seed=1,
                 checkpoint_dir=ckpt_dir, resume=resume, **extra)
    with ckpt_worker.stopping(stop):
        res = mlm_loop.train_mlm(cfg, TCFG, seq_len=16, train_n=32,
                                 test_n=8, learning_rate=1e-3,
                                 verbose=False, device="cpu")
    return res, [np.asarray(p.data).copy() for p in state_io.parts(
        res.state)]


@pytest.mark.parametrize("model,extra", RESUME,
                         ids=[m + "".join(e) for m, e in RESUME])
def test_stopped_run_resumes_bit_equal(model, extra, tmp_path):
    full, full_leaves = _run(model, extra, str(tmp_path / "full"))
    part = str(tmp_path / "part")
    stopped, _ = _run(model, extra, part, stop=ckpt_worker.STOP)
    assert stopped.num_steps == full.num_steps == 8
    assert checkpoint.latest_step(part) == ckpt_worker.STOP
    res, leaves = _run(model, extra, part, resume=True)
    assert res.history == [h for h in full.history
                           if h[0] > ckpt_worker.STOP]
    assert len(leaves) == len(full_leaves)
    for a, b in zip(leaves, full_leaves):
        assert np.array_equal(a, b)
