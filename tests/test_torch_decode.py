"""The port's decoding (``CausalLm.generate``'s sampling, ``sample``,
``beam_search``) and ``bench --mode decode`` against the JAX reference,
on the CPU.

The reference draws a token by ``jax.random.categorical``, which is
``argmax(logits + gumbel(key, (B, V)))``; its step i's key is
``fold_in(rng, i)``.  Injecting that Gumbel draw as the port's ``noise``
makes a sampled token a function of the logits alone, so the tests hold
the tokens EQUAL, not alike in distribution.  Tolerances: tokens and
kept supports exact; beam scores 1e-5 absolute (sums of a few float32
log-probabilities of magnitude ~7, two layers summed in another order
by another library).  The tiny model's weights are the serving tests'
(``_torch_serving_cases.np_params``); the reference compiles with XLA's
optimisation passes off.  ``bench --mode decode`` runs with the
geometry patched to BERT_TINY (its keys, lengths and flags are what is
checked; BERT-base on one core would take the file's budget).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving_cases import JAX_TINY, np_params
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_torch import bench
from mpi_tensorflow_torch.models import bert, convert, gpt

REPO = Path(__file__).resolve().parents[1]
B, S0, V = 2, 5, JAX_TINY.vocab_size
FILTERS = {"none": (0, 1.0), "top_k": (7, 1.0), "top_p": (0, 0.9),
           "both": (40, 0.95)}


@pytest.fixture(scope="module")
def models():
    params = np_params(3)
    jmodel = jax_gpt.CausalLm(JAX_TINY)
    port = gpt.CausalLm(bert.BERT_TINY, convert.params_from_jax(params))
    prompt = np.random.default_rng(4).integers(0, V, (B, S0)).astype(
        np.int32)
    return jmodel, jax.tree.map(jnp.asarray, params), port, prompt


def _fast(jitted):
    """``jitted`` compiled at its first call with XLA's optimisation
    passes off (they only slow the compile at this size)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}))
        return compiled[0](*args)
    return call


def _noise(rng, steps, shape):
    """The reference's Gumbel draws of steps 0..steps-1."""
    return np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(rng, i), shape)) for i in range(steps)])


@pytest.mark.parametrize("name", list(FILTERS))
def test_sample_matches_reference(monkeypatch, name):
    """One step's draw, at temperature 0.8, on logits with a wide
    spread: the token, and the support the filters keep (the sorted
    logits the reference hands its draw, against the port's: a noise
    spike on one slot a row, row j's on slot j, draws each kept token
    once and nothing else)."""
    top_k, top_p = FILTERS[name]
    rng = np.random.default_rng(5)
    logits = (3.0 * rng.normal(size=(6, V))).astype(np.float32)
    key = jax.random.key(11)
    seen = []
    categorical = jax.random.categorical

    def spy(k, lg, *a, **kw):
        seen.append(np.asarray(lg))
        return categorical(k, lg, *a, **kw)

    monkeypatch.setattr(jax.random, "categorical", spy)
    want = np.asarray(jax_gpt.CausalLm(JAX_TINY)._sample(
        jnp.asarray(logits), 0.8, key, 3, top_k=top_k, top_p=top_p))
    noise = np.asarray(jax.random.gumbel(jax.random.fold_in(key, 3),
                                         (6, V)))
    got = gpt.sample(torch.from_numpy(logits), 0.8, top_k=top_k,
                     top_p=top_p, noise=torch.from_numpy(noise.copy()))
    assert got.tolist() == want.tolist()

    # the reference's kept support: its sorted logits above the floor
    srt = seen[0]
    order = np.argsort(-logits / 0.8, axis=-1, kind="stable")
    kept_want = ([set(order[r][srt[r] > np.finfo(np.float32).min])
                  for r in range(6)] if name != "none"
                 else [set(range(V))] * 6)
    for r in range(2):
        spikes = torch.full((V, V), 0.0)
        spikes.fill_diagonal_(1e6)
        row = torch.from_numpy(logits[r:r + 1]).expand(V, V)
        picked = gpt.sample(row, 0.8, top_k=top_k, top_p=top_p,
                            noise=spikes)
        kept_got = set(picked.tolist())
        assert kept_got == kept_want[r]
        if top_k:
            assert len(kept_got) <= top_k


def test_generate_sampled_matches_reference(models):
    """Five sampled tokens through both filters, the reference's
    Gumbel draws injected into the port."""
    jmodel, jparams, port, prompt = models
    rng = jax.random.key(7)
    want = np.asarray(_fast(jax.jit(lambda p, t: jmodel.generate(
        p, t, 5, temperature=0.9, top_k=40, top_p=0.95, rng=rng)))(
            jparams, jnp.asarray(prompt)))
    got = port.generate(torch.from_numpy(prompt).long(), 5,
                        temperature=0.9, top_k=40, top_p=0.95,
                        noise=torch.from_numpy(_noise(rng, 5, (B, V))))
    assert got.tolist() == want.tolist()


def test_top_k_one_equals_greedy(models):
    _, _, port, prompt = models
    p = torch.from_numpy(prompt).long()
    greedy = port.generate(p, 6)
    one = port.generate(p, 6, temperature=1.3, top_k=1,
                        generator=torch.Generator().manual_seed(0))
    assert one.tolist() == greedy.tolist()


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7),                        # sampling, no generator
    dict(top_k=5),                                # a filter, greedy
    dict(top_p=0.5),
    dict(temperature=1.0, top_p=0.0, rng=True),   # top_p outside (0, 1]
    dict(temperature=1.0, top_p=1.5, rng=True),
    dict(cache_len=S0 + 3),                       # cache < prompt + new
])
def test_generate_guards_raise_where_the_reference_does(models, kw):
    jmodel, jparams, port, prompt = models
    kw = dict(kw)
    use_rng = kw.pop("rng", False)
    with pytest.raises(ValueError):
        jmodel.generate(jparams, jnp.asarray(prompt), 4,
                        rng=jax.random.key(0) if use_rng else None, **kw)
    with pytest.raises(ValueError):
        port.generate(torch.from_numpy(prompt).long(), 4,
                      generator=torch.Generator() if use_rng else None,
                      **kw)


@pytest.mark.parametrize("kw", [dict(num_beams=0), dict(max_new=0),
                                dict(cache_len=S0 + 2)])
def test_beam_search_guards_raise_where_the_reference_does(models, kw):
    jmodel, jparams, port, prompt = models
    kw = dict(kw)
    n = kw.pop("max_new", 3)
    with pytest.raises(ValueError):
        jmodel.beam_search(jparams, jnp.asarray(prompt), n, **kw)
    with pytest.raises(ValueError):
        port.beam_search(torch.from_numpy(prompt).long(), n, **kw)


def test_beam_search_matches_reference(models):
    """Three beams, four tokens, length penalty 0.5: sequences equal
    (random float32 weights leave no ties), scores within 1e-5."""
    jmodel, jparams, port, prompt = models
    seqs, scores = _fast(jax.jit(lambda p, t: jmodel.beam_search(
        p, t, 4, num_beams=3, length_penalty=0.5)))(jparams,
                                                    jnp.asarray(prompt))
    got_s, got_sc = port.beam_search(torch.from_numpy(prompt).long(), 4,
                                     num_beams=3, length_penalty=0.5)
    assert got_s.shape == (B, 3, S0 + 4)
    assert got_s.tolist() == np.asarray(seqs).tolist()
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(scores),
                               atol=1e-5, rtol=0)


def test_one_beam_equals_greedy(models):
    _, _, port, prompt = models
    p = torch.from_numpy(prompt).long()
    seqs, _ = port.beam_search(p, 5, num_beams=1)
    assert seqs[:, 0].tolist() == port.generate(p, 5).tolist()


def _reference_decode_keys():
    """The keys of the dict the root ``bench.py``'s ``measure_decode``
    returns, read from its source (running it compiles BERT-base)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "measure_decode")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


@pytest.mark.parametrize("beams", [0, 2])
def test_bench_decode_prints_the_reference_keys(capsys, monkeypatch, beams):
    monkeypatch.setattr(bert, "BERT_BASE", bert.BERT_TINY)
    assert bench.main(["--mode", "decode", "--device", "cpu",
                       "--batch-size", "2", "--prompt-len", "4",
                       "--new-tokens", "8", "--steps", "1",
                       "--num-beams", str(beams)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    det = line["detail"]
    assert _reference_decode_keys() <= set(det)
    assert det["decode_lengths"] == [8, 16]
    assert det["roofline_min_per_token_ms"] == 0.0
    assert det["timing_degenerate"] is False
    assert det["num_beams"] == beams and det["platform"] == "cpu"
    assert det["precision"] == "bf16" and det["batch_size"] == 2
    kind = f"beam-{beams}" if beams else "greedy"
    assert line["metric"].startswith(f"GPT-base {kind} decode")
