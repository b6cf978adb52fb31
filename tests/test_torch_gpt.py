"""The port's causal LM against the JAX reference, on the CPU.

The JAX parameter tree is filled from ``numpy.random.default_rng`` (every
leaf random: weights, biases and LayerNorm scales alike, so a dropped
bias or a swapped layout shows) and crosses into the port through
``models/convert.params_from_jax``.

- ``forward_paged`` logits and pools against the reference's through a
  chunked prefill (two chunks, a padded tail lane) and three decode steps
  at per-row lengths, with learned and rope positions, for the port's
  ``gather`` and ``cuda`` lowerings (the latter runs its plain version on
  CPU tensors) against the reference's ``xla`` lowering;
- greedy ``generate`` token-identical to the reference's.

Tolerances: float32 logits 1e-4 absolute (two layers of matmuls summed in
another order by another library, logits of magnitude ~1); pools 1e-5
absolute (one projection); bfloat16 logits 0.1 absolute (each side rounds
every layer's activations to bf16, 2^-8 relative, at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.serving import paged_cache as jax_cache
from mpi_tensorflow_torch.models import bert, convert, gpt
from mpi_tensorflow_torch.serving import paged_cache

JAX_TINY = dataclasses.replace(jax_bert.BERT_TINY, ce_positions="all")
POS_KINDS = ("learned", "rope")


def _jax_params(cfg, seed):
    """The reference's parameter tree with every leaf redrawn from
    numpy: LayerNorm scales near 1, everything else normal x 0.1."""
    rng = np.random.default_rng(seed)
    tree = jax_gpt.CausalLm(cfg).init(jax.random.key(0))

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return 1.0 + 0.1 * rng.normal(size=leaf.shape)
        return 0.1 * rng.normal(size=leaf.shape)

    np_tree = jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)
    return jax.tree.map(jnp.asarray, np_tree), np_tree


def _models(pos_kind, seed=0, dtype="fp32"):
    jcfg = dataclasses.replace(
        JAX_TINY, pos_kind=pos_kind,
        dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tcfg = dataclasses.replace(
        bert.BERT_TINY, pos_kind=pos_kind,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    jparams, np_tree = _jax_params(jcfg, seed)
    return (jax_gpt.CausalLm(jcfg), jparams,
            gpt.CausalLm(tcfg, convert.params_from_jax(np_tree)))


# row 0: 12-token prompt, row 1: 9-token prompt; block size 4, six blocks
# per row: a prefill chunk of 8, a chunk of 4 (row 1's tail padded), then
# three decodes at lengths (12, 9), (13, 10), (14, 11)
BS, NB = 4, 6
TABLES = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
PROMPT_LENS = (12, 9)


def _steps(rng, vocab):
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    steps = []
    for start, width in ((0, 8), (8, 4)):
        toks = np.zeros((2, width), np.int32)
        valid = np.zeros((2, width), bool)
        for b, p in enumerate(prompts):
            chunk = p[start:start + width]
            toks[b, :len(chunk)] = chunk
            valid[b, :len(chunk)] = True
        steps.append((toks, np.array([start, start], np.int32), valid))
    return steps


def _run_both(jmodel, jparams, tmodel, kernel, steps):
    """Feed identical steps to both paths; decode tokens are the
    reference's argmax, so both sides always see the same inputs.
    Yields (reference logits, port logits, valid) per step, then the
    final pools."""
    cfg = tmodel.cfg
    jpools = jax_cache.init_pools(jmodel.cfg, 1 + 2 * NB, BS)
    tpools = paged_cache.init_pools(cfg, 1 + 2 * NB, BS,
                                    torch.device("cpu"))
    jtab, ttab = jnp.asarray(TABLES), torch.from_numpy(TABLES)
    lengths = np.array(PROMPT_LENS, np.int32)
    out = []
    nxt = None
    for i in range(len(steps) + 3):
        if i < len(steps):
            toks, lens, valid = steps[i]
        else:
            toks, lens = nxt[:, None], lengths.copy()
            valid = np.ones((2, 1), bool)
            lengths += 1
        want, jpools = jmodel.forward_paged(
            jparams, jnp.asarray(toks), jpools, jtab, jnp.asarray(lens),
            valid=jnp.asarray(valid), kernel="xla")
        with torch.no_grad():
            got = tmodel.forward_paged(
                torch.from_numpy(toks), tpools, ttab, torch.from_numpy(lens),
                torch.from_numpy(valid), kernel=kernel)
        want = np.asarray(want)
        out.append((want, got.numpy(), valid))
        if i >= len(steps) - 1:
            # the token after each row's last real lane
            last = valid.sum(1) - 1
            nxt = want[np.arange(2), last].argmax(-1).astype(np.int32)
    return out, jpools, tpools


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
@pytest.mark.parametrize("pos_kind", POS_KINDS)
def test_forward_paged_matches_reference(pos_kind, kernel):
    jmodel, jparams, tmodel = _models(pos_kind, seed=1)
    steps = _steps(np.random.default_rng(2), JAX_TINY.vocab_size)
    out, jpools, tpools = _run_both(jmodel, jparams, tmodel, kernel, steps)
    for want, got, valid in out:
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got[valid], want[valid],
                                   rtol=0, atol=1e-4)
    for jp, tp in zip(jpools, tpools):
        for key in ("k", "v"):
            # block 0 takes the padded lane's write; compare real blocks
            np.testing.assert_allclose(tp[key][1:].numpy(),
                                       np.asarray(jp[key])[1:],
                                       rtol=0, atol=1e-5)


def test_forward_paged_bf16_matches_reference():
    jmodel, jparams, tmodel = _models("learned", seed=3, dtype="bf16")
    steps = _steps(np.random.default_rng(4), JAX_TINY.vocab_size)
    out, _, _ = _run_both(jmodel, jparams, tmodel, "gather", steps)
    for want, got, valid in out:
        np.testing.assert_allclose(got[valid], want[valid],
                                   rtol=0, atol=0.1)


@pytest.mark.parametrize("pos_kind", POS_KINDS)
def test_generate_token_identical_to_reference(pos_kind):
    jmodel, jparams, tmodel = _models(pos_kind, seed=5)
    prompt = np.random.default_rng(6).integers(
        0, JAX_TINY.vocab_size, (2, 5)).astype(np.int32)
    want = np.asarray(jmodel.generate(jparams, jnp.asarray(prompt), 6))
    got = tmodel.generate(torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_with_cache_matches_reference():
    """The contiguous-cache prefill plus one decode step: logits within
    float32 tolerance, caches updated in place to the reference's."""
    jmodel, jparams, tmodel = _models("learned", seed=7)
    toks = np.random.default_rng(8).integers(
        0, JAX_TINY.vocab_size, (2, 6)).astype(np.int32)
    jcache = jmodel.init_cache(2, 8)
    tcache = tmodel.init_cache(2, 8)
    for offset, sl in ((0, slice(0, 5)), (5, slice(5, 6))):
        want, jcache = jmodel.forward_with_cache(
            jparams, jnp.asarray(toks[:, sl]), jcache, offset)
        with torch.no_grad():
            got = tmodel.forward_with_cache(torch.from_numpy(toks[:, sl]),
                                            tcache, offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcache[1]["v"].numpy(),
                               np.asarray(jcache[1]["v"]), rtol=0, atol=1e-5)


def test_params_from_jax_keeps_layouts_and_copies():
    np_tree = _jax_params(JAX_TINY, 9)[1]
    tree = convert.params_from_jax(np_tree)
    lp = tree["layers"][0]
    c = bert.BERT_TINY
    assert tuple(lp["wq"].shape) == (c.hidden, c.heads, c.head_dim)
    assert tuple(lp["wo"].shape) == (c.heads, c.head_dim, c.hidden)
    assert tuple(tree["tok_emb"].shape) == (c.vocab_size, c.hidden)
    assert all(t.dtype == torch.float32 for t in
               (lp["w1"], tree["mlm"]["out_b"], tree["emb_ln"]["scale"]))
    np.testing.assert_array_equal(lp["w2"].numpy(),
                                  np_tree["layers"][0]["w2"])
    lp["w2"].zero_()                     # a copy: the source is untouched
    assert np.abs(np_tree["layers"][0]["w2"]).sum() > 0


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; the port must not use exact erf."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tmodel = _models("learned", seed=0)[2]
    layer = tmodel.layers[0]
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # and the layer's MLP really applies that GELU
    h = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 2, 64)).astype(np.float32))
    ref = torch.nn.functional.gelu(h @ layer.w1 + layer.b1,
                                   approximate="tanh") @ layer.w2 + layer.b2
    torch.testing.assert_close(layer.gelu_mlp(h, torch.float32), ref)
