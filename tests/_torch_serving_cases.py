"""Shared inputs of the port's serving parity tests: the tiny model's
seeded weights, the reference engine's fast compile, the result keys the
two engines must agree on, and request lists for either package."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_tensorflow_tpu.models import bert as jax_bert
from mpi_tensorflow_tpu.models import gpt as jax_gpt
from mpi_tensorflow_tpu.serving import engine as jax_engine
from mpi_tensorflow_torch.models import bert, convert, gpt
from mpi_tensorflow_torch.serving import engine

JAX_TINY = dataclasses.replace(jax_bert.BERT_TINY, ce_positions="all")
COMPARED = ("outputs", "statuses", "dispatch_shapes", "forward_dispatches",
            "evictions", "faults", "drain", "prefix", "speculation", "tier",
            "peak_blocks_in_use", "peak_live_blocks", "tokens")
# wall-clock fields of the tier block: timed, so never compared
TIER_TIMES = ("promote_latency_ms_total", "promote_latency_ms_mean")


def np_params(seed):
    """Seeded weights under which greedy tokens vary from step to step
    (LayerNorm scales near 1; with scales near 0 every step emits the
    output bias's argmax)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=x.shape)).astype(np.float32)

    # only the tree's shapes are read
    shapes = jax.eval_shape(jax_gpt.CausalLm(JAX_TINY).init,
                            jax.random.key(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def fast_compile():
    """XLA's optimisation passes off while the reference engine compiles
    its steps: they only slow the compile; the arithmetic is the same."""
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)


@contextlib.contextmanager
def no_prewarm():
    """The reference engine without its pre-warm dispatches (every mixed
    and verify bucket, the draft model's chunk buckets, compiled at
    build into the null block).  They only pay compiles ahead: they add
    nothing to ``dispatch_shapes`` or ``forward_dispatches`` and write
    only the null block, so results are the same without them, and the
    port, with nothing to compile, has none."""
    from mpi_tensorflow_tpu.serving import speculative as jax_spec

    skip = lambda self: None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine.PagedDecodeEngine, "_prewarm_mixed", skip)
        mp.setattr(jax_engine.PagedDecodeEngine, "_prewarm_verify", skip)
        mp.setattr(jax_spec.DraftModelDrafter, "warmup", skip)
        yield


def requests(mod, specs):
    """``[(prompt, max_new_tokens), ...]`` -> ``mod.Request`` list, ids
    in order, every arrival at 0 (so admission order does not depend on
    the wall clock)."""
    return [mod.Request(i, list(p), m) for i, (p, m) in enumerate(specs)]


def pos_kind(cfg, kind):
    return dataclasses.replace(cfg, pos_kind=kind)


JIT_STEPS = ("_decode_fn", "_prefill_fn", "_verify_fn", "_mixed_fn",
             "_cow_fn", "_partial_fn", "_promote_fn")


def jax_engine_for(params, serve_kw, *, kind="learned", donor=None, **kw):
    """The reference engine on its ``xla`` lowering over ``params``.

    ``donor``: an earlier engine of the same model geometry and pool
    whose jitted steps (and its draft model's feed) this one reuses, so
    the module compiles each shape once.  The steps take the parameters
    and pools as arguments and close over the model's static geometry
    and lowering alone, so the results are those of the engine's own."""
    eng = jax_engine.PagedDecodeEngine(
        jax_gpt.CausalLm(pos_kind(JAX_TINY, kind)),
        jax.tree.map(jnp.asarray, params),
        jax_engine.ServeConfig(kernel="xla", **serve_kw), **kw)
    if donor is not None:
        assert donor.model.cfg == eng.model.cfg
        for name in JIT_STEPS:
            setattr(eng, name, getattr(donor, name))
        if hasattr(eng.drafter, "_feed_fn") \
                and hasattr(donor.drafter, "_feed_fn"):
            eng.drafter._feed_fn = donor.drafter._feed_fn
    return eng


def port_model(params, kind="learned"):
    return gpt.CausalLm(pos_kind(bert.BERT_TINY, kind),
                        convert.params_from_jax(params))


def port_engine_for(params, serve_kw, kernel, *, kind="learned", **kw):
    """The port's engine on the CPU with ``kernel`` (``gather``, or
    ``cuda``: the kernel's plain version on CPU tensors)."""
    return engine.PagedDecodeEngine(
        port_model(params, kind),
        engine.ServeConfig(kernel=kernel, **serve_kw), device="cpu", **kw)


def assert_same_result(got, want):
    """Every ``COMPARED`` key equal, the tier block's wall-clock fields
    aside."""
    for key in COMPARED:
        g, w = got[key], want[key]
        if key == "tier":
            g = {k: v for k, v in g.items() if k not in TIER_TIMES}
            w = {k: v for k, v in w.items() if k not in TIER_TIMES}
        assert g == w, (key, g, w)


def assert_quiescent(eng):
    """Every request released its blocks: once the trie lets go of its
    own, the pool is empty."""
    if eng.prefix_cache is not None:
        eng.prefix_cache.check()
        eng.prefix_cache.evict(eng.prefix_cache.num_blocks)
        assert eng.prefix_cache.num_blocks == 0
    eng.allocator.check()
    assert eng.allocator.num_used == 0
