"""The tiny ResNets that the ResNet parity tests share, on the JAX side.

``tests/test_torch_resnet.py`` holds the port against these nets, and
``tests/test_torch_data_axis.py`` writes their parameters and state for
its gloo world (``tests/_torch_dp_worker.py`` builds ``TINY["basic"]``
as ``RESNET``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_tensorflow_tpu.models import resnet as jax_resnet

# the tiny nets: (reference, port) geometry
TINY = {
    "basic": dict(stage_sizes=(1, 1), widths=(8, 16), bottleneck=False,
                  cifar_stem=True),
    "bottleneck": dict(stage_sizes=(1, 1), widths=(16, 32),
                       bottleneck=True, cifar_stem=False),
}


def jax_net(name, dtype=jnp.float32):
    return jax_resnet.ResNet(**TINY[name], compute_dtype=dtype)


def shapes(model):
    """``jax.eval_shape`` of the reference's ``init``: its He-normal draw
    sizes the fan-in with a concrete product, which tracing refuses, so
    a shape-only stand-in takes its place."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, "_he_normal",
                   lambda key, shape: jnp.zeros(shape, jnp.float32))
        return jax.eval_shape(model.init, jax.random.key(0))


def net_inputs(name, seed=0):
    """A tiny net's parameters in the reference's tree, drawn from numpy
    as its init draws them (He-normal convs, the fc weight x 0.01) with
    BatchNorm's scale and offset away from 1 and 0, and a state away
    from 0 and 1 (so that evaluation reads real statistics)."""
    model = jax_net(name)
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = getattr(path[-1], "key", None)
        if key in ("scale", "var"):
            return rng.uniform(1.1, 1.5, x.shape).astype(np.float32)
        if key in ("offset", "mean", "b"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        std = 0.01 if len(x.shape) == 2 else np.sqrt(
            2.0 / np.prod(x.shape[:-1]))
        return (rng.normal(size=x.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes(model))
    state = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
        model.init_state))
    return params, state
