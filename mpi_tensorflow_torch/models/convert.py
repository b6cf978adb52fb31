"""JAX parameter pytree -> the port's parameter tree.

The one place a JAX model's weights cross into the port.  The port keeps
the JAX layouts (``wq`` (E, H, D), ``wo`` (H, D, E), ``w1`` (E, F),
``tok_emb`` (V, E), ...), so the conversion only turns each leaf —
given as a numpy array (``jax.tree.map(np.asarray, params)``) — into a
float32 CPU tensor, keeping the nesting: dicts stay dicts, ``layers``
stays a list.  ``models.gpt.CausalLm(cfg, tree)`` consumes the result.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree):
    """Nested dicts/lists of numpy arrays -> the same nesting of float32
    tensors (copies: the result shares no memory with the input)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    arr = np.asarray(tree, dtype=np.float32)
    return torch.from_numpy(arr.copy())
