"""Parameter trees between the JAX layout and the port, both ways.

The one place a model's weights cross between the packages.  The port
keeps the JAX layouts (``wq`` (E, H, D), ``wo`` (H, D, E), ``w1``
(E, F), ``tok_emb`` (V, E), ...), so a conversion only turns each leaf
into the other side's array type, keeping the nesting: dicts stay
dicts, ``layers`` stays a list.

- ``params_from_jax``: numpy leaves (``jax.tree.map(np.asarray,
  params)``) -> float32 CPU tensors, which ``models.gpt.CausalLm(cfg,
  tree)``, ``models.bert.BertMlm(cfg, tree)``, ``models.moe.MoeBertMlm``
  (the expert layers' ``router``, ``ew1``, ``eb1``, ``ew2``, ``eb2``)
  and ``models.encdec.EncDecLm`` (``dec_*`` and the cross-attention's
  ``x*`` leaves) consume;
- ``params_to_numpy``: a port tree (``BertMlm.param_tree()``) -> float32
  numpy leaves, to compare with a JAX model's parameters.  Under a mesh
  (``parallel.mesh``) ``BertMlm(cfg, params_from_jax(tree), mesh=mesh)``
  keeps this rank's block of each whole leaf (``sharding_rules.
  shard_tree`` by the model's ``logical_axes``, the reference's
  placement), and ``train.gspmd.gathered_params`` gathers the blocks
  back into whole leaves for ``params_to_numpy``;
- ``cnn_params_from_jax`` / ``cnn_params_to_numpy``: the same for the
  MNIST CNN, whose conv weights are the one layout that changes (the
  reference's HWIO is the port's OIHW);
- ``resnet_params_from_jax`` / ``resnet_params_to_numpy``: the
  ResNet's nested parameter tree, every 4-D leaf (a conv weight) HWIO
  <-> OIHW (its running statistics cross as they are, through
  ``params_from_jax`` / ``params_to_numpy``);
- ``vit_params_from_jax`` / ``vit_params_to_numpy``: the ViT's tree
  (``models.vit.VisionTransformer``), whose patch projection is a
  matrix and whose ``layers`` are BERT's, so every leaf crosses as the
  encoder's do.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_tensorflow_torch.utils import tree as tree_lib


def params_from_jax(tree):
    """Nested dicts/lists of numpy arrays -> the same nesting of float32
    tensors (copies: the result shares no memory with the input)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    arr = np.asarray(tree, dtype=np.float32)
    return torch.from_numpy(arr.copy())


def params_to_numpy(tree):
    """Nested dicts/lists of tensors (on any device) -> the same nesting
    of float32 numpy arrays (copies)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy().copy()


# the CNN's conv weights: the reference's HWIO <-> the port's OIHW
_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def cnn_params_from_jax(tree: dict) -> dict:
    """The reference ``MnistCnn``'s numpy leaves -> the port's float32
    tensors: ``conv*_w`` HWIO -> OIHW, every other leaf as it is."""
    out = {}
    for k, v in tree.items():
        arr = np.asarray(v, dtype=np.float32)
        if k.startswith("conv") and k.endswith("_w"):
            arr = arr.transpose(_HWIO_TO_OIHW)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out


def cnn_params_to_numpy(tree: dict) -> dict:
    """The inverse of ``cnn_params_from_jax``: port tensors (on any
    device) -> the reference's float32 numpy layout (conv weights
    HWIO)."""
    out = {}
    for k, v in params_to_numpy(tree).items():
        if k.startswith("conv") and k.endswith("_w"):
            v = np.ascontiguousarray(v.transpose(_OIHW_TO_HWIO))
        out[k] = v
    return out


def _conv_layout(arr: np.ndarray, perm) -> np.ndarray:
    return np.ascontiguousarray(arr.transpose(perm)) if arr.ndim == 4 \
        else arr


def resnet_params_from_jax(tree):
    """The reference ``ResNet``'s numpy leaves -> the port's float32
    tensors, conv weights HWIO -> OIHW."""
    return tree_lib.map_leaves(lambda _, v: torch.from_numpy(_conv_layout(
        v.numpy(), _HWIO_TO_OIHW).copy()), params_from_jax(tree))


def resnet_params_to_numpy(tree):
    """The inverse of ``resnet_params_from_jax``: port tensors (on any
    device) -> the reference's float32 numpy layout."""
    return tree_lib.map_leaves(lambda _, v: _conv_layout(v, _OIHW_TO_HWIO),
                               params_to_numpy(tree))


# the ViT has no conv weight: its patch projection is (P*P*C, E) and its
# layers are BERT's, so its leaves cross as the encoder's do
vit_params_from_jax = params_from_jax
vit_params_to_numpy = params_to_numpy
