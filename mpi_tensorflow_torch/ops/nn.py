"""The ResNet's building blocks on NCHW tensors: SAME convolution and
max-pooling, global average pooling, and BatchNorm whose running
statistics travel as a state dict, never as module buffers.

Counterpart of ``mpi_tensorflow_tpu/ops/nn.py``, whose conv, pool and
BatchNorm were XLA's; here they are PyTorch's (cuDNN on the card), and
no hand kernel lies on them.  Against the reference:

- **SAME padding** is XLA's: ``total = max((ceil(n/s) - 1)*s + k - n,
  0)`` per side, ``total // 2`` before and the rest after, so a stride-2
  layer on an even side pads only at the end (3x3/2: (0, 1); the 7x7/2
  stem on 224: (2, 3); the 3x3/2 max-pool on 112: (0, 1), with -inf).
  PyTorch's ``padding=`` is symmetric and ``"same"`` refuses stride > 1,
  so an uneven pad is an explicit ``F.pad`` first;
- **BatchNorm** normalises with the batch's statistics in training and
  the running ones in evaluation; statistics and normalisation in
  float32, eps 1e-5, the output in the input's dtype.  Training runs
  ``torch.native_batch_norm`` with no running buffers (one fused kernel
  each way, which also returns the batch mean and inverse standard
  deviation) and updates the state itself, ``m * old + (1 - m) *
  batch``, with the batch's biased (population) variance, as
  ``jnp.var`` gives it: ``F.batch_norm``'s own running update uses the
  unbiased variance, ``n / (n - 1)`` times larger;
- ``shards`` > 1 is the in-process data axis: the batch is that many
  equal shards in order, each normalised with its own statistics (the
  reference's per-device BatchNorm under ``shard_map``), and the new
  state is the mean over the shards of each shard's update (its
  ``pmean``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(n: int, k: int, s: int) -> tuple:
    """``(before, after)``: XLA's SAME padding of a side of ``n`` for a
    window ``k`` at stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(x, kh: int, kw: int, s: int) -> tuple:
    return same_pads(x.shape[2], kh, s), same_pads(x.shape[3], kw, s)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """SAME convolution of NCHW ``x`` with OIHW ``w``, no bias."""
    (ht, hb), (wl, wr) = _pads(x, w.shape[2], w.shape[3], stride)
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2):
    """SAME max-pooling of NCHW ``x`` (padding is -inf)."""
    (ht, hb), (wl, wr) = _pads(x, window, window, stride)
    if ht == hb and wl == wr:
        return F.max_pool2d(x, window, stride, padding=(ht, wl))
    x = F.pad(x, (wl, wr, ht, hb), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C): the mean accumulated in float32, returned
    in ``x``'s dtype (``jnp.mean`` on bfloat16)."""
    return torch.mean(x, dim=(2, 3), dtype=torch.float32).to(x.dtype)


def bn_init(channels: int) -> dict:
    """Trainable BatchNorm parameters: scale (gamma) and offset (beta)."""
    return {"scale": torch.ones(channels), "offset": torch.zeros(channels)}


def bn_state_init(channels: int) -> dict:
    """Running statistics (not trained)."""
    return {"mean": torch.zeros(channels), "var": torch.ones(channels)}


def batch_norm(x: torch.Tensor, params: dict, state: dict, *, train: bool,
               momentum: float = 0.9, eps: float = 1e-5, shards: int = 1):
    """``(y, new_state)`` of BatchNorm over (N, H, W) of NCHW ``x``;
    ``state`` is returned as it is in evaluation and never changed in
    place."""
    scale, offset = params["scale"], params["offset"]
    if not train:
        return F.batch_norm(x, state["mean"], state["var"], scale, offset,
                            False, 0.0, eps), state
    if x.shape[0] % shards:
        raise ValueError(f"batch {x.shape[0]} is not {shards} equal shards")
    outs, means, variances = [], [], []
    for part in x.chunk(shards):
        y, mean, invstd = torch.native_batch_norm(
            part, scale, offset, None, None, True, 0.0, eps)
        outs.append(y)
        means.append(mean)
        variances.append(invstd)
    with torch.no_grad():
        new_state = {}
        for key, batch in (("mean", means), ("var", [
                1.0 / torch.square(v) - eps for v in variances])):
            upd = [momentum * state[key] + (1 - momentum) * b
                   for b in batch]
            new_state[key] = upd[0] if shards == 1 else \
                torch.stack(upd).mean(0)
    return (outs[0] if shards == 1 else torch.cat(outs)), new_state
