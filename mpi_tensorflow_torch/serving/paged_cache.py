"""Paged KV cache: host block allocator + device pool construction.

Counterpart of ``mpi_tensorflow_tpu/serving/paged_cache.py``: the
refcounted ``BlockAllocator``, ``blocks_for`` and ``init_pools`` for the
three pool formats (compute dtype, int8, int4).  ``HostBlockStore`` and
``partial_copy_block``
(host tiering and prefix sharing v2) wait for the prefix-cache slice
(ROADMAP Queue 1).

The device side is a fixed pool of ``(num_blocks, heads, block_size,
head_dim)`` K and V blocks per layer; the host side — this module's
allocator — owns which block belongs to whom.  Block 0 is the null
block (``ops/paged_attention.NULL_BLOCK``) and is never handed out.
"""

from __future__ import annotations

from typing import Dict, List

import torch


class BlockAllocator:
    """Refcounted free-list allocator over pool block ids
    ``1..num_blocks-1``.  Pure host Python; LIFO reuse.  ``alloc``
    hands out exclusive blocks (refcount 1), ``share`` adds a reference,
    ``release`` drops one — a block returns to the free list only at
    refcount zero."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (block 0 is the reserved null block), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}     # block id -> refcount (>= 1)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        """Live references on ``block`` (0 = free / never allocated)."""
        return self._ref.get(block, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` exclusive blocks (refcount 1); raises when the pool
        cannot cover them — callers gate on ``can_alloc`` or evict
        first."""
        if n > len(self._free):
            raise RuntimeError(
                f"block pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.num_blocks - 1}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def share(self, ids: List[int]) -> None:
        """Add one reference to each live block."""
        for b in ids:
            if b not in self._ref:
                raise ValueError(f"share of free / foreign block id {b}")
            self._ref[b] += 1

    def release(self, ids: List[int]) -> None:
        """Drop one reference per block; THE one free path."""
        for b in ids:
            c = self._ref.get(b, 0)
            if c < 1:
                raise ValueError(f"double free / foreign block id {b}")
            if c == 1:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = c - 1

    free = release

    def check(self) -> None:
        """Invariant: every non-null block is free xor referenced, once;
        every referenced block carries a positive refcount."""
        assert len(self._free) + len(self._ref) == self.num_blocks - 1
        assert len(set(self._free)) == len(self._free)
        assert not (set(self._free) & set(self._ref))
        assert 0 not in self._ref and 0 not in self._free
        assert all(c >= 1 for c in self._ref.values()), \
            f"non-positive refcount in {self._ref}"


def blocks_for(tokens: int, block_size: int) -> int:
    """Pool blocks needed to hold ``tokens`` cache entries."""
    return -(-tokens // block_size)


def init_pools(cfg, num_blocks: int, block_size: int, device: torch.device,
               kv_dtype: str = "fp32", kv_group: int = 32) -> list:
    """Per-layer zero pools, the reference's leaves and shapes:

    - ``fp32``: ``{"k", "v"}`` of (num_blocks, heads, block_size,
      head_dim) in the model's compute dtype;
    - ``int8``: int8 code pools of that shape plus ``{"k_scale",
      "v_scale"}`` (num_blocks, heads, block_size) float32 row scales;
    - ``int4``: uint8 pools (num_blocks, heads, block_size, head_dim /
      2) of packed nibbles plus (num_blocks, heads, block_size, head_dim
      / g) float32 group scales, ``g = min(kv_group, head_dim)``.  An odd
      head_dim or a group that does not divide it raises.

    The scale leaves share the pools' leading axes, so block-table
    indexing treats them like the codes; their rank tells the consume
    paths int8 from int4."""
    if kv_dtype not in ("fp32", "int8", "int4"):
        raise ValueError(
            f"serve kv dtype must be fp32|int8|int4, got {kv_dtype!r}")
    H, D = cfg.heads, cfg.head_dim
    if kv_dtype == "fp32":
        shape, dtype, sshape = (num_blocks, H, block_size, D), cfg.dtype, None
    elif kv_dtype == "int8":
        shape, dtype = (num_blocks, H, block_size, D), torch.int8
        sshape = (num_blocks, H, block_size)
    else:
        g = min(kv_group, D)
        if D % 2 or g < 1 or D % g:
            raise ValueError(
                f"int4 pool needs even head_dim divisible by the "
                f"effective group min(kv_group, head_dim); got "
                f"head_dim={D}, kv_group={kv_group}")
        shape, dtype = (num_blocks, H, block_size, D // 2), torch.uint8
        sshape = (num_blocks, H, block_size, D // g)
    pools = []
    for _ in range(cfg.layers):
        layer = {key: torch.zeros(shape, dtype=dtype, device=device)
                 for key in ("k", "v")}
        if sshape is not None:
            layer.update({key: torch.zeros(sshape, dtype=torch.float32,
                                           device=device)
                          for key in ("k_scale", "v_scale")})
        pools.append(layer)
    return pools
