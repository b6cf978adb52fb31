"""Paged KV cache: host block allocator + device pool construction.

Counterpart of ``mpi_tensorflow_tpu/serving/paged_cache.py``: the
refcounted ``BlockAllocator``, ``blocks_for`` and ``init_pools`` for the
three pool formats (compute dtype, int8, int4), ``partial_copy_block``
(the device half of prefix sharing v2) and ``HostBlockStore`` (the host
tier of ``kv_tier="host"``).

The device side is a fixed pool of ``(num_blocks, heads, block_size,
head_dim)`` K and V blocks per layer; the host side — this module's
allocator — owns which block belongs to whom.  Block 0 is the null
block (``ops/paged_attention.NULL_BLOCK``) and is never handed out.
"""

from __future__ import annotations

from typing import Dict, List, Optional

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
               kv_dtype: str = "fp32", kv_group: int = 32,
               heads: Optional[int] = None) -> list:
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
    paths int8 from int4.  ``heads`` (default ``cfg.heads``): a
    tensor-parallel rank's share of them (``serving/tp``)."""
    if kv_dtype not in ("fp32", "int8", "int4"):
        raise ValueError(
            f"serve kv dtype must be fp32|int8|int4, got {kv_dtype!r}")
    H, D = (heads or cfg.heads), cfg.head_dim
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


def partial_copy_block(pools: list, src: int, dst: int, n: int) -> None:
    """Copy the first ``n`` token-slot rows of block ``src`` into block
    ``dst`` across every pool leaf, IN PLACE, leaving rows ``>= n`` of
    ``dst`` untouched: the device half of partial tail-block sharing
    (prefix v2).  The slot axis is axis 2 of every leaf, the 4-d code
    pools and the 3-d int8 or 4-d int4 scale siblings alike, so
    quantized pools copy codes and scales together.  The reference
    returns new pools (``jnp.where`` over a row mask); the bytes that
    land are the same."""
    if n <= 0:
        return
    for p in pools:
        for leaf in p.values():
            leaf[dst, :, :n].copy_(leaf[src, :, :n])


class HostBlockStore:
    """Host-RAM tier for demoted KV blocks (``kv_tier="host"``).

    When the prefix cache evicts an unreferenced trie leaf under pool
    pressure, the block's bytes are copied here instead of being lost; a
    later prompt that walks the same trie path PROMOTES them back into a
    freshly allocated device block before its first dispatch.

    Keys are full trie TOKEN PATHS (a tuple of per-block token tuples,
    root first), so an entry can only re-admit for the token stream that
    produced it.  Values are per-layer dicts of CPU ``torch.Tensor``
    leaves, one block row of each pool leaf (codes and scales): torch
    tensors rather than the reference's numpy arrays, because numpy has
    no bfloat16 and a bf16 pool is the one the card serves.

    Pure host bookkeeping, as the reference's engine uses it: an
    insertion-ordered dict with no bound (host RAM is the budget), and
    the counters of the metrics ``tier`` block.  ``promote_ms_total`` is
    added by the engine's promote path."""

    def __init__(self):
        self._store: Dict[tuple, list] = {}
        self.demotions = 0
        self.promotions = 0
        self.host_blocks_peak = 0
        self.promote_ms_total = 0.0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: tuple) -> bool:
        return key in self._store

    def put(self, key: tuple, leaves: list) -> None:
        """Admit a demoted block's host leaves under its trie path key;
        a re-demotion of the same path overwrites (the same bytes)."""
        self._store.pop(key, None)
        self._store[key] = leaves
        self.demotions += 1
        self.host_blocks_peak = max(self.host_blocks_peak,
                                    len(self._store))

    def pop(self, key: tuple):
        """Take a block's leaves out for promotion (None on a miss): the
        trie node owns the canonical copy again, on the device."""
        leaves = self._store.pop(key, None)
        if leaves is not None:
            self.promotions += 1
        return leaves

    def stats(self) -> dict:
        return {"host_blocks": len(self._store),
                "host_blocks_peak": self.host_blocks_peak,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "promote_ms_total": self.promote_ms_total}
