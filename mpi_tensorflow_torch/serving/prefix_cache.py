"""Radix prefix cache: cross-request reuse of shared-prefix KV blocks.

Counterpart of ``mpi_tensorflow_tpu/serving/prefix_cache.py``, ported
whole, the replica router's ``root_hook`` included: the same trie, the
same LRU clock and the same refcount moves, so the two caches make
identical decisions on the same operations (the parity tests drive both
with one seeded stream).  Pure host Python; it
imports no torch, and the engine supplies the device halves (the
copy-on-write block copy, the partial tail-block copy and the host
tier's demote / promote copies).

- A trie node is one FULL block of prompt tokens in context: its key is
  the block's token tuple, its path from the root is the whole prefix,
  and it pins one physical pool block holding that prefix's KV.  Keys
  are token-exact, so no collision can alias two prefixes to one block.
- ``match_and_share`` walks a new prompt's full blocks down the trie
  and maps every hit to the EXISTING physical block (one ``share`` ref
  each): prefill is charged only for the unique suffix.
- ``insert`` runs when a sequence finishes prefill (and, under
  ``prefix_gen``, when a sequence finishes: prompt + generated blocks):
  the trie adopts the sequence's full blocks it has not seen before.
  Only full, fully written blocks enter, so a cached block's content
  never changes; writes into shared blocks happen only on the engine's
  copy-on-write path.
- ``match_partial`` (prefix v2) extends a full-block match into the
  tail: the best-matching child block donates its matched row prefix
  through the engine's partial-copy dispatch.
- ``evict`` frees least-recently-used UNREFERENCED leaves (refcount 1:
  only the trie holds the block) under pool pressure; with the host
  tier wired in, a victim's bytes are demoted to host memory first and
  promoted back by a later walk over the same token path.

A matched block holds the KV that re-prefilling its positions would
write (same tokens, same absolute positions, same forward), so greedy
decoding with the cache on gives the tokens of the cache off.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    """One full token-block of prefix context pinning one pool block."""

    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"], last_used: int):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = last_used


class PrefixCache:
    """Block-granularity radix trie over prompt prefixes.

    Refcount model: the trie holds exactly ONE allocator reference per
    node (taken at ``insert``, dropped at eviction); every sequence
    whose block table maps a cached block holds its own.  So
    ``refcount == 1`` means "trie only" (evictable) and ``> 1`` means
    live sequences read it (protected).

    ``allocator`` is a ``paged_cache.BlockAllocator``."""

    def __init__(self, allocator, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.allocator = allocator
        self.block_size = block_size
        self._root = _Node((), 0, None, 0)
        self._clock = 0              # monotone LRU stamp source
        self.num_blocks = 0          # nodes == distinct pool blocks held
        self.inserted = 0            # nodes ever adopted
        self.evicted = 0             # nodes LRU-evicted
        # observer of the root's children (leading full-block keys):
        # root_hook(key, True) when a first-block node is adopted,
        # root_hook(key, False) when one is evicted; the replica
        # router's prefix-aware placement feeds its owner map from it
        self.root_hook = None
        # the host tier (kv_tier="host"); the engine wires all three or
        # none: ``tier`` a paged_cache.HostBlockStore,
        # ``demote_fetch(block) -> host leaves`` copies a pool block to
        # the host just before eviction releases it, ``promote_put(
        # leaves, block)`` lands stored bytes in a freshly allocated
        # device block during a match walk, before the sequence's first
        # dispatch.  Keys are full trie token paths, so an entry can
        # only re-admit for the one prefix that produced it
        self.tier = None
        self.demote_fetch = None
        self.promote_put = None
        self.promoted = 0            # nodes re-admitted from the tier

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ---------------- lookup ----------------

    def match_and_share(self, prompt: List[int]) -> Tuple[List[int], int]:
        """Longest cached block-prefix of ``prompt``: returns the
        physical block ids (one ``share`` reference taken on each; the
        caller owns them like freshly allocated blocks) and the number
        of prompt tokens they serve.

        The served-token count is capped at ``len(prompt) - 1``: the
        prefill must recompute the final prompt position to emit the
        first output token.  When every full block hits and the prompt
        length is an exact block multiple, that recompute lands INSIDE
        the last shared block, and the engine's copy-on-write path gives
        the sequence a private copy first."""
        node, ids, path = self._root, [], []
        bs = self.block_size
        for j in range(len(prompt) // bs):
            key = tuple(prompt[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick()
            ids.append(child.block)
            path.append(key)
            node = child
        self.allocator.share(ids)
        if self.tier is not None and self.promote_put is not None:
            node = self._promote_walk(node, prompt, ids, path)
        cached = len(ids) * bs
        if cached >= len(prompt):
            cached = len(prompt) - 1
        return ids, cached

    def _promote_walk(self, node: "_Node", prompt: List[int],
                      ids: List[int], path: List[Tuple[int, ...]]):
        """Extend a trie walk through the host tier: where the device
        trie ran out, demoted blocks whose token path continues the
        prompt are promoted back into fresh device blocks and their
        nodes rebuilt.  A re-admitted node takes the trie's reference
        (the alloc) plus the sequence's share, the accounting a normal
        hit leaves.  ``ids``/``path`` grow in place; promotion stops at
        the first tier miss, allocation failure or prompt end."""
        bs = self.block_size
        for j in range(len(ids), len(prompt) // bs):
            key = tuple(prompt[j * bs:(j + 1) * bs])
            full = tuple(path) + (key,)
            # peek before pop: on allocation failure the entry survives
            # for a later walk under less pressure
            if full not in self.tier or not self.allocator.can_alloc(1):
                break
            bid = self.allocator.alloc(1)[0]        # the trie's own ref
            self.promote_put(self.tier.pop(full), bid)
            child = _Node(key, bid, node, self._tick())
            node.children[key] = child
            self.num_blocks += 1
            self.promoted += 1
            if node is self._root and self.root_hook is not None:
                self.root_hook(key, True)
            self.allocator.share([bid])             # the sequence's ref
            ids.append(bid)
            path.append(key)
            node = child
        return node

    def match_partial(self, prompt: List[int],
                      matched_blocks: int) -> Optional[Tuple[int, int]]:
        """Best mid-block extension of a full-block match: among the
        children of the node at depth ``matched_blocks``, the block
        whose key shares the longest ROW PREFIX with the prompt's tail.
        Returns ``(block, rows)`` with one ``share`` reference taken on
        ``block`` (the pin that keeps eviction from recycling the source
        before the engine's partial copy reads it; the caller releases
        it after the copy), or None when no child shares a usable row.
        ``rows`` is capped at ``len(tail) - 1`` so the final prompt
        position always recomputes, and so stays below ``block_size``."""
        node, bs = self._root, self.block_size
        for j in range(matched_blocks):
            node = node.children.get(tuple(prompt[j * bs:(j + 1) * bs]))
            if node is None:          # evicted below a match
                return None
        tail = prompt[matched_blocks * bs:]
        limit = min(len(tail) - 1, bs)
        if limit <= 0:
            return None
        best, best_rows = None, 0
        for key, child in node.children.items():
            r = 0
            while r < limit and r < len(key) and key[r] == tail[r]:
                r += 1
            if r > best_rows:
                best, best_rows = child, r
        if best is None:
            return None
        best.last_used = self._tick()
        self.allocator.share([best.block])
        return best.block, best_rows

    # ---------------- registration ----------------

    def insert(self, prompt: List[int], block_ids: List[int]) -> int:
        """Register a FULLY PREFILLED prompt's full blocks; the trie
        adopts (one ``share`` ref) each block it has no node for yet.
        Blocks already cached keep their node: a sequence that
        recomputed a cached block privately keeps its private copy.
        Returns nodes added."""
        node, added = self._root, 0
        bs = self.block_size
        for j in range(len(prompt) // bs):
            key = tuple(prompt[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                self.allocator.share([block_ids[j]])
                child = _Node(key, block_ids[j], node, 0)
                node.children[key] = child
                self.num_blocks += 1
                self.inserted += 1
                added += 1
                if node is self._root and self.root_hook is not None:
                    self.root_hook(key, True)
            child.last_used = self._tick()
            node = child
        return added

    # ---------------- eviction ----------------

    def _path_key(self, node: "_Node") -> tuple:
        """Full trie token path of ``node`` (one token tuple per block,
        root first): the host tier's key."""
        keys = []
        while node is not self._root:
            keys.append(node.key)
            node = node.parent
        return tuple(reversed(keys))

    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, want_blocks: int) -> int:
        """Release up to ``want_blocks`` pool blocks by evicting
        least-recently-used UNREFERENCED leaves (refcount 1); evicting a
        leaf can expose its parent next.  Returns blocks freed; the
        caller evicts sequences for the rest.  Leaves only: an interior
        node's children are prefixes that run through it."""
        freed = 0
        while freed < want_blocks:
            victims = [n for n in self._leaves()
                       if self.allocator.refcount(n.block) == 1]
            if not victims:
                break
            victim = min(victims, key=lambda n: n.last_used)
            del victim.parent.children[victim.key]
            if self.tier is not None and self.demote_fetch is not None:
                # demote instead of discard: the block's bytes go to the
                # host under its full token path BEFORE the release
                # recycles it.  Children demote before parents and
                # promotion walks parent-first, so chains round-trip
                self.tier.put(self._path_key(victim),
                              self.demote_fetch(victim.block))
            self.allocator.release([victim.block])
            self.num_blocks -= 1
            self.evicted += 1
            freed += 1
            if victim.parent is self._root and self.root_hook is not None:
                self.root_hook(victim.key, False)
        return freed

    # ---------------- invariants / stats ----------------

    def check(self) -> None:
        """Every node pins a live, distinct pool block."""
        seen, stack = set(), list(self._root.children.values())
        while stack:
            n = stack.pop()
            if self.allocator.refcount(n.block) < 1:
                raise AssertionError(f"trie node holds freed block "
                                     f"{n.block}")
            if n.block in seen:
                raise AssertionError(f"two trie nodes share physical "
                                     f"block {n.block}")
            seen.add(n.block)
            stack.extend(n.children.values())
        if len(seen) != self.num_blocks:
            raise AssertionError(f"trie counts {self.num_blocks} blocks, "
                                 f"holds {len(seen)}")

    def stats(self) -> dict:
        return {"blocks": self.num_blocks, "inserted": self.inserted,
                "evicted": self.evicted, "promoted": self.promoted}
