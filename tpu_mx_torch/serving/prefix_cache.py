"""The block-granular shared-prefix index of ``tpu_mx/serving/prefix_cache.py``.

Requests that carry the same leading tokens (a system prompt, a
template) need the same K/V for those positions: a position's K/V is a
function of the tokens at and before it only.  :class:`PrefixIndex` lets
:class:`~tpu_mx_torch.serving.kv_cache.PagedKVCache` map those requests'
leading block-table entries onto the same physical blocks:

- **A trie keyed on full blocks of tokens**: each node is one FULL
  block (its ``block_size`` tokens are the key), chained in prompt
  order, holding the physical block whose K/V encodes that prefix.
  A partial tail block is never indexed: it is still being appended to.
- **References, not ownership**: the index holds one reference on every
  block it indexes (the allocator's refcounts), so a prefix outlives
  the sequence that computed it.
- **Eviction under pressure**: when an allocation cannot be met, the
  cache asks the index to release least-recently-matched LEAF nodes
  whose block only the index holds (refcount 1) until it fits.
  Leaf-first keeps every indexed node reachable from the root.  If that
  is not enough, :class:`~tpu_mx_torch.serving.kv_cache.CacheExhausted`
  stands: backpressure, never an out-of-memory.

Recency is an integer clock, not wall time, so eviction order is a
function of the request sequence only.  The index has no lock: the
owning cache calls it from the server's step thread.
"""
from __future__ import annotations

import heapq
import itertools
import os

from .accounting import INDEX_HOLDER, INDEX_TENANT

__all__ = ["PrefixIndex", "prefix_sharing_enabled"]

_SHARING_ENV = "TPUMX_PREFIX_SHARING"


def prefix_sharing_enabled():
    """The ``TPUMX_PREFIX_SHARING`` knob: ``1``/``on`` turns the
    shared-prefix index on, unset/``0``/``off`` leaves it off (the
    default).  Any other value raises."""
    v = os.environ.get(_SHARING_ENV, "0").strip().lower()
    if v in ("", "0", "off", "false"):
        return False
    if v in ("1", "on", "true", "share"):
        return True
    raise ValueError(
        f"{_SHARING_ENV}={v!r} is not a recognized setting — use 0 "
        "(private prefills, the default) or 1 (block-granular shared-"
        "prefix KV reuse)")


class _Node:
    """One indexed FULL block: ``key`` is its token tuple, ``block_id``
    the physical block whose K/V encodes the prefix ending here."""

    __slots__ = ("key", "block_id", "parent", "children", "last_used")

    def __init__(self, key, block_id, parent):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children = {}
        self.last_used = 0


class PrefixIndex:
    """See the module docstring.  ``allocator`` is the owning cache's
    refcounted :class:`~tpu_mx_torch.serving.kv_cache.BlockAllocator`."""

    def __init__(self, block_size):
        self.block_size = int(block_size)
        self._root = _Node(None, None, None)
        self._clock = itertools.count(1)
        self._nodes = 0
        self.lookups = 0
        self.hits = 0
        self.tokens_matched = 0
        self.evictions = 0

    # -- matching ------------------------------------------------------------
    def match(self, tokens):
        """The longest indexed chain of full blocks that is a prefix of
        ``tokens`` and leaves at least the final token uncovered (its
        logits give the first generated token, so it must be computed):
        ``(block_ids, tokens_covered)``, empty and 0 on a miss.  The
        whole matched chain's recency is refreshed."""
        bs = self.block_size
        self.lookups += 1
        node, blocks = self._root, []
        limit = len(tokens) - 1
        while (len(blocks) + 1) * bs <= limit:
            lo = len(blocks) * bs
            child = node.children.get(tuple(tokens[lo:lo + bs]))
            if child is None:
                break
            blocks.append(child.block_id)
            node = child
        if blocks:
            stamp = next(self._clock)
            n = node
            while n is not self._root:
                n.last_used = stamp
                n = n.parent
            self.hits += 1
            self.tokens_matched += len(blocks) * bs
        return blocks, len(blocks) * bs

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens, block_ids, allocator):
        """Index every FULL block of ``tokens`` (physical ids
        ``block_ids``, in table order).  A new node takes one reference
        on its block; an existing chain keeps its block (the first
        writer wins)."""
        bs = self.block_size
        node = self._root
        stamp = next(self._clock)
        for i in range(min(len(tokens) // bs, len(block_ids))):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, block_ids[i], node)
                # the index's references are ledgered under its own
                # holder and pseudo-tenant: index-resident bytes belong
                # to the fleet, not to whichever tenant prefilled first
                allocator.incref([block_ids[i]], holder=INDEX_HOLDER)
                allocator.describe(INDEX_HOLDER, kind="index",
                                   tenant=INDEX_TENANT)
                node.children[key] = child
                self._nodes += 1
            child.last_used = stamp
            node = child

    # -- eviction ------------------------------------------------------------
    def release(self, allocator, need):
        """Release least-recently-matched evictable leaves (refcount 1:
        only the index holds them) until the free list holds ``need``
        blocks or nothing evictable is left; returns how many were
        released.  A parent that becomes an evictable leaf joins the
        heap as it appears."""
        if allocator.available >= need:
            return 0
        heap = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if not n.children and allocator.refcount(n.block_id) == 1:
                heapq.heappush(heap, (n.last_used, id(n), n))
            stack.extend(n.children.values())
        released = 0
        while heap and allocator.available < need:
            _, _, victim = heapq.heappop(heap)
            del victim.parent.children[victim.key]
            allocator.free([victim.block_id], holder=INDEX_HOLDER)
            self._nodes -= 1
            self.evictions += 1
            released += 1
            parent = victim.parent
            if parent is not self._root and not parent.children \
                    and allocator.refcount(parent.block_id) == 1:
                heapq.heappush(heap, (parent.last_used, id(parent),
                                      parent))
        return released

    def drop_all(self, allocator):
        """Release every index reference; returns the number of nodes
        released."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            allocator.free([n.block_id], holder=INDEX_HOLDER)
            dropped += 1
        self._root.children = {}
        self._nodes = 0
        return dropped

    def reclaimable(self, allocator):
        """How many indexed blocks no live sequence shares (refcount 1):
        an optimistic upper bound on what a pressure pass could release
        (an interior node above a shared child never becomes an
        evictable leaf) — the scheduler's would-fit gate treats a miss
        as the ordinary defer path, not a promise."""
        refs = allocator.refcounts()
        return sum(1 for b in self.block_ids() if refs.get(b) == 1)

    def block_ids(self):
        """The indexed block ids, one per node (the cache's audit counts
        them as references)."""
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.block_id)
            stack.extend(n.children.values())
        return out

    # -- observables ---------------------------------------------------------
    @property
    def nodes(self):
        return self._nodes

    def stats(self):
        """``{nodes, lookups, hits, tokens_matched, evictions}``."""
        return {"nodes": self._nodes, "lookups": self.lookups,
                "hits": self.hits, "tokens_matched": self.tokens_matched,
                "evictions": self.evictions}
