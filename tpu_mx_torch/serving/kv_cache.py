"""Paged KV cache: fixed-size blocks, a refcounted allocator, block tables.

The port of ``tpu_mx/serving/kv_cache.py``:

- **Blocks**: K and V live in one preallocated pool per layer on the
  device, ``k_pool[layer]`` shaped ``(num_blocks, block_size, H, D)``.
  A sequence's cache is a list of block ids — its **block table** —
  plus a length; logically contiguous, physically scattered.
- **Refcounted allocator**: :class:`BlockAllocator` hands out block ids
  from a LIFO free list at one reference each; ``incref`` adds a sharer
  (the shared-prefix index, a :meth:`PagedKVCache.fork` sibling) and
  ``free`` drops one reference, returning a block to the free list only
  at zero.  Freeing a sequence whose blocks another sequence shares
  therefore releases references, never data.  Exhaustion raises
  :class:`CacheExhausted` — the scheduler's backpressure signal, never
  an allocation that runs the card out of memory.
- **O(1) append**: a decode step reserves its window of slots per
  sequence (:meth:`PagedKVCache.reserve_window`) — at most a few
  free-list pops — and the model's step writes each layer's K/V straight
  into the pool at :meth:`PagedKVCache.window_slots` (``index_put_`` on
  the device).
- **Shared prefixes** (``share_prefix``): full blocks of prompt tokens
  are indexed (``serving/prefix_cache.py``); a later prompt with the
  same leading blocks pins them (:meth:`PagedKVCache.match_prefix`),
  reads their K/V on the device (:meth:`PagedKVCache.gather_plan`),
  computes only its suffix and registers both
  (:meth:`PagedKVCache.commit_prefill`).  A shared partial tail block is
  copied before an append writes into it (copy-on-write, one block in
  every layer's pools, on the device).

The reference's capacity ledger (``holder=``/``tenant=`` attribution,
``describe``, ``reassign``, ``capacity_snapshot``, the exhaustion
forensics) waits for ``accounting.py`` (ROADMAP A12).  Bookkeeping
belongs to the server's step thread; the allocator alone is locked, as
the scheduler may size requests from other threads.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import MXNetError, refuse_unported
from .. import device as _device
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from .prefix_cache import PrefixIndex, prefix_sharing_enabled

__all__ = ["CacheExhausted", "BlockAllocator", "PagedKVCache",
           "PrefillPlan", "prefix_sharing_enabled"]

_LEDGER = "A12 (accounting.py)"


def _next_pow2(n):
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


class CacheExhausted(MXNetError):
    """The block pool has no room for this allocation.  This is the
    BACKPRESSURE signal, not an error to crash on: the scheduler catches
    it and requeues (decode append) or defers admission (prefill)."""


class BlockAllocator:
    """LIFO free-list allocator over ``num_blocks`` fixed-size blocks,
    with a reference count per held block.

    ``alloc(n)`` is all-or-nothing: either all ``n`` ids are handed out
    (at one reference each) or :class:`CacheExhausted` is raised and the
    free list is untouched.  ``incref`` and ``free`` reject ids the
    allocator did not hand out: a double free, or a sharer of a freed
    block, would corrupt the pool silently; loud is the only acceptable
    failure.  ``block_bytes`` and ``holder=`` are the capacity ledger's
    (not ported yet: they must keep their defaults)."""

    def __init__(self, num_blocks, block_bytes=1):
        refuse_unported("BlockAllocator", _LEDGER,
                        block_bytes=(block_bytes, 1))
        if int(num_blocks) < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._lock = threading.Lock()
        # LIFO: recently freed blocks are handed out first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._refs = {}         # held block id -> reference count

    def alloc(self, n=1, holder=None):
        """``n`` block ids at one reference each, or raise
        :class:`CacheExhausted` (free list untouched)."""
        refuse_unported("BlockAllocator.alloc", _LEDGER,
                        holder=(holder, None))
        n = int(n)
        with self._lock:
            if n > len(self._free):
                raise CacheExhausted(
                    f"KV cache exhausted: need {n} block(s), "
                    f"{len(self._free)}/{self.num_blocks} free — "
                    "backpressure, not OOM: requeue or reject")
            ids = [self._free.pop() for _ in range(n)]
            for bid in ids:
                self._refs[bid] = 1
        return ids

    def _check_held(self, block_ids, what):
        for bid in block_ids:
            if bid not in self._refs:
                raise MXNetError(
                    f"BlockAllocator.{what}: block {bid} is not held "
                    "(double free, stale or foreign id) — the pool would "
                    "be silently corrupted")

    def incref(self, block_ids, holder=None):
        """One more reference on each (held) block: a sharer."""
        refuse_unported("BlockAllocator.incref", _LEDGER,
                        holder=(holder, None))
        with self._lock:
            self._check_held(block_ids, "incref")
            for bid in block_ids:
                self._refs[bid] += 1

    def free(self, block_ids, holder=None):
        """Drop one reference per block; a block at zero returns to the
        free list (its contents stay in place for the next owner to
        overwrite).  Freeing an unheld block raises and frees nothing."""
        refuse_unported("BlockAllocator.free", _LEDGER,
                        holder=(holder, None))
        with self._lock:
            self._check_held(block_ids, "free")
            for bid in block_ids:
                self._refs[bid] -= 1
                if self._refs[bid] == 0:
                    del self._refs[bid]
                    self._free.append(bid)

    def refcount(self, block_id):
        """The block's reference count (0 when not held)."""
        with self._lock:
            return self._refs.get(block_id, 0)

    def refcounts(self):
        """``{block_id: refcount}`` for every held block (empty once
        every sequence is freed and the prefix index dropped)."""
        with self._lock:
            return dict(self._refs)

    @property
    def available(self):
        """Blocks currently on the free list."""
        with self._lock:
            return len(self._free)

    @property
    def used(self):
        """Blocks currently held."""
        with self._lock:
            return len(self._refs)

    def utilization(self):
        """Used fraction of the pool, in [0, 1]."""
        with self._lock:
            return len(self._refs) / self.num_blocks

    def audit(self, expected_refs=None):
        """Check that the free list and the held blocks partition the
        pool exactly, and, given ``expected_refs`` (``{block_id: count}``
        of the references the caller knows of), that every held block's
        count is exactly that.  Returns ``{num_blocks, used_blocks,
        free_blocks, total_refs}`` or raises :class:`MXNetError`."""
        with self._lock:
            free = set(self._free)
            if len(free) != len(self._free):
                raise MXNetError("BlockAllocator.audit: a block is on the "
                                 "free list twice")
            if free & set(self._refs):
                raise MXNetError(f"BlockAllocator.audit: blocks "
                                 f"{sorted(free & set(self._refs))} are "
                                 "both free and held")
            if len(free) + len(self._refs) != self.num_blocks:
                raise MXNetError("BlockAllocator.audit: free + held != "
                                 f"{self.num_blocks} blocks")
            if expected_refs is not None and expected_refs != self._refs:
                bad = sorted(b for b in set(expected_refs) | set(self._refs)
                             if expected_refs.get(b) != self._refs.get(b))
                raise MXNetError(
                    f"BlockAllocator.audit: reference counts of blocks "
                    f"{bad[:8]} disagree with their holders "
                    f"(held {[self._refs.get(b, 0) for b in bad[:8]]}, "
                    f"expected {[expected_refs.get(b, 0) for b in bad[:8]]})")
            return {"num_blocks": self.num_blocks,
                    "used_blocks": len(self._refs),
                    "free_blocks": len(free),
                    "total_refs": sum(self._refs.values())}


class _Sequence:
    __slots__ = ("blocks", "length")

    def __init__(self, blocks, length):
        self.blocks = blocks
        self.length = length


class PrefillPlan:
    """A pinned prefix match (:meth:`PagedKVCache.match_prefix`):
    ``blocks`` are increfed block ids covering the leading
    ``tokens_matched`` prompt tokens.  A plan flows into exactly one of
    :meth:`PagedKVCache.commit_prefill` (which takes over the pins) or
    :meth:`PagedKVCache.abandon_plan` (which releases them); consuming
    it twice raises, since releasing its pins again would steal another
    holder's reference."""

    __slots__ = ("blocks", "tokens_matched", "holder", "_consumed")

    def __init__(self, blocks, tokens_matched, holder=None):
        self.blocks = list(blocks)
        self.tokens_matched = int(tokens_matched)
        self.holder = holder
        self._consumed = False

    def consume(self):
        """Mark the pins as spent; a second consumption raises."""
        if self._consumed:
            raise MXNetError(
                "PrefillPlan already consumed (committed or abandoned) — "
                "releasing its pins again would steal another holder's "
                "reference and corrupt served K/V")
        self._consumed = True

    def __repr__(self):
        return (f"PrefillPlan({len(self.blocks)} shared blocks, "
                f"{self.tokens_matched} tokens"
                + (", consumed)" if self._consumed else ")"))


class PagedKVCache:
    """Block-pooled K/V storage for many concurrent sequences::

        cache = PagedKVCache(num_layers=2, num_heads=4, head_dim=16,
                             block_size=16, num_blocks=256, device="cuda")
        cache.prefill("req-1", k, v)          # k/v (layers, L, H, D)
        cache.reserve_window("req-1", 1)      # the O(1) append
        bids, offs = cache.window_slots(["req-1"], 1)
        tables, lengths = cache.batch_tables(["req-1"])
        cache.free_sequence("req-1")

    ``dtype`` is the pool's storage type (float32, or bfloat16 to halve
    the decode kernel's bytes); values are computed in float32 and cast
    on write.  ``storage`` (the reference's ``"host"``/``"device"``) is
    checked and otherwise ignored: the port's pools always live on
    ``device``.  ``share_prefix`` (None: ``TPUMX_PREFIX_SHARING``) turns
    the shared-prefix index on; it needs a float32 pool, since a lossy
    pool would feed a suffix prefill rounded prefix K/V where a full
    prefill recomputes it.  ``forensics`` (the capacity records) must
    keep its default: not ported yet (ROADMAP A12)."""

    def __init__(self, num_layers, num_heads, head_dim, block_size=16,
                 num_blocks=256, dtype=torch.float32, storage="host",
                 share_prefix=None, forensics=None, device="cuda"):
        if storage not in ("host", "device"):
            raise ValueError(f"storage must be 'host' or 'device', "
                             f"got {storage!r}")
        refuse_unported("PagedKVCache", _LEDGER, forensics=(forensics, None))
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if share_prefix is None:
            share_prefix = prefix_sharing_enabled()
        if share_prefix and dtype != torch.float32:
            raise ValueError(
                f"share_prefix requires a float32 pool (got {dtype}): a "
                "lossy pool would give a shared prefix other logits than "
                "a private prefill")
        self.device = _device.resolve(device)
        self.allocator = BlockAllocator(num_blocks)
        shape = (self.num_layers, self.allocator.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        # per-token K/V footprint across all layers, both pools
        self._token_bytes = (self.num_layers * self.num_heads * self.head_dim
                             * 2 * self.k_pool.element_size())
        self._seqs = {}
        self.prefix = PrefixIndex(self.block_size) if share_prefix else None
        self._prompt_tokens = 0     # tokens asked for across prefills
        self._cached_tokens = 0     # of those, served from the index
        self._cow_copies = 0

    # -- bookkeeping ---------------------------------------------------------
    def _entry(self, seq_id):
        try:
            return self._seqs[seq_id]
        except KeyError:
            raise MXNetError(f"PagedKVCache: unknown sequence {seq_id!r} "
                             "(never prefilled, or already freed)") from None

    def has_sequence(self, seq_id):
        return seq_id in self._seqs

    def length(self, seq_id):
        """Tokens currently cached for ``seq_id`` (reserved slots count)."""
        return self._entry(seq_id).length

    def block_table(self, seq_id):
        """The sequence's block-id table (a copy), in position order."""
        return list(self._entry(seq_id).blocks)

    def utilization(self):
        return self.allocator.utilization()

    def blocks_for(self, num_tokens):
        """Blocks a ``num_tokens``-long prefill needs (admission math)."""
        return -(-int(num_tokens) // self.block_size)

    def pool(self, layer):
        """``layer``'s ``(num_blocks, block_size, H, D)`` K and V pools —
        views of the resident pools, no copy."""
        return self.k_pool[layer], self.v_pool[layer]

    def gather(self, seq_id, layer):
        """One sequence's cached K and V of ``layer`` as ``(length, H,
        D)`` tensors (a copy, for tests and checks)."""
        entry = self._entry(seq_id)
        idx = torch.as_tensor(entry.blocks, device=self.device)
        flat = lambda p: p[layer, idx].reshape(
            (-1, self.num_heads, self.head_dim))[:entry.length]
        return flat(self.k_pool), flat(self.v_pool)

    # -- writes --------------------------------------------------------------
    def _alloc(self, n):
        """``allocator.alloc`` that, on exhaustion with sharing on, first
        releases least-recently-matched index-only prefixes and retries
        once: the index never stands between a live request and free
        memory, and a pool full of live data still raises."""
        try:
            return self.allocator.alloc(n)
        except CacheExhausted:
            if self.prefix is None:
                raise
            released = self.prefix.release(self.allocator, n)
            if released:
                _telemetry.counter("serve.prefix_evictions").inc(released)
                _tracing.emit("serve.prefix_evict", released=released,
                              need=int(n))
            return self.allocator.alloc(n)

    def _check_kv(self, what, k, v):
        want = (self.num_layers, k.shape[1], self.num_heads, self.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(
                f"{what}: k/v must be (num_layers={self.num_layers}, L, "
                f"H={self.num_heads}, D={self.head_dim}); got "
                f"{tuple(k.shape)} / {tuple(v.shape)}")

    def _fill(self, blocks, k, v):
        """Write ``k``/``v`` (``(num_layers, T, H, D)`` on the device)
        into ``blocks`` from their first slot, zero-padded to whole blocks
        (the tail slots are the sequence's own future append slots)."""
        length = k.shape[1]
        nb, bs = len(blocks), self.block_size
        idx = torch.as_tensor(blocks, device=self.device)
        for pool, x in ((self.k_pool, k), (self.v_pool, v)):
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nb * bs - length))
            pool.index_copy_(1, idx, x.reshape(
                self.num_layers, nb, bs, self.num_heads,
                self.head_dim).to(pool.dtype))

    def _account_prefill(self, computed, cached):
        self._prompt_tokens += computed + cached
        self._cached_tokens += cached
        _telemetry.counter("serve.prefill_bytes").inc(
            computed * self._token_bytes)
        if cached:
            _telemetry.counter("serve.prefix_hits").inc()
            _telemetry.counter("serve.prefill_bytes_saved").inc(
                cached * self._token_bytes)
        if self._prompt_tokens:
            _telemetry.gauge("serve.prefix_hit_ratio").set(
                self._cached_tokens / self._prompt_tokens)

    def prefill(self, seq_id, k, v, tokens=None, tenant=None):
        """Bulk-fill a new sequence's blocks in one call.

        ``k``/``v``: ``(num_layers, L, H, D)`` tensors on the cache's
        device.  Allocates exactly ``ceil(L / block_size)`` blocks,
        all-or-nothing — on :class:`CacheExhausted` nothing is
        registered, so the scheduler can retry after an eviction.
        ``tokens`` (the prompt's ids) lets the shared-prefix index learn
        the sequence's full blocks; ``tenant`` is the capacity ledger's
        (not ported yet)."""
        refuse_unported("PagedKVCache.prefill", _LEDGER,
                        tenant=(tenant, None))
        self._check_kv("prefill", k, v)
        length = k.shape[1]
        if length < 1:
            raise ValueError("prefill: empty prompt")
        if tokens is not None and len(tokens) != length:
            raise ValueError(f"prefill: {len(tokens)} tokens for {length} "
                             "K/V positions")
        if seq_id in self._seqs:
            raise MXNetError(f"prefill: sequence {seq_id!r} already cached "
                             "(free it first)")
        blocks = self._alloc(self.blocks_for(length))
        self._fill(blocks, k, v)
        self._seqs[seq_id] = _Sequence(blocks, length)
        if self.prefix is not None and tokens is not None:
            self.prefix.insert(tokens, blocks, self.allocator)
        self._account_prefill(length, 0)

    # -- shared-prefix prefill ------------------------------------------------
    def match_prefix(self, tokens, tenant=None):
        """The longest indexed full-block prefix of ``tokens``, pinned
        (increfed, so pressure eviction cannot reuse it before the
        commit): a :class:`PrefillPlan`, or None with sharing off or on
        a miss.  Every plan must reach :meth:`commit_prefill` or
        :meth:`abandon_plan`."""
        refuse_unported("PagedKVCache.match_prefix", _LEDGER,
                        tenant=(tenant, None))
        if self.prefix is None:
            return None
        blocks, m = self.prefix.match(tokens)
        if not m:
            return None
        self.allocator.incref(blocks)
        return PrefillPlan(blocks, m)

    def gather_plan(self, plan):
        """The pinned prefix's K/V as ``(num_layers, m, H, D)`` tensors
        on the device: the pools indexed with the plan's blocks (nothing
        is read back to the host) — the suffix prefill's operands."""
        m = plan.tokens_matched
        idx = torch.as_tensor(plan.blocks, device=self.device)
        flat = lambda pool: pool[:, idx].reshape(
            (self.num_layers, -1, self.num_heads, self.head_dim))[:, :m]
        return flat(self.k_pool).float(), flat(self.v_pool).float()

    def commit_prefill(self, seq_id, plan, k, v, tokens, tenant=None):
        """Register ``seq_id`` as the pinned prefix plus its computed
        suffix: ``k``/``v`` are the ``(num_layers, S, H, D)`` projections
        of ``tokens[plan.tokens_matched:]``.  All-or-nothing, like
        :meth:`prefill`: on any failure (the suffix's allocation hitting
        exhaustion included) the plan's pins and any fresh blocks are
        released and nothing is registered."""
        refuse_unported("PagedKVCache.commit_prefill", _LEDGER,
                        tenant=(tenant, None))
        m = plan.tokens_matched
        length = m + k.shape[1]
        plan.consume()
        fresh = []
        try:
            if seq_id in self._seqs:
                raise MXNetError(f"commit_prefill: sequence {seq_id!r} "
                                 "already cached (free it first)")
            if length != len(tokens):
                raise ValueError(
                    f"commit_prefill: {len(tokens)} tokens vs {m} matched "
                    f"+ {k.shape[1]} suffix positions")
            if m % self.block_size or k.shape[1] < 1:
                raise ValueError(
                    f"commit_prefill: the matched prefix ({m}) must be "
                    "block-aligned, with a non-empty suffix")
            self._check_kv("commit_prefill", k, v)
            fresh = self._alloc(self.blocks_for(length) - len(plan.blocks))
            self._fill(fresh, k, v)
        except BaseException:
            if fresh:
                self.allocator.free(fresh)
            self.allocator.free(plan.blocks)
            raise
        entry = self._seqs[seq_id] = _Sequence(plan.blocks + fresh, length)
        self.prefix.insert(tokens, entry.blocks, self.allocator)
        self._account_prefill(k.shape[1], m)

    def abandon_plan(self, plan):
        """Release a plan's pins without committing it (the model failed
        between the match and the commit)."""
        plan.consume()
        self.allocator.free(plan.blocks)

    def fork(self, parent_id, child_id, tenant=None):
        """Register ``child_id`` sharing all of ``parent_id``'s blocks
        (one more reference each): N generations from one prompt pay one
        prefill.  Either sibling's next append into a shared partial tail
        block copies it first."""
        refuse_unported("PagedKVCache.fork", _LEDGER, tenant=(tenant, None))
        if child_id in self._seqs:
            raise MXNetError(f"fork: sequence {child_id!r} already cached "
                             "(free it first)")
        parent = self._entry(parent_id)
        self.allocator.incref(parent.blocks)
        self._seqs[child_id] = _Sequence(list(parent.blocks), parent.length)

    def _cow_tail(self, entry):
        """Copy-on-write the entry's shared tail block: a private block
        takes a copy of its slots in every layer's pools (on the device)
        and the original loses one reference.  The sharers keep reading
        the original."""
        old = entry.blocks[-1]
        new = self._alloc(1)[0]
        for pool in (self.k_pool, self.v_pool):
            pool[:, new] = pool[:, old]
        entry.blocks[-1] = new
        self.allocator.free([old])
        self._cow_copies += 1
        _telemetry.counter("serve.cow_copies").inc()

    def reserve(self, seq_id):
        """Reserve the next token's slot (:meth:`reserve_window` of one);
        returns its position."""
        return self.reserve_window(seq_id, 1)[0]

    def reserve_window(self, seq_id, k=1):
        """Reserve ``k`` consecutive slots — the decode step's append (a
        speculative window when ``k > 1``).  A shared partial tail block
        is copied first (appends never write bits a sharer reads).
        All-or-nothing: on :class:`CacheExhausted` the freshly taken
        blocks are released and the length restored, so the caller
        preempts (a finished copy-on-write is kept: same bits, private
        copy).  Returns the reserved positions ``[length, ...,
        length+k-1]``."""
        k = int(k)
        if k < 1:
            raise ValueError(f"reserve_window: k must be >= 1, got {k}")
        entry = self._entry(seq_id)
        base_blocks, base = len(entry.blocks), entry.length
        try:
            if base % self.block_size \
                    and self.allocator.refcount(entry.blocks[-1]) > 1:
                self._cow_tail(entry)
            need = self.blocks_for(base + k) - len(entry.blocks)
            if need > 0:
                entry.blocks.extend(self._alloc(need))
        except CacheExhausted:
            fresh = entry.blocks[base_blocks:]
            if fresh:
                self.allocator.free(fresh)
                del entry.blocks[base_blocks:]
            raise
        entry.length = base + k
        return list(range(base, base + k))

    def truncate(self, seq_id, length):
        """Shrink ``seq_id`` to ``length`` cached tokens (a speculative
        window's rejected tail); whole blocks past the new tail drop one
        reference each."""
        length = int(length)
        if length < 1:
            raise ValueError(f"truncate: length must be >= 1, got {length}")
        entry = self._entry(seq_id)
        if length > entry.length:
            raise MXNetError(
                f"truncate: sequence {seq_id!r} holds {entry.length} "
                f"tokens — cannot grow to {length} (use reserve_window)")
        keep = self.blocks_for(length)
        tail = entry.blocks[keep:]
        if tail:
            self.allocator.free(tail)
            del entry.blocks[keep:]
        entry.length = length

    def window_slots(self, seq_ids, k):
        """The (block id, in-block offset) of each sequence's last ``k``
        reserved slots, as int32 ``(B, k)`` arrays — where the decode
        step writes the window's K/V."""
        bids = np.empty((len(seq_ids), k), np.int32)
        offs = np.empty((len(seq_ids), k), np.int32)
        for i, s in enumerate(seq_ids):
            entry = self._entry(s)
            for j in range(k):
                pos = entry.length - k + j
                bids[i, j] = entry.blocks[pos // self.block_size]
                offs[i, j] = pos % self.block_size
        return bids, offs

    def free_sequence(self, seq_id):
        """Evict: drop one reference per block (contents stay until
        reuse).  A block only this sequence held returns to the free
        list; one the index or a sibling shares survives.  Returns the
        number of references released."""
        entry = self._seqs.pop(seq_id, None)
        if entry is None:
            return 0
        self.allocator.free(entry.blocks)
        return len(entry.blocks)

    def exclusive_blocks(self, seq_id):
        """How many of the sequence's blocks only it holds (refcount 1):
        what freeing it would return to the pool."""
        entry = self._seqs.get(seq_id)
        if entry is None:
            return 0
        refs = self.allocator.refcounts()
        return sum(1 for b in entry.blocks if refs.get(b) == 1)

    def drop_prefix_cache(self):
        """Release every prefix-index reference; returns the number of
        index entries dropped (0 with sharing off).  With every sequence
        freed too, ``allocator.refcounts()`` is then empty."""
        if self.prefix is None:
            return 0
        return self.prefix.drop_all(self.allocator)

    def prefix_stats(self):
        """``{sharing, prompt_tokens, cached_tokens, hit_ratio,
        prefill_bytes, prefill_bytes_saved, cow_copies}``, plus the
        index's ``{nodes, lookups, hits, tokens_matched, evictions}``
        with sharing on."""
        out = {
            "sharing": self.prefix is not None,
            "prompt_tokens": self._prompt_tokens,
            "cached_tokens": self._cached_tokens,
            "hit_ratio": (self._cached_tokens / self._prompt_tokens
                          if self._prompt_tokens else 0.0),
            "prefill_bytes": ((self._prompt_tokens - self._cached_tokens)
                              * self._token_bytes),
            "prefill_bytes_saved": self._cached_tokens * self._token_bytes,
            "cow_copies": self._cow_copies,
        }
        if self.prefix is not None:
            out.update(self.prefix.stats())
        return out

    # -- reads: the paged kernel's operands ----------------------------------
    def batch_tables(self, seq_ids):
        """The decode batch's block tables: int32 ``(B, NBpad)`` ids plus
        int32 ``(B,)`` true lengths — what the paged kernel walks.

        Rows are padded with block 0 past each sequence's real blocks
        (valid pool indices: the kernel's length mask excludes them
        exactly), and ``NBpad`` is the batch max rounded up to the
        reference's bucket — a power of two up to 4 blocks, then
        multiples of 4 — so a captured decode step sees a bounded set of
        shapes."""
        tables = [(self._entry(s).blocks, self._entry(s).length)
                  for s in seq_ids]
        nb = max(len(blocks) for blocks, _ in tables)
        nbpad = _next_pow2(nb) if nb <= 4 else -(-nb // 4) * 4
        ids = np.zeros((len(tables), nbpad), np.int32)
        for i, (blocks, _) in enumerate(tables):
            ids[i, :len(blocks)] = blocks
        lengths = np.array([length for _, length in tables], np.int32)
        return ids, lengths

    def audit(self):
        """Check the cache's bookkeeping against the allocator: every
        table covers its length, and every held block's reference count
        is exactly the number of tables that hold it plus one if the
        prefix index holds it (so no reference leaks and none is
        missing).  Returns the allocator's report plus ``sequences`` and
        ``index_refs``; raises :class:`MXNetError` on any violation."""
        expected = {}
        for seq_id, entry in self._seqs.items():
            if len(entry.blocks) != self.blocks_for(entry.length):
                raise MXNetError(
                    f"PagedKVCache.audit: {seq_id!r} holds "
                    f"{len(entry.blocks)} blocks for {entry.length} tokens")
            for bid in entry.blocks:
                expected[bid] = expected.get(bid, 0) + 1
        indexed = self.prefix.block_ids() if self.prefix is not None else []
        for bid in indexed:
            expected[bid] = expected.get(bid, 0) + 1
        report = self.allocator.audit(expected)
        report["sequences"] = len(self._seqs)
        report["index_refs"] = len(indexed)
        return report
