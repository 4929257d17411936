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
  the device).  The host layer loop of the engine writes each layer
  through :meth:`PagedKVCache.write_batch` (one token a sequence) or
  :meth:`PagedKVCache.write_window` (a speculative window), and its
  dense-gather arm reads :meth:`PagedKVCache.gather_batch`; both act on
  the pools where they live, on the card when the cache is there.
- **Shared prefixes** (``share_prefix``): full blocks of prompt tokens
  are indexed (``serving/prefix_cache.py``); a later prompt with the
  same leading blocks pins them (:meth:`PagedKVCache.match_prefix`),
  reads their K/V on the device (:meth:`PagedKVCache.gather_plan`),
  computes only its suffix and registers both
  (:meth:`PagedKVCache.commit_prefill`).  A shared partial tail block is
  copied before an append writes into it (copy-on-write, one block in
  every layer's pools, on the device).

- **Capacity ledger** (``serving/accounting.py``): every reference is
  attributed to a holder — ``seq:<id>`` with its tenant, the prefix
  index, or a pinned plan (``plan:<n>``) — under the allocator's lock;
  :meth:`PagedKVCache.audit` checks the accounting identity,
  :meth:`PagedKVCache.capacity_stats` is what the server publishes, and
  each genuine :class:`CacheExhausted` (and each prefix pressure
  eviction) leaves a forensic record naming every holder
  (:meth:`PagedKVCache.forensic_records`; ``forensics=`` a path prefix
  persists them as ``<prefix>-capacity.json``).

Bookkeeping belongs to the server's step thread; the allocator alone is
locked, as the scheduler may size requests from other threads.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from ..base import MXNetError
from .. import device as _device
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from . import accounting as _accounting
from .accounting import INDEX_TENANT, CapacityLedger
from .prefix_cache import PrefixIndex, prefix_sharing_enabled
from .tenancy import DEFAULT_TENANT

__all__ = ["CacheExhausted", "BlockAllocator", "PagedKVCache",
           "PrefillPlan", "prefix_sharing_enabled"]

# ledger holder ids of pinned prefill plans, unique in the process
_plan_ids = itertools.count()


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
    failure.

    Every reference is also attributed in :attr:`ledger` (a
    :class:`~tpu_mx_torch.serving.accounting.CapacityLedger` counting
    ``block_bytes`` a block) to the ``holder=`` a caller names on
    ``alloc``/``incref``/``free`` (None files it under ``_anon``), under
    this allocator's lock, next to the refcount it mirrors."""

    def __init__(self, num_blocks, block_bytes=1):
        if int(num_blocks) < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._lock = threading.Lock()
        # LIFO: recently freed blocks are handed out first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._refs = {}         # held block id -> reference count
        self.ledger = CapacityLedger(block_bytes)

    def alloc(self, n=1, holder=None):
        """``n`` block ids at one reference each, attributed to
        ``holder``, or raise :class:`CacheExhausted` (free list
        untouched)."""
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
            self.ledger.hold(ids, holder)
            self.ledger.note_used(len(self._refs))
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
        with self._lock:
            self._check_held(block_ids, "incref")
            for bid in block_ids:
                self._refs[bid] += 1
            self.ledger.hold(block_ids, holder)

    def free(self, block_ids, holder=None):
        """Drop one reference per block; a block at zero returns to the
        free list (its contents stay in place for the next owner to
        overwrite).  Freeing an unheld block, or a reference ``holder``
        does not hold, raises and frees nothing."""
        with self._lock:
            self._check_held(block_ids, "free")
            # the ledger checks the attribution before a refcount moves
            self.ledger.release(block_ids, holder)
            for bid in block_ids:
                self._refs[bid] -= 1
                if self._refs[bid] == 0:
                    del self._refs[bid]
                    self._free.append(bid)

    def reassign(self, block_ids, src, dst):
        """Move the attribution of one reference per block from holder
        ``src`` to ``dst``, refcounts untouched (a committed plan's pins
        become its sequence's references)."""
        with self._lock:
            self._check_held(block_ids, "reassign")
            self.ledger.transfer(block_ids, src, dst)

    def describe(self, holder, kind=None, tenant=None, pinned=None):
        """Attach attribution metadata to a ledger holder."""
        with self._lock:
            self.ledger.describe(holder, kind=kind, tenant=tenant,
                                 pinned=pinned)

    def _fragmentation_locked(self):
        """1 - (largest contiguous free-id run / free blocks); 0 with an
        empty free list.  A locality signal, not a failure predictor."""
        if not self._free:
            return 0.0
        free = sorted(self._free)
        best = run = 1
        for a, b in zip(free, free[1:]):
            run = run + 1 if b == a + 1 else 1
            best = max(best, run)
        return 1.0 - best / len(free)

    def fragmentation(self):
        """Free-list fragmentation in [0, 1]."""
        with self._lock:
            return self._fragmentation_locked()

    def capacity_snapshot(self):
        """One consistent read of the pool's capacity state: counts,
        fragmentation, high watermark, every ledger holder and the
        per-tenant attribution."""
        with self._lock:
            holders, tenants = self.ledger.views()
            return {
                "num_blocks": self.num_blocks,
                "block_bytes": self.ledger.block_bytes,
                "used_blocks": len(self._refs),
                "free_blocks": len(self._free),
                "total_refs": sum(self._refs.values()),
                "high_watermark_blocks": self.ledger.high_watermark,
                "fragmentation": self._fragmentation_locked(),
                "holders": holders,
                "tenants": tenants,
            }

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
        pool exactly; given ``expected_refs`` (``{block_id: count}`` of
        the references the caller knows of), that every held block's
        count is exactly that; and the ledger's accounting identity (per
        block, attributed references == refcount; per tenant, amortized
        bytes sum exactly to used bytes).  Returns the ledger's report
        (``used_blocks``, ``used_bytes``, ``total_refs``, ``holders``,
        ``tenants``, ...) plus ``num_blocks``, ``free_blocks`` and
        ``fragmentation``, or raises :class:`MXNetError`."""
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
            report = self.ledger.audit(dict(self._refs))
            report.update(num_blocks=self.num_blocks,
                          free_blocks=len(free),
                          fragmentation=self._fragmentation_locked())
            return report


class _Sequence:
    __slots__ = ("blocks", "length", "holder", "tenant")

    def __init__(self, blocks, length, holder, tenant=DEFAULT_TENANT):
        self.blocks = blocks
        self.length = length
        self.holder = holder    # the sequence's ledger holder id
        self.tenant = tenant


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
    prefill recomputes it.  ``forensics`` (a path prefix) persists the
    capacity forensic records as ``<forensics>-capacity.json``."""

    def __init__(self, num_layers, num_heads, head_dim, block_size=16,
                 num_blocks=256, dtype=torch.float32, storage="host",
                 share_prefix=None, forensics=None, device="cuda"):
        if storage not in ("host", "device"):
            raise ValueError(f"storage must be 'host' or 'device', "
                             f"got {storage!r}")
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
        # per-token K/V footprint across all layers, both pools; a block's
        # is the ledger's unit
        self._token_bytes = (self.num_layers * self.num_heads * self.head_dim
                             * 2 * torch.empty((), dtype=dtype).element_size())
        self.allocator = BlockAllocator(
            num_blocks, block_bytes=self._token_bytes * self.block_size)
        shape = (self.num_layers, self.allocator.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        # the capacity forensic ring, persisted (rolling, atomic) when a
        # path prefix is armed
        self._forensics = deque(maxlen=256)
        self._forensics_path = (f"{forensics}-capacity.json"
                                if forensics else None)
        self._forensics_dumped = None   # monotonic time of the last dump
        self._seqs = {}
        self._plans = {}            # pinned plan holder -> its blocks
        self.prefix = PrefixIndex(self.block_size) if share_prefix else None
        self._prompt_tokens = 0     # tokens asked for across prefills
        self._cached_tokens = 0     # of those, served from the index
        self._cow_copies = 0

    @property
    def device_resident(self):
        """True when the pools live on the card."""
        return self.device.type == "cuda"

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

    def num_sequences(self):
        """How many sequences hold blocks."""
        return len(self._seqs)

    def stats(self):
        """``{sequences, used_blocks, free_blocks, utilization}``."""
        return {"sequences": len(self._seqs),
                "used_blocks": self.allocator.used,
                "free_blocks": self.allocator.available,
                "utilization": self.allocator.utilization()}

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
    def _alloc(self, n, holder=None):
        """``allocator.alloc`` that, on exhaustion with sharing on, first
        releases least-recently-matched index-only prefixes and retries
        once: the index never stands between a live request and free
        memory, and a pool full of live data still raises.  The pressure
        eviction and the genuine exhaustion each leave a forensic
        record."""
        try:
            return self.allocator.alloc(n, holder=holder)
        except CacheExhausted:
            if self.prefix is None:
                self._record_forensic("exhaustion", need=n)
                raise
            released = self.prefix.release(self.allocator, n)
            if released:
                _telemetry.counter("serve.prefix_evictions").inc(released)
                _tracing.emit("serve.prefix_evict", released=released,
                              need=int(n))
                self._record_forensic("pressure_evict", need=n,
                                      released=released)
            try:
                return self.allocator.alloc(n, holder=holder)
            except CacheExhausted:
                self._record_forensic("exhaustion", need=n)
                raise

    def _record_forensic(self, kind, need, released=0):
        """Snapshot who holds the pool at a capacity event — every holder
        with its tenant, blocks, pinned/shared state and age — into the
        bounded ring, and persist the ring when a path is armed (at most
        once a second; :meth:`flush_forensics` forces it).  A genuine
        exhaustion also lands on the flight recorder, naming the file.
        Best effort: a failed dump is counted, and never turns
        backpressure into a crash."""
        snap = self.allocator.capacity_snapshot()
        rec = {"kind": kind, "ts": time.time(), "need": int(need),
               "free": snap["free_blocks"], "released": int(released),
               "pool": {k: snap[k] for k in
                        ("num_blocks", "block_bytes", "used_blocks",
                         "total_refs", "high_watermark_blocks",
                         "fragmentation")},
               "holders": snap["holders"], "tenants": snap["tenants"]}
        self._forensics.append(rec)
        if kind == "exhaustion":
            _tracing.emit("serve.capacity_exhausted", need=int(need),
                          free=int(snap["free_blocks"]),
                          holders=len(snap["holders"]),
                          forensic=self._forensics_path or "")
        now = time.monotonic()
        if self._forensics_path and (self._forensics_dumped is None
                                     or now - self._forensics_dumped
                                     >= 1.0):
            self._forensics_dumped = now
            try:
                _accounting.dump_forensics(self._forensics_path,
                                           self._forensics)
            except Exception:  # noqa: BLE001 — forensics are best effort
                _telemetry.counter("serve.forensic_dump_failures").inc()

    def forensic_records(self):
        """The in-memory capacity forensic ring (newest last)."""
        return list(self._forensics)

    def flush_forensics(self):
        """Write the forensic ring to disk now (past the rate limit);
        returns the path, or None (unarmed or empty ring)."""
        if not self._forensics_path or not self._forensics:
            return None
        self._forensics_dumped = time.monotonic()
        return _accounting.dump_forensics(self._forensics_path,
                                          self._forensics)

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
        attribution (default: the single-tenant default)."""
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
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        holder = f"seq:{seq_id}"
        blocks = self._alloc(self.blocks_for(length), holder=holder)
        self.allocator.describe(holder, kind="sequence", tenant=tenant)
        self._fill(blocks, k, v)
        self._seqs[seq_id] = _Sequence(blocks, length, holder, tenant)
        if self.prefix is not None and tokens is not None:
            self.prefix.insert(tokens, blocks, self.allocator)
        self._account_prefill(length, 0)

    # -- shared-prefix prefill ------------------------------------------------
    def match_prefix(self, tokens, tenant=None):
        """The longest indexed full-block prefix of ``tokens``, pinned
        (increfed, so pressure eviction cannot reuse it before the
        commit): a :class:`PrefillPlan`, or None with sharing off or on
        a miss.  Every plan must reach :meth:`commit_prefill` or
:meth:`abandon_plan`.  The pins are ledgered as a ``plan`` holder
        of ``tenant``."""
        if self.prefix is None:
            return None
        blocks, m = self.prefix.match(tokens)
        if not m:
            return None
        holder = f"plan:{next(_plan_ids)}"
        self.allocator.incref(blocks, holder=holder)
        self._plans[holder] = list(blocks)
        self.allocator.describe(
            holder, kind="plan",
            tenant=DEFAULT_TENANT if tenant is None else str(tenant),
            pinned=True)
        return PrefillPlan(blocks, m, holder=holder)

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
        released and nothing is registered.  On success the plan's pinned
        attribution becomes the sequence's."""
        m = plan.tokens_matched
        length = m + k.shape[1]
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        holder = f"seq:{seq_id}"
        plan.consume()
        self._plans.pop(plan.holder, None)
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
            fresh = self._alloc(self.blocks_for(length) - len(plan.blocks),
                                holder=holder)
            self.allocator.describe(holder, kind="sequence", tenant=tenant)
            self._fill(fresh, k, v)
            # the pins become the sequence's references (refcounts kept)
            self.allocator.reassign(plan.blocks, plan.holder, holder)
        except BaseException:
            if fresh:
                self.allocator.free(fresh, holder=holder)
            self.allocator.free(plan.blocks, holder=plan.holder)
            raise
        entry = self._seqs[seq_id] = _Sequence(plan.blocks + fresh, length,
                                               holder, tenant)
        self.prefix.insert(tokens, entry.blocks, self.allocator)
        self._account_prefill(k.shape[1], m)

    def abandon_plan(self, plan):
        """Release a plan's pins without committing it (the model failed
        between the match and the commit)."""
        plan.consume()
        self._plans.pop(plan.holder, None)
        self.allocator.free(plan.blocks, holder=plan.holder)

    def fork(self, parent_id, child_id, tenant=None):
        """Register ``child_id`` sharing all of ``parent_id``'s blocks
        (one more reference each): N generations from one prompt pay one
        prefill.  Either sibling's next append into a shared partial tail
        block copies it first.  ``tenant`` defaults to the parent's."""
        if child_id in self._seqs:
            raise MXNetError(f"fork: sequence {child_id!r} already cached "
                             "(free it first)")
        parent = self._entry(parent_id)
        tenant = parent.tenant if tenant is None else str(tenant)
        holder = f"seq:{child_id}"
        self.allocator.incref(parent.blocks, holder=holder)
        self.allocator.describe(holder, kind="sequence", tenant=tenant)
        self._seqs[child_id] = _Sequence(list(parent.blocks), parent.length,
                                         holder, tenant)

    def _cow_tail(self, entry):
        """Copy-on-write the entry's shared tail block: a private block
        takes a copy of its slots in every layer's pools (on the device)
        and the original loses one reference.  The sharers keep reading
        the original."""
        old = entry.blocks[-1]
        new = self._alloc(1, holder=entry.holder)[0]
        for pool in (self.k_pool, self.v_pool):
            pool[:, new] = pool[:, old]
        entry.blocks[-1] = new
        self.allocator.free([old], holder=entry.holder)
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
                entry.blocks.extend(self._alloc(need, holder=entry.holder))
        except CacheExhausted:
            fresh = entry.blocks[base_blocks:]
            if fresh:
                self.allocator.free(fresh, holder=entry.holder)
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
            self.allocator.free(tail, holder=entry.holder)
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
        self.allocator.free(entry.blocks, holder=entry.holder)
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

    # -- the host layer loop's writes and reads ------------------------------
    def _slot_index(self, bids, offs):
        """``(block ids, offsets)`` as two int64 index tensors on the
        pools' device, in one copy."""
        idx = torch.from_numpy(np.stack([np.asarray(bids, np.int64)
                                         .reshape(-1),
                                         np.asarray(offs, np.int64)
                                         .reshape(-1)]))
        return tuple(idx.to(self.device))

    def _write_rows(self, layer, bids, offs, k, v):
        idx = self._slot_index(bids, offs)
        shape = (-1, self.num_heads, self.head_dim)
        self.k_pool[layer].index_put_(idx, k.reshape(shape)
                                      .to(self.k_pool.dtype))
        self.v_pool[layer].index_put_(idx, v.reshape(shape)
                                      .to(self.v_pool.dtype))

    def write(self, seq_id, layer, k, v):
        """Write one layer's K/V projection (``(num_heads, head_dim)``)
        into the sequence's newest reserved slot."""
        self.write_batch([seq_id], layer, k[None], v[None])

    def write_batch(self, seq_ids, layer, k, v):
        """Write one layer's K/V for a decode batch (``(B, num_heads,
        head_dim)``) into each sequence's newest reserved slot: one
        ``index_put_`` a pool."""
        bids, offs = self.window_slots(seq_ids, 1)
        self._write_rows(layer, bids, offs, k, v)

    def write_window(self, seq_ids, layer, k, v):
        """Write one layer's K/V for a draft window (``(B, K, num_heads,
        head_dim)``) into each sequence's last ``K`` reserved slots: one
        ``index_put_`` a pool for the whole ``B*K`` window."""
        bids, offs = self.window_slots(seq_ids, k.shape[1])
        self._write_rows(layer, bids, offs, k, v)

    def gather_batch(self, seq_ids, layer):
        """Padded dense K/V of ``layer`` for a decode batch: a ``(B, Lpad,
        H, D)`` pair on the pools' device, ``Lpad`` the batch's most
        blocks times the block size, plus the int32 ``(B,)`` true lengths
        (a tensor there too).  One gather a pool; each table is padded
        with block 0, whose finite contents past a row's length the
        attention mask excludes exactly."""
        tables = [(self._entry(s).blocks, self._entry(s).length)
                  for s in seq_ids]
        b = len(tables)
        nbmax = max(len(blocks) for blocks, _ in tables)
        host = np.zeros((b, nbmax + 1), np.int64)
        for i, (blocks, length) in enumerate(tables):
            host[i, :len(blocks)] = blocks
            host[i, -1] = length
        dev = torch.from_numpy(host).to(self.device)
        ids, lengths = dev[:, :-1].reshape(-1), dev[:, -1].to(torch.int32)
        shape = (b, nbmax * self.block_size, self.num_heads, self.head_dim)
        return (self.k_pool[layer][ids].reshape(shape),
                self.v_pool[layer][ids].reshape(shape), lengths)

    def pools(self):
        """Every layer's K and V pool, as two lists of views of the
        resident pools: the operands the reference's fused decode program
        consumes (the port's fused step writes them in place)."""
        return ([self.k_pool[i] for i in range(self.num_layers)],
                [self.v_pool[i] for i in range(self.num_layers)])

    def adopt_pools(self, k_pools, v_pools):
        """Install per-layer pool contents, the other half of
        :meth:`pools`: a layer whose tensor is already the resident view
        is left as it is, any other is copied in."""
        if (len(k_pools) != self.num_layers
                or len(v_pools) != self.num_layers):
            raise ValueError(
                f"adopt_pools: expected {self.num_layers} pool pairs, "
                f"got {len(k_pools)}/{len(v_pools)}")
        for pool, news in ((self.k_pool, k_pools), (self.v_pool, v_pools)):
            for i, t in enumerate(news):
                if t.data_ptr() != pool[i].data_ptr():
                    pool[i].copy_(t)

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
        table covers its length, every held block's reference count is
        exactly the number of tables and pinned plans that hold it plus
        one if the prefix index holds it (so no reference leaks and none
        is missing), and
        the ledger's accounting identity holds.  Returns the allocator's
        report plus ``sequences`` and ``index_refs``; raises
        :class:`MXNetError` on any violation.  With every sequence freed
        and the index dropped it shows zero used blocks and no
        tenants."""
        expected = {}
        for seq_id, entry in self._seqs.items():
            if len(entry.blocks) != self.blocks_for(entry.length):
                raise MXNetError(
                    f"PagedKVCache.audit: {seq_id!r} holds "
                    f"{len(entry.blocks)} blocks for {entry.length} tokens")
            for bid in entry.blocks:
                expected[bid] = expected.get(bid, 0) + 1
        indexed = self.prefix.block_ids() if self.prefix is not None else []
        for bid in indexed + [b for bs in self._plans.values() for b in bs]:
            expected[bid] = expected.get(bid, 0) + 1
        report = self.allocator.audit(expected)
        report["sequences"] = len(self._seqs)
        report["index_refs"] = len(indexed)
        return report

    def capacity_stats(self):
        """The live capacity view the server publishes as gauges and hands
        the scheduler as ``capacity_signal``: pool geometry, used and
        high-watermark bytes, fragmentation, pinned blocks (plan
        holders), the prefix index's amortized bytes, the optimistic
        reclaimable-under-pressure bound and the per-tenant
        attribution."""
        snap = self.allocator.capacity_snapshot()
        snap["block_size"] = self.block_size
        snap["used_bytes"] = snap["used_blocks"] * snap["block_bytes"]
        snap["high_watermark_bytes"] = (snap["high_watermark_blocks"]
                                        * snap["block_bytes"])
        snap["pinned_blocks"] = sum(h["blocks"] for h in snap["holders"]
                                    if h["pinned"])
        idx = snap["tenants"].get(INDEX_TENANT)
        snap["index_bytes"] = idx["bytes_amortized"] if idx else 0.0
        snap["reclaimable_blocks"] = (self.prefix.reclaimable(self.allocator)
                                      if self.prefix is not None else 0)
        return snap
