"""Paged KV cache: fixed-size blocks, a free-list allocator, block tables.

The port of ``tpu_mx/serving/kv_cache.py``'s paged core:

- **Blocks**: K and V live in one preallocated pool per layer on the
  device, ``k_pool[layer]`` shaped ``(num_blocks, block_size, H, D)``.
  A sequence's cache is a list of block ids — its **block table** —
  plus a length; logically contiguous, physically scattered.
- **Free-list allocator**: :class:`BlockAllocator` hands out block ids
  from a LIFO free list under one lock.  Exhaustion raises
  :class:`CacheExhausted` — the scheduler's backpressure signal, never
  an allocation that runs the card out of memory.
- **O(1) append**: a decode step reserves one slot per sequence
  (:meth:`PagedKVCache.reserve_window`) — at most one free-list pop —
  and the model's step writes each layer's K/V straight into the pool
  at :meth:`PagedKVCache.window_slots` (``index_put_`` on the device).

Every block has exactly one owner here: the reference's prefix sharing,
refcounts, copy-on-write and capacity-ledger forensics wait for a later
slice (ROADMAP).  Bookkeeping belongs to the server's step thread; the
allocator alone is locked, as the scheduler may size requests from other
threads.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import MXNetError
from .. import device as _device
from .. import telemetry as _telemetry

__all__ = ["CacheExhausted", "BlockAllocator", "PagedKVCache"]


def _next_pow2(n):
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


class CacheExhausted(MXNetError):
    """The block pool has no room for this allocation.  This is the
    BACKPRESSURE signal, not an error to crash on: the scheduler catches
    it and requeues (decode append) or defers admission (prefill)."""


class BlockAllocator:
    """LIFO free-list allocator over ``num_blocks`` fixed-size blocks.

    ``alloc(n)`` is all-or-nothing: either all ``n`` ids are handed out
    or :class:`CacheExhausted` is raised and the free list is untouched.
    ``free`` rejects ids the allocator did not hand out (a double free
    would corrupt the pool silently; loud is the only acceptable
    failure)."""

    def __init__(self, num_blocks):
        if int(num_blocks) < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._lock = threading.Lock()
        # LIFO: recently freed blocks are handed out first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._held = set()

    def alloc(self, n=1):
        """``n`` block ids, or raise :class:`CacheExhausted` (free list
        untouched)."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                raise CacheExhausted(
                    f"KV cache exhausted: need {n} block(s), "
                    f"{len(self._free)}/{self.num_blocks} free — "
                    "backpressure, not OOM: requeue or reject")
            ids = [self._free.pop() for _ in range(n)]
            self._held.update(ids)
        return ids

    def free(self, block_ids):
        """Return blocks to the free list (contents stay in place for the
        next owner to overwrite).  Freeing an unheld block raises and
        frees nothing."""
        with self._lock:
            for bid in block_ids:
                if bid not in self._held:
                    raise MXNetError(
                        f"BlockAllocator.free: block {bid} is not held "
                        "(double free or foreign id) — the pool would be "
                        "silently corrupted")
            for bid in block_ids:
                self._held.discard(bid)
                self._free.append(bid)

    def held(self):
        """The held block ids (a copy)."""
        with self._lock:
            return set(self._held)

    @property
    def available(self):
        """Blocks currently on the free list."""
        with self._lock:
            return len(self._free)

    def utilization(self):
        """Used fraction of the pool, in [0, 1]."""
        with self._lock:
            return len(self._held) / self.num_blocks

    def audit(self):
        """Check that the free list and the held set partition the pool
        exactly; returns ``{num_blocks, used_blocks, free_blocks}`` or
        raises :class:`MXNetError`."""
        with self._lock:
            free = set(self._free)
            if len(free) != len(self._free):
                raise MXNetError("BlockAllocator.audit: a block is on the "
                                 "free list twice")
            if free & self._held:
                raise MXNetError(f"BlockAllocator.audit: blocks "
                                 f"{sorted(free & self._held)} are both "
                                 "free and held")
            if len(free) + len(self._held) != self.num_blocks:
                raise MXNetError("BlockAllocator.audit: free + held != "
                                 f"{self.num_blocks} blocks")
            return {"num_blocks": self.num_blocks,
                    "used_blocks": len(self._held),
                    "free_blocks": len(free)}


class _Sequence:
    __slots__ = ("blocks", "length")

    def __init__(self, blocks, length):
        self.blocks = blocks
        self.length = length


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
    on write."""

    def __init__(self, num_layers, num_heads, head_dim, block_size=16,
                 num_blocks=256, dtype=torch.float32, device="cuda"):
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
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

    # -- writes --------------------------------------------------------------
    def prefill(self, seq_id, k, v):
        """Bulk-fill a new sequence's blocks in one call.

        ``k``/``v``: ``(num_layers, L, H, D)`` tensors on the cache's
        device.  Allocates exactly ``ceil(L / block_size)`` blocks,
        all-or-nothing — on :class:`CacheExhausted` nothing is
        registered, so the scheduler can retry after an eviction."""
        want = (self.num_layers, k.shape[1], self.num_heads, self.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise ValueError(
                f"prefill: k/v must be (num_layers={self.num_layers}, L, "
                f"H={self.num_heads}, D={self.head_dim}); got "
                f"{tuple(k.shape)} / {tuple(v.shape)}")
        length = k.shape[1]
        if length < 1:
            raise ValueError("prefill: empty prompt")
        if seq_id in self._seqs:
            raise MXNetError(f"prefill: sequence {seq_id!r} already cached "
                             "(free it first)")
        blocks = self.allocator.alloc(self.blocks_for(length))
        nb, bs = len(blocks), self.block_size
        idx = torch.as_tensor(blocks, device=self.device)
        for pool, x in ((self.k_pool, k), (self.v_pool, v)):
            # zero-padded to whole blocks: the tail slots are this
            # sequence's own future append slots
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nb * bs - length))
            pool.index_copy_(1, idx, x.reshape(
                self.num_layers, nb, bs, self.num_heads,
                self.head_dim).to(pool.dtype))
        self._seqs[seq_id] = _Sequence(blocks, length)
        _telemetry.counter("serve.prefill_bytes").inc(
            length * self._token_bytes)

    def reserve_window(self, seq_id, k=1):
        """Reserve ``k`` consecutive slots — the decode step's append.
        All-or-nothing: on :class:`CacheExhausted` the sequence is
        unchanged and the caller preempts.  Returns the reserved
        positions ``[length, ..., length+k-1]``."""
        k = int(k)
        if k < 1:
            raise ValueError(f"reserve_window: k must be >= 1, got {k}")
        entry = self._entry(seq_id)
        need = self.blocks_for(entry.length + k) - len(entry.blocks)
        if need > 0:
            entry.blocks.extend(self.allocator.alloc(need))
        base = entry.length
        entry.length = base + k
        return list(range(base, base + k))

    def truncate(self, seq_id, length):
        """Shrink ``seq_id`` to ``length`` cached tokens; whole blocks past
        the new tail go back to the free list."""
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
        """Evict: the sequence's blocks go back to the free list (contents
        stay until reuse).  Returns the number of blocks released."""
        entry = self._seqs.pop(seq_id, None)
        if entry is None:
            return 0
        self.allocator.free(entry.blocks)
        return len(entry.blocks)

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
        sequence's blocks are held, no block has two owners, every held
        block has an owner, and every table covers its length.  Returns
        the allocator's report plus ``sequences``; raises
        :class:`MXNetError` on any violation."""
        report = self.allocator.audit()
        held = self.allocator.held()
        owned = set()
        for seq_id, entry in self._seqs.items():
            if len(entry.blocks) != self.blocks_for(entry.length):
                raise MXNetError(
                    f"PagedKVCache.audit: {seq_id!r} holds "
                    f"{len(entry.blocks)} blocks for {entry.length} tokens")
            for bid in entry.blocks:
                if bid in owned:
                    raise MXNetError(f"PagedKVCache.audit: block {bid} has "
                                     "two owners")
                owned.add(bid)
        if owned != held:
            raise MXNetError(
                f"PagedKVCache.audit: held blocks without an owner "
                f"{sorted(held - owned)}, owned blocks not held "
                f"{sorted(owned - held)}")
        report["sequences"] = len(self._seqs)
        return report
