"""EngineCore: model + paged cache = prefill/decode compute (no policy).

The port of ``tpu_mx/serving/engine.py``.  One engine owns one
:class:`~tpu_mx_torch.serving.kv_cache.PagedKVCache` on the model's
device and runs two operations for the server:

- :meth:`EngineCore.prefill` — one sequence's prompt (plus any tokens
  it already committed before a preemption): the model computes every
  layer's K/V through the flash kernel, the cache is bulk-filled in one
  call, and the first generated token comes back.
- :meth:`EngineCore.decode` — ONE decode step for a whole batch: reserve
  each sequence's slot, then run :meth:`TinyLM.decode_step`, the whole
  step on the device with the paged kernel.  Sequences whose slot
  reservation hits :class:`CacheExhausted` are returned as *preempted*
  (the scheduler requeues them); the rest of the batch proceeds.

Greedy decoding, one token per step: the reference's speculative
window, non-greedy sampling and its self-check audits are not ported
yet.  Non-finite logits raise :class:`NumericDivergence`.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..base import NumericDivergence, refuse_unported
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from .attention import decode_arm
from .kv_cache import CacheExhausted, PagedKVCache

__all__ = ["EngineCore"]


class EngineCore:
    """See module docstring.  ``model`` is a
    :class:`~tpu_mx_torch.serving.model.TinyLM`; the cache geometry and
    device come from it.  ``dtype`` is the KV pool's storage type.
    ``share_prefix``, ``forensics``, ``warm_batch`` and ``greedy`` must
    keep the reference's defaults: prefix sharing, forensics, warm-up
    and non-greedy sampling are not ported yet (ROADMAP A12)."""

    def __init__(self, model, block_size=16, num_blocks=256,
                 dtype=torch.float32, share_prefix=None, forensics=None,
                 warm_batch=None, greedy=True):
        refuse_unported("EngineCore", "A12", share_prefix=(share_prefix, None),
                        forensics=(forensics, None),
                        warm_batch=(warm_batch, None), greedy=(greedy, True))
        self.model = model
        self.cache = PagedKVCache(
            model.num_layers, model.num_heads, model.head_dim,
            block_size=block_size, num_blocks=num_blocks, dtype=dtype,
            device=model.device)
        _tracing.emit("serve.decode_path",
                      path=decode_arm(model.head_dim, torch.float32,
                                      self.cache.k_pool.dtype,
                                      device_type=self.cache.k_pool.device
                                      .type),
                      device=str(model.device), storage="device",
                      fused=True, spec_window=1, sampling="greedy")

    # -- prefill -------------------------------------------------------------
    def prefill(self, req):
        """Run ``req``'s prompt plus its committed tokens, fill its cache
        blocks, and return the next (greedy) token.  A requeued request
        is rebuilt in this one call: K/V at every position is a function
        of the tokens before it only.  :class:`CacheExhausted`
        propagates with the cache unchanged (the scheduler defers)."""
        t0 = time.perf_counter()
        tokens = req.prompt + req.tokens
        k, v, logits = self.model.prefill(tokens)
        self.cache.prefill(req.id, k, v)
        top = torch.stack([logits.abs().amax(), logits.argmax().float()])
        health, first = top.cpu().tolist()
        if not math.isfinite(health):
            self.cache.free_sequence(req.id)
            raise NumericDivergence(
                f"serving: non-finite logits in prefill of {req.id} "
                f"(health={health})")
        if req.tokens:
            _telemetry.counter("serve.replay_requests").inc()
            _telemetry.counter("serve.replay_tokens").inc(len(req.tokens))
        _tracing.emit("serve.prefill", request=req.id,
                      tokens=len(req.prompt), replayed=len(req.tokens),
                      t0=t0, t1=time.perf_counter())
        return int(first)

    # -- decode --------------------------------------------------------------
    def decode(self, items):
        """One decode STEP for each ``(req, last_token)`` in ``items``.

        Returns ``(results, preempted)``: ``results`` maps request id →
        ``[token]`` for every sequence that decoded; ``preempted`` lists
        the requests evicted to make room.  Preemption picks, among the
        members not yet reserved this step, the one with the lowest
        tenant weight, then the most blocks, then the youngest; the
        reservation is retried after each eviction, so the oldest live
        sequence always makes progress (``items`` arrive in admission
        order)."""
        live, preempted = [], []
        remaining = [(req, int(last)) for req, last in items]
        while remaining:
            req, last = remaining.pop(0)
            while True:
                try:
                    self.cache.reserve_window(req.id, 1)
                    live.append((req, last))
                    break
                except CacheExhausted:
                    victim = (remaining.pop(self._pick_victim(remaining))[0]
                              if remaining else req)
                    self.cache.free_sequence(victim.id)
                    preempted.append(victim)
                    if victim is req:
                        break
        if not live:
            return {}, preempted
        seq_ids = [r.id for r, _ in live]
        tables, lengths = self.cache.batch_tables(seq_ids)
        bids, offs = self.cache.window_slots(seq_ids, 1)
        toks, health = self.model.decode_step(
            self.cache, [t for _, t in live], lengths - 1, tables, lengths,
            bids[:, 0], offs[:, 0])
        if not math.isfinite(health):
            raise NumericDivergence(
                f"serving: non-finite logits in decode batch of "
                f"{len(live)} (health={health})")
        return ({req.id: [int(t)] for (req, _), t in zip(live, toks)},
                preempted)

    def _pick_victim(self, remaining):
        """Index into ``remaining`` of the preemption victim (see
        :meth:`decode`)."""
        best_j, best_key = len(remaining) - 1, None
        for j in range(len(remaining) - 1, -1, -1):
            req = remaining[j][0]
            blocks = (len(self.cache.block_table(req.id))
                      if self.cache.has_sequence(req.id) else 0)
            key = (-float(req.tenant_weight), blocks, j)
            if best_key is None or key > best_key:
                best_j, best_key = j, key
        return best_j

    def evict(self, req):
        """Free a sequence's blocks (idempotent)."""
        return self.cache.free_sequence(req.id)
