"""EngineCore: model + paged cache = prefill/decode compute (no policy).

The port of ``tpu_mx/serving/engine.py``.  One engine owns one
:class:`~tpu_mx_torch.serving.kv_cache.PagedKVCache` on the model's
device and runs two operations for the server:

- :meth:`EngineCore.prefill` — one sequence's prompt (plus any tokens
  it already committed before a preemption): the model computes every
  layer's K/V through the flash kernel, the cache is bulk-filled in one
  call, and the first generated token comes back.  With prefix sharing
  on, the longest indexed full-block prefix of the prompt is served from
  the cache: only the suffix is computed (``TinyLM.prefill_suffix``, the
  dense arm over prefix ++ suffix keys) and written.
- :meth:`EngineCore.decode` — ONE decode step for a whole batch: reserve
  each sequence's window of ``spec_window`` slots, then run
  :meth:`TinyLM.decode_step`, the whole step on the device with the
  paged kernel over the ``(B, K)`` window.  With speculation on
  (``TPUMX_SPECULATIVE``) the proposer drafts ``K-1`` tokens, each row's
  agreeing prefix is accepted and the rejected tail truncated: greedy
  streams are those of one-token decode.  Sequences whose reservation
  hits :class:`CacheExhausted` are returned as *preempted* (the
  scheduler requeues them); the rest of the batch proceeds.

Sharing, the speculative window and greedy/sampled decoding are resolved
once per engine and recorded on the ``serve.decode_path`` event.  A
request carrying a sampler gets its last position's logits back instead
of a token: the server samples on its own thread, so a watchdog's
abandoned (zombie) step never advances a journaled RNG.  A non-greedy
engine pins the window to 1 (speculation verifies greedily).  The
reference's fused/host decode arms and self-check audits are not ported
(the port has one on-device decode path).

``warm_batch=B`` builds both kernels and launches one prefill and one
decode step at batch ``B`` at construction, on a scratch cache, so that
no first request — and no watchdog deadline — pays ``nvcc``: the port's
meaning of the reference's jit warm-up.  On the CPU the kernels' plain
versions need no build, and nothing runs.  ``forensics`` (a path prefix)
arms the cache's capacity forensic dumps.

Fault surface (what the server's watchdog and restart ladder wrap): the
chaos ``slow_decode_step``, ``kill9_at_decode_step`` and
``restart_storm`` sites fire at the top of :meth:`EngineCore.decode`,
inside the watchdog thread, and the logits health routes through
``chaos.poison_loss``.  Non-finite logits raise
:class:`~tpu_mx_torch.supervisor.NumericDivergence`.  The engine is
disposable: a restart builds a fresh one (new cache, same weights), and
a thread still inside the old one touches only its private cache.
"""
from __future__ import annotations

import math
import time

import torch

from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..contrib import chaos as _chaos
from ..supervisor import NumericDivergence
from .attention import decode_arm
from .kv_cache import CacheExhausted, PagedKVCache, prefix_sharing_enabled
from .speculative import SiblingProposer, accept_prefix, resolve_spec_window

__all__ = ["EngineCore"]


class EngineCore:
    """See module docstring.  ``model`` is a
    :class:`~tpu_mx_torch.serving.model.TinyLM`; the cache geometry and
    device come from it.  ``dtype`` is the KV pool's storage type.
    ``share_prefix`` (None: ``TPUMX_PREFIX_SHARING``) turns prefix
    sharing on; ``greedy=False`` (a sampling server) hands logits back
    and pins the speculative window to 1; ``forensics`` and
    ``warm_batch`` as in the module docstring."""

    def __init__(self, model, block_size=16, num_blocks=256,
                 dtype=torch.float32, share_prefix=None, forensics=None,
                 warm_batch=None, greedy=True):
        self.model = model
        self.greedy = bool(greedy)
        if share_prefix is None:
            share_prefix = prefix_sharing_enabled()
        self.share_prefix = bool(share_prefix)
        self.spec_window = resolve_spec_window() if self.greedy else 1
        self.cache = PagedKVCache(
            model.num_layers, model.num_heads, model.head_dim,
            block_size=block_size, num_blocks=num_blocks, dtype=dtype,
            share_prefix=self.share_prefix, forensics=forensics,
            device=model.device)
        self.proposer = (SiblingProposer(model) if self.spec_window > 1
                         else None)
        _tracing.emit("serve.decode_path",
                      path=decode_arm(model.head_dim, torch.float32,
                                      self.cache.k_pool.dtype,
                                      self.spec_window,
                                      device_type=self.cache.k_pool.device
                                      .type),
                      storage="device",
                      sharing=self.share_prefix, fused=True,
                      spec_window=self.spec_window,
                      sampling="greedy" if self.greedy else "sampled")
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.warm_batch = int(warm_batch) if warm_batch else None
        self.warmed = False
        if self.warm_batch and model.device.type == "cuda":
            self._warm(self.warm_batch)
            self.warmed = True

    def _warm(self, batch):
        """One prefill (the flash forward, through ``num_layers``
        launches) and one decode step at ``batch`` (the paged kernel over
        the engine's window) on a scratch cache of this engine's
        geometry: the kernels are built and loaded here, outside any
        deadline, and the engine's own cache is untouched."""
        model, bs, k = self.model, self.cache.block_size, self.spec_window
        length = max(1, min(bs, model.max_positions - k))
        cache = PagedKVCache(
            model.num_layers, model.num_heads, model.head_dim,
            block_size=bs,
            num_blocks=batch * self.cache.blocks_for(length + k),
            dtype=self.cache.k_pool.dtype, share_prefix=False,
            device=model.device)
        kv = model.prefill([0] * length)
        ids = [f"warm-{i}" for i in range(batch)]
        for sid in ids:
            cache.prefill(sid, kv[0], kv[1])
            cache.reserve_window(sid, k)
        tables, lengths = cache.batch_tables(ids)
        bids, offs = cache.window_slots(ids, k)
        model.decode_step(cache, [0] * batch, lengths - k, tables, lengths,
                          bids, offs, proposer=self.proposer,
                          want_logits=not self.greedy)

    # -- prefill -------------------------------------------------------------
    def prefill(self, req):
        """Run ``req``'s prompt plus its committed tokens, fill its cache
        blocks, and return ``(next, cached_tokens)``: ``next`` is the
        greedy token, or for a request carrying a sampler the last
        position's logits (a float32 ``(V,)`` array) for the caller to
        sample.  A requeued request is rebuilt in this one call: K/V at
        every position is a function of the tokens before it only.  With
        sharing on, ``cached_tokens`` leading tokens came from the
        cache.  :class:`CacheExhausted` propagates with the cache
        unchanged and no pinned reference left (the scheduler defers)."""
        t0 = time.perf_counter()
        tokens = req.prompt + req.tokens
        # the capacity ledger's attribution key
        tenant = getattr(req, "tenant", None)
        plan = self.cache.match_prefix(tokens, tenant=tenant)
        if plan is not None:
            cached = plan.tokens_matched
            try:
                kp, vp = self.cache.gather_plan(plan)
                k, v, logits = self.model.prefill_suffix(
                    tokens[cached:], cached, kp, vp)
            except BaseException:
                self.cache.abandon_plan(plan)
                raise
            self.cache.commit_prefill(req.id, plan, k, v, tokens,
                                      tenant=tenant)
        else:
            cached = 0
            k, v, logits = self.model.prefill(tokens)
            self.cache.prefill(req.id, k, v,
                               tokens=tokens if self.share_prefix else None,
                               tenant=tenant)
        sampled = getattr(req, "sampler", None) is not None
        # one device->host copy: health and the greedy id, and for a
        # sampled request the logits themselves
        parts = [logits.abs().amax().reshape(1), logits.argmax().float()
                 .reshape(1)] + ([logits.float()] if sampled else [])
        back = torch.cat(parts).cpu().numpy()
        health = float(back[0])
        if not math.isfinite(health):
            self.cache.free_sequence(req.id)
            raise NumericDivergence(
                f"serving: non-finite logits in prefill of {req.id} "
                f"(health={health})")
        if req.tokens:
            _telemetry.counter("serve.replay_requests").inc()
            _telemetry.counter("serve.replay_tokens").inc(len(req.tokens))
        _tracing.emit("serve.prefill", request=req.id,
                      tokens=len(req.prompt), cached=cached,
                      replayed=len(req.tokens), t0=t0,
                      t1=time.perf_counter())
        return (back[2:] if sampled else int(back[1])), cached

    # -- decode --------------------------------------------------------------
    def _window(self, items):
        """The step's window: ``spec_window``, cut so that no row's
        window passes the model's last position."""
        room = min(self.model.max_positions - self.cache.length(req.id)
                   for req, _ in items)
        return max(1, min(self.spec_window, room))

    def decode(self, items):
        """One decode STEP for each ``(req, last_token)`` in ``items`` —
        one to ``spec_window`` tokens per request.

        Returns ``(results, preempted)``: ``results`` maps request id →
        the LIST of tokens the step produced, in stream order (one, or
        up to ``spec_window`` when speculation accepts drafts) — for a
        request carrying a sampler, its last position's logits (a
        float32 ``(V,)`` array) instead; ``preempted`` lists the
        requests evicted to make room.

        The step reserves each sequence's whole window up front
        (all-or-nothing), runs one windowed step, accepts each row's
        agreeing draft prefix and truncates the rejected tail.
        Preemption picks, among the members not yet reserved this step,
        the one with the lowest tenant weight, then the most blocks only
        it holds (freeing a shared block returns no memory), then the
        youngest; the reservation is retried after each eviction, so the
        oldest live sequence always makes progress (``items`` arrive in
        admission order).  A finished member (a static batch's padding
        slot) is always the first victim: its cache is pure waste."""
        _chaos.maybe_slow_decode()
        _chaos.maybe_kill9_decode()   # a real os._exit(137)
        _chaos.storm_restart()        # back-to-back classified restarts
        k = self._window(items)
        live, preempted = [], []
        remaining = [(req, int(last)) for req, last in items]
        while remaining:
            req, last = remaining.pop(0)
            while True:
                try:
                    self.cache.reserve_window(req.id, k)
                    live.append((req, last))
                    break
                except CacheExhausted:
                    done = [j for j in range(len(remaining))
                            if remaining[j][0].done]
                    victim = (remaining.pop(done[-1])[0] if done
                              else remaining.pop(
                                  self._pick_victim(remaining))[0]
                              if remaining else req)
                    self.cache.free_sequence(victim.id)
                    preempted.append(victim)
                    if victim is req:
                        break
        if not live:
            return {}, preempted
        seq_ids = [r.id for r, _ in live]
        tables, lengths = self.cache.batch_tables(seq_ids)
        bids, offs = self.cache.window_slots(seq_ids, k)
        samplers = [getattr(r, "sampler", None) for r, _ in live]
        want_logits = any(s is not None for s in samplers)
        heads = [t for _, t in live]
        out, drafts, health, logits = self.model.decode_step(
            self.cache, heads, lengths - k, tables, lengths, bids, offs,
            proposer=self.proposer, want_logits=want_logits)
        health = _chaos.poison_loss(health)
        if not math.isfinite(health):
            raise NumericDivergence(
                f"serving: non-finite logits in decode batch of "
                f"{len(live)} (health={health})")
        results = {}
        accepted = 0
        for bi, (req, last) in enumerate(live):
            a = accept_prefix([last, *drafts[bi]], out[bi])
            if a + 1 < k:
                self.cache.truncate(req.id, int(lengths[bi]) - (k - 1 - a))
            if samplers[bi] is not None:
                results[req.id] = logits[bi]
            else:
                results[req.id] = [int(t) for t in out[bi, :a + 1]]
            accepted += a
        if k > 1:
            drafted = (k - 1) * len(live)
            self._spec_drafted += drafted
            self._spec_accepted += accepted
            _telemetry.counter("serve.spec_drafted").inc(drafted)
            if accepted:
                _telemetry.counter("serve.spec_accepted").inc(accepted)
            _telemetry.gauge("serve.spec_accept_ratio").set(
                self._spec_accepted / self._spec_drafted)
        return results, preempted

    def _pick_victim(self, remaining):
        """Index into ``remaining`` of the preemption victim (see
        :meth:`decode`)."""
        best_j, best_key = len(remaining) - 1, None
        for j in range(len(remaining) - 1, -1, -1):
            req = remaining[j][0]
            key = (-float(req.tenant_weight),
                   self.cache.exclusive_blocks(req.id), j)
            if best_key is None or key > best_key:
                best_j, best_key = j, key
        return best_j

    def evict(self, req):
        """Free a sequence's blocks (idempotent)."""
        return self.cache.free_sequence(req.id)
