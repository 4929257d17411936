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
  each sequence's window of ``spec_window`` slots, then run the window
  forward through one of two arms (``TPUMX_FUSED_DECODE``,
  ``serving/jax_model.py``):

  * **fused** (the port's default): :meth:`TinyLM.decode_step`, the
    whole step on the device — one copy of the step's integer operands
    in, the paged kernel over the ``(B, K)`` window every layer, one
    copy of the ids and the health back;
  * **host layer loop** (``TPUMX_FUSED_DECODE=0``, and every dense
    engine): the reference's ``_host_step``, the model's pieces
    (``embed``, ``layer_qkv``, ``layer_combine``, ``logits``)
    interleaved with the cache's per-layer writes
    (``write_batch``/``write_window``) and :func:`decode_attention` of
    the engine's decode arm (``TPUMX_PAGED_DECODE``: ``dense``,
    ``paged`` or ``paged-kernel``, ``serving/attention.py``).  The
    tensors stay on the model's device; the loop pays a host-to-device
    copy of the write slots every layer (and of the gather index on the
    dense arm).

  With speculation on (``TPUMX_SPECULATIVE``) the proposer drafts ``K-1``
  tokens on the device, each row's agreeing prefix is accepted and the
  rejected tail truncated: greedy streams are those of one-token decode,
  on every arm.  Sequences whose reservation hits
  :class:`CacheExhausted` are returned as *preempted* (the scheduler
  requeues them); the rest of the batch proceeds.

The decode arm, sharing, the fused step, the speculative window and
greedy/sampled decoding are resolved once per engine and recorded on the
``serve.decode_path`` event (``path``: the arm a decode takes, so a
``"paged"`` engine at a shape the kernel has no instance for records
``"dense"``; ``fused``; ``storage``: where the pools live).  With both
knobs unset the port decodes paged and fused, on the device; the
reference's default is its host-resident dense arm (chosen for a process
where jax might be missing), which an explicit ``0`` selects here.  A
request carrying a sampler gets its last position's logits back instead
of a token: the server samples on its own thread, so a watchdog's
abandoned (zombie) step never advances a journaled RNG.  A non-greedy
engine pins the window to 1 (speculation verifies greedily); it keeps
the fused arm, which hands the logits back (the reference's fused
program samples on its device, so it pins a sampled engine to its host
loop).  ``serve.host_crossings`` counts the host<->device copies of each
step when the pools are on the card: 2 on the fused arm; on the host
loop 3 + the layer count on the paged arms and 2 + twice it on the dense
one, one more with speculation; ``serve.host_crossings_per_token``
divides them by the tokens the step emitted.

**Decode self-check** (``TPUMX_SELF_CHECK``, a rate; 0, the default,
disarms; ``TPUMX_SELF_CHECK_SEED``): on the sampled steps of
``parallel/integrity.py``'s ``ShadowAuditor(surface="decode")`` the
engine re-runs the identical step — the same operands, the same arm; the
window's K/V land the same values in the same reserved slots — before
the rejected tail is truncated, and compares the emitted ids bit for
bit (``integrity.self_checks``; a mismatch counts
``integrity.self_check_mismatches`` and raises ``DataCorruption``, which
the server's restart ladder classifies ``"corruption"``).  Each arm is
deterministic for fixed shapes: cuBLAS picks one algorithm for a shape,
the paged kernel's split count and merge order are fixed by the shape
and the lengths, and no arm reduces with atomics.

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
import os
import time

import numpy as np
import torch

from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..contrib import chaos as _chaos
from ..supervisor import NumericDivergence
from .attention import (decode_arm, decode_attention, device_tables,
                        resolve_decode_path)
from .jax_model import resolve_fused
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
        self.decode_kind = resolve_decode_path()
        if share_prefix is None:
            share_prefix = prefix_sharing_enabled()
        self.share_prefix = bool(share_prefix)
        self.spec_window = resolve_spec_window() if self.greedy else 1
        self.fused = resolve_fused(self.decode_kind, model)
        self.cache = PagedKVCache(
            model.num_layers, model.num_heads, model.head_dim,
            block_size=block_size, num_blocks=num_blocks, dtype=dtype,
            share_prefix=self.share_prefix, forensics=forensics,
            device=model.device)
        self.proposer = (SiblingProposer(model) if self.spec_window > 1
                         else None)
        path = self.decode_kind
        if path == "paged":
            path = decode_arm(model.head_dim, torch.float32,
                              self.cache.k_pool.dtype, self.spec_window,
                              device_type=self.cache.k_pool.device.type)
        _tracing.emit("serve.decode_path", path=path,
                      storage="device" if self.cache.device_resident
                      else "host",
                      sharing=self.share_prefix, fused=self.fused,
                      spec_window=self.spec_window,
                      sampling="greedy" if self.greedy else "sampled")
        rate = float(os.environ.get("TPUMX_SELF_CHECK", "0") or 0)
        if rate > 0:
            from ..parallel.integrity import ShadowAuditor
            seed = int(os.environ.get("TPUMX_SELF_CHECK_SEED", "0") or 0)
            self._self_check = ShadowAuditor(rate=rate, seed=seed,
                                             surface="decode")
        else:
            self._self_check = None
        self._decode_step_idx = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.warm_batch = int(warm_batch) if warm_batch else None
        self.warmed = False
        if self.warm_batch and model.device.type == "cuda":
            self._warm(self.warm_batch)
            self.warmed = True

    def _warm(self, batch):
        """One prefill (the flash forward, through ``num_layers``
        launches) and one decode step of this engine's arm at ``batch``
        on a scratch cache of this engine's geometry: the kernels are
        built and loaded here, outside any deadline, and the engine's own
        cache is untouched.  It is not serving work: the ``serve.*``
        metrics are left as they were (the reference's warm-up only
        compiles), while the kernel wrappers count its launches."""
        with _telemetry.muted("serve."):
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
            self._step(cache, ids, [0] * batch, np.full(batch, length),
                       k, not self.greedy)

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
        heads = [t for _, t in live]
        lengths = np.array([self.cache.length(s) for s in seq_ids],
                           np.int64)
        samplers = [getattr(r, "sampler", None) for r, _ in live]
        want_logits = any(s is not None for s in samplers)
        out, drafts, health, logits, crossings = self._step(
            self.cache, seq_ids, heads, lengths - k, k, want_logits)
        health = _chaos.poison_loss(health)
        if not math.isfinite(health):
            raise NumericDivergence(
                f"serving: non-finite logits in decode batch of "
                f"{len(live)} (health={health})")
        # the sampled self-check (module docstring): before any rejected
        # tail is truncated, the identical step again, ids compared bit
        # for bit
        idx = self._decode_step_idx
        self._decode_step_idx += 1
        if self._self_check is not None \
                and self._self_check.should_audit(idx):
            _telemetry.counter("integrity.self_checks").inc()
            try:
                self._self_check.audit(out, lambda: self._step(
                    self.cache, seq_ids, heads, lengths - k, k,
                    want_logits)[0], step=idx)
            except Exception:
                _telemetry.counter("integrity.self_check_mismatches").inc()
                raise
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
        if crossings:
            _telemetry.counter("serve.host_crossings").inc(crossings)
        _telemetry.gauge("serve.host_crossings_per_token").set(
            crossings / (accepted + len(live)))
        return results, preempted

    def _step(self, cache, seq_ids, heads, positions, k, want_logits):
        """The window forward of one decode step on ``cache``: the fused
        arm or the host layer loop.  ``heads`` are the rows' stream heads
        at host ``positions``; the window's ``k`` slots are reserved.
        Returns ``(out, drafts, health, logits, crossings)``: int64 ``(B,
        k)`` greedy ids, int64 ``(B, k-1)`` drafts, the max |logit|, the
        last position's float32 ``(B, V)`` logits with ``want_logits``
        (else None) and the step's host<->device copies."""
        if self.fused:
            tables, lengths = cache.batch_tables(seq_ids)
            bids, offs = cache.window_slots(seq_ids, k)
            res = self.model.decode_step(
                cache, heads, positions, tables, lengths, bids, offs,
                proposer=self.proposer, want_logits=want_logits,
                kind=self.decode_kind)
            _telemetry.counter("serve.fused_steps").inc()
            return res + (2 if cache.device_resident else 0,)
        return self._host_step(cache, seq_ids, heads, positions, k,
                               want_logits)

    @torch.no_grad()
    def _host_step(self, cache, seq_ids, heads, positions, k, want_logits):
        """The host layer loop (module docstring), over the ``(B*K, E)``
        hidden batch: ``K == 1`` writes each layer through
        ``write_batch``, a wider window through ``write_window`` and the
        per-row causal window attention.  Returns what :meth:`_step`
        does."""
        model, b = self.model, len(seq_ids)
        hd = (model.num_heads, model.head_dim)
        paged = self.decode_kind != "dense"
        # the tables do not change between the step's layers: once
        batch = (device_tables(*cache.batch_tables(seq_ids), model.device)
                 if paged else None)
        positions = np.asarray(positions, np.int64)
        if k > 1:
            ops = torch.from_numpy(np.stack(
                [np.asarray(heads, np.int64), positions])).to(model.device)
            drafts = torch.as_tensor(self.proposer.draft(ops[0], ops[1],
                                                         k - 1),
                                     device=model.device).long()
            tokens = torch.cat([ops[0][:, None], drafts], dim=1).reshape(-1)
        else:
            drafts = torch.zeros((b, 0), dtype=torch.int64,
                                 device=model.device)
            tokens = heads
        h = model.embed(tokens, (positions[:, None]
                                 + np.arange(k)).reshape(-1))
        for i in range(model.num_layers):
            q, kk, vv = model.layer_qkv(i, h)
            if k == 1:
                cache.write_batch(seq_ids, i, kk, vv)
            else:
                cache.write_window(seq_ids, i, kk.view(b, k, *hd),
                                   vv.view(b, k, *hd))
                q = q.view(b, k, *hd)
            attn = decode_attention(q, cache, seq_ids, i,
                                    kind=self.decode_kind, batch=batch)
            h = model.layer_combine(i, h, attn.reshape(b * k, *hd))
        res = model.step_result(model.logits(h), drafts, b, k, want_logits)
        crossings = 0
        if cache.device_resident:
            # the embed's operands (one copy, two with the proposer's),
            # the tables, every layer's write slots (and the dense
            # gather's index), the readback
            crossings = ((2 if k > 1 else 1) + paged
                         + model.num_layers * (1 if paged else 2) + 1)
        return res + (crossings,)

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
