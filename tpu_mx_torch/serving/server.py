"""The request front-end: streams of requests in, supervised decode out.

The port of ``tpu_mx/serving/server.py``.  :class:`Server` turns a
stream of generation requests into scheduler and engine work:

- ``submit(prompt, max_new_tokens)`` admits a request (any thread) and
  returns its :class:`~tpu_mx_torch.serving.scheduler.Request` handle,
  or raises :class:`~tpu_mx_torch.serving.scheduler.AdmissionReject`
  with a reason — the bounded-queue backpressure contract;
- ``step()`` runs ONE engine iteration: admit + prefill newly admissible
  requests, decode the running batch one token (or an accepted
  speculative window), evict finished sequences at once.  The caller
  drives the loop (``run_until_idle()``), which keeps the data plane
  single-threaded and deterministic;
- ``stream(prompt, ...)`` submits and yields tokens as they are
  generated, driving ``step()`` underneath.

Decoding is greedy, or top-k (``sampling="top_k:K"``): each request then
gets its own sampler seeded by ``fold_seed(sampling_seed, request id)``
(``serving/sampling.py``), and the engine hands each step's last-position
logits back for this thread to sample.  Prefix sharing
(``prefix_sharing``, default ``TPUMX_PREFIX_SHARING``) and speculative
decoding (``TPUMX_SPECULATIVE``) are the engine's.

**Self-healing** (``tpu_mx_torch/supervisor.py``): every engine compute
call runs under ``run_with_deadline`` (``deadline=`` seconds; a hung
decode becomes a :class:`~tpu_mx_torch.supervisor.WatchdogTimeout`), and
non-finite logits raise ``NumericDivergence``, a failed decode
self-check (``TPUMX_SELF_CHECK``) ``DataCorruption``.
``supervisor.classify`` sorts each fault: a transient, numeric or
corruption one triggers a **classified engine restart** — a fresh
engine and cache, every in-flight request requeued, a black box dumped
(``blackbox=`` prefix), a backoff (``backoff * 2**(n-1)`` seconds) —
within a budget of ``max_restarts``;
a fatal one (a programming error, a CUDA error) propagates.  No restart
moves work to the CPU or swaps a kernel for its plain version.  A
watchdog's abandoned thread touches only the discarded engine: the
scheduler, the request handles and the samplers are mutated by the
caller's thread alone (sampled requests get logits back and are sampled
here, after the watchdog join).

**Recovery without regeneration**: a requeued request keeps its
committed tokens and the new engine rebuilds it with ONE
``prefill(prompt + committed)`` (``replay=True``, the default of
``TPUMX_PREFILL_REPLAY``); ``replay=False`` is the legacy prompt-replay
arm.  ``journal=`` (a path prefix) fsyncs every admission and, once a
step before it returns, every committed token to an append-only journal
(``serving/journal.py``), so a new process's :meth:`Server.recover`
resumes every stream after a kill -9 with no token lost, duplicated or
re-yielded.  :meth:`Server.drain` and :meth:`Server.handoff` are the
planned twins (quiesce; or migrate every live session to a fresh engine
generation) with no failure and no restart budget spent.  Budget
exhaustion degrades: queued requests fail loudly, the running batch
drains on one final generation.

``slo=`` arms the live SLO monitor (``serving/slo.py``) and
:attr:`Server.slo_signal`; the capacity ledger is published each step
as gauges and :attr:`Server.capacity_signal`.  Each step stamps the
trace context's ``step``/``generation``, per-request work ``request``.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..base import MXNetError
from .. import device as _device
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..supervisor import classify, run_with_deadline
from .engine import EngineCore
from .journal import TokenJournal, load as _journal_load
from .kv_cache import CacheExhausted
from .sampling import fold_seed, make_sampler, parse_sampling
from .scheduler import ContinuousBatchingScheduler, Request
from .slo import SLOMonitor
from .tenancy import label_for

__all__ = ["Server"]

log = logging.getLogger(__name__)


class Server:
    """See module docstring.

    ``model`` is a :class:`~tpu_mx_torch.serving.model.TinyLM` on
    ``device`` (default ``"cuda"``; the two must agree).  ``scheduler``
    defaults to a :class:`ContinuousBatchingScheduler` built from
    ``max_pending``/``max_batch``/``max_tokens``/``tenants``;
    ``block_size``/``num_blocks``/``dtype`` size the paged cache;
    ``deadline`` arms the hung-step watchdog (seconds, None = off);
    ``max_restarts`` bounds the self-healing budget and ``backoff`` the
    wait after a restart; ``blackbox`` (a path prefix) arms the crash
    black box and the capacity forensics; ``eos_id`` optionally ends
    generation early; ``slo`` is True (the default targets), spec
    string(s) or an :class:`SLOMonitor`.

    Recovery: ``journal=`` (a path prefix) arms the durable
    committed-token journal — ``recover()`` in a NEW process resumes
    every unfinished stream from it; ``sampling=`` is ``"greedy"`` or
    ``"top_k:K"`` (non-greedy pins the speculative window to 1);
    ``sampling_seed=`` is the base seed each request's private RNG is
    folded from; ``replay=`` overrides ``TPUMX_PREFILL_REPLAY`` (True =
    one replay prefill on a restart, False = the legacy prompt-replay
    arm).  Every engine generation is warmed at ``max_batch``
    (``EngineCore(warm_batch=)``): no deadline fires on a kernel
    build."""

    def __init__(self, model, *, scheduler=None, max_pending=64,
                 max_batch=8, max_tokens=8192, block_size=16,
                 num_blocks=256, deadline=None, max_restarts=3,
                 backoff=0.05, blackbox=None, eos_id=None, slo=None,
                 tenants=None, prefix_sharing=None, dtype=torch.float32,
                 journal=None, sampling="greedy", sampling_seed=0,
                 replay=None, device="cuda"):
        dev = _device.resolve(device)
        if model.device.type != dev.type:
            raise MXNetError(f"Server(device={str(device)!r}): the model's "
                             f"weights are on {model.device}")
        self.model = model
        self.device = dev
        # the live SLO monitor (serving/slo.py): True arms the
        # default targets, a list/tuple of spec strings builds a monitor
        # from them, or pass a configured SLOMonitor.  Refreshed every
        # step; its signal is published to scheduler.slo_signal (the
        # fairness hook) and force-refreshed before every black-box dump
        # so a restart's box carries the fault-time SLO window state.
        if slo is True:
            slo = SLOMonitor()
        elif not slo:
            slo = None   # False/()/[] all mean unarmed, same as None
        elif isinstance(slo, str):
            slo = SLOMonitor((slo,))
        elif isinstance(slo, (list, tuple)):
            slo = SLOMonitor(slo)
        elif not isinstance(slo, SLOMonitor):
            raise TypeError(f"slo= takes True, spec string(s), or an "
                            f"SLOMonitor — got {type(slo).__name__}")
        self.slo = slo
        # multi-tenant policy: `tenants` is anything
        # TenantTable.coerce accepts; `prefix_sharing` pins the shared-
        # prefix KV reuse knob (None = the TPUMX_PREFIX_SHARING env
        # resolution).  Both thread through engine restarts — a rebuilt
        # engine keeps the data-plane contract it degraded under.
        self.scheduler = scheduler if scheduler is not None else \
            ContinuousBatchingScheduler(max_pending=max_pending,
                                        max_batch=max_batch,
                                        max_tokens=max_tokens,
                                        tenants=tenants)
        self._block_size = int(block_size)
        self._num_blocks = int(num_blocks)
        self._dtype = dtype
        self._prefix_sharing = prefix_sharing
        self.deadline = deadline
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.blackbox = blackbox
        self.eos_id = eos_id
        # recovery plane: sampling mode is a SERVER property
        # (one decode path per server, resolved once like the engine
        # arms), the replay arm resolves env-default-on, and the journal
        # opens (and fsyncs its header) before any request is admitted
        self._sampling_kind, self._sampling_k = parse_sampling(sampling)
        self._sampling_seed = int(sampling_seed)
        if replay is None:
            replay = os.environ.get("TPUMX_PREFILL_REPLAY", "1") != "0"
        self.replay = bool(replay)
        self.journal = TokenJournal(journal) if journal else None
        self._draining = False
        self.engine = self._new_engine()
        self.generation = 0        # engine generation (restart count)
        self.restarts = 0
        self.degraded = False
        self._steps = 0
        self._tokens_generated = 0
        self._t_first_work = None
        # tenant labels the pool-bytes gauges have published: a tenant
        # whose bytes drop to zero must be zeroed, not left frozen at
        # its last nonzero attribution
        self._pool_tenants_seen = set()
        # capacity-publish throttle: (used_blocks at last publish,
        # monotonic time of it) — the full ledger walk runs only when
        # the pool actually moved or the refresh interval elapsed,
        # mirroring the SLO monitor's own rate limit
        self._cap_published = None

    def _new_engine(self):
        """Build one engine generation (construction, restart, handoff,
        the degraded drain): the rebuilt engine keeps every data-plane
        contract it degraded under — sharing knob, forensics, warm
        batch, and the greedy/sampled pin (non-greedy sampling pins the
        speculative window to 1)."""
        return EngineCore(self.model, block_size=self._block_size,
                          num_blocks=self._num_blocks, dtype=self._dtype,
                          share_prefix=self._prefix_sharing,
                          forensics=self.blackbox,
                          warm_batch=getattr(self.scheduler,
                                             "max_batch", None),
                          greedy=self._sampling_kind == "greedy")

    def _sampler_for(self, req):
        """The request's private sampler (None for greedy): seeded by
        folding the request id into the server's base seed, so a
        recovered process rebuilds the SAME sampler for the same id
        before loading its journaled state."""
        return make_sampler(self._sampling_kind, self._sampling_k,
                            fold_seed(self._sampling_seed, req.id))

    # -- admission (any thread) ----------------------------------------------
    def submit(self, prompt, max_new_tokens=16, request_id=None,
               tenant=None):
        """Admit one request; returns its handle or raises
        :class:`AdmissionReject` (reason on the exception — resubmit
        later; ``tenant_quota`` means THIS tenant is over its caps).
        ``tenant`` names the submitting tenant (fairness/quota identity
        + bounded telemetry label; None = the default tenant).  A
        degraded server rejects everything; a draining one rejects with
        ``"draining"`` until :meth:`resume_admission`."""
        req = Request(prompt, max_new_tokens, request_id=request_id,
                      tenant=tenant)
        req.tenant_weight = self.scheduler.tenants.get(req.tenant).weight
        req.sampler = self._sampler_for(req)
        # all server-side gates route through the scheduler's ONE
        # reject implementation, so a degraded-window, draining, or
        # oversized submit is counted and lands on the timeline like
        # any other
        if self.degraded:
            self.scheduler.reject(req, "degraded",
                                  "restart budget exhausted; server is "
                                  "in degraded shutdown")
        if self._draining:
            self.scheduler.reject(req, "draining",
                                  "server is quiescing for drain/"
                                  "handoff; resubmit after admission "
                                  "reopens")
        # a request whose WORST CASE can never fit the block pool would
        # preempt-loop forever — reject it at the door with the reason
        need = self.engine.cache.blocks_for(req.budget_tokens)
        if need > self._num_blocks:
            self.scheduler.reject(
                req, "request_too_large",
                f"prompt+max_new needs {need} cache blocks > pool of "
                f"{self._num_blocks}")
        if self.journal is not None:
            # fsync'd BEFORE the request becomes schedulable: the
            # any-thread-submit model lets a concurrently-stepping
            # stepping thread prefill and buffer token records the moment
            # scheduler.submit returns, and load() treats a token
            # without its begin as a lost stream — so the begin must
            # already be on disk.  A crash between here and the first
            # token still recovers the stream (prompt-only replay).
            self.journal.begin(req)
        try:
            return self.scheduler.submit(req)
        except BaseException:
            if self.journal is not None:
                # the entry was journaled but admission refused it:
                # retire it durably so a recovering successor never
                # resurrects (and generates) a request whose client was
                # told it was rejected
                self.journal.end(req, "rejected")
                self.journal.flush()
            raise

    # -- the engine loop (one stepping thread) -------------------------------
    def step(self):
        """One engine iteration (admit → prefill → decode → evict).
        Returns True when any work was done.  Transient/numeric faults
        restart the engine in place; fatal ones propagate.  A degraded
        server still steps while its migrated running batch drains —
        only an IDLE degraded server refuses to step."""
        if self.degraded and self.scheduler.idle():
            raise MXNetError("serving: server is degraded — no further "
                             "steps will run")
        self._steps += 1
        _tracing.set_context(step=self._steps, generation=self.generation)
        try:
            return self._step_guarded()
        except BaseException as e:  # noqa: BLE001 — classified below
            kind = classify(e)
            if kind == "fatal":
                raise
            if self.degraded:
                # a SECOND fault during the degraded drain: the budget
                # is spent and there is no next generation — fail the
                # remaining in-flight work loudly instead of looping
                self._fail_inflight(
                    f"degraded: fault during degraded drain "
                    f"({type(e).__name__}: {e})"[:300])
                return True
            self._restart(e)
            return True

    def _step_guarded(self):
        worked = False
        # --- admit + prefill (split prefill queue) -------------------------
        admits = self.scheduler.take_prefills()
        for i, req in enumerate(admits):
            if self._t_first_work is None:
                self._t_first_work = time.perf_counter()
            _tracing.set_context(request=req.id)
            req.timeline.mark_prefill_start()
            try:
                first, cached = run_with_deadline(
                    lambda r=req: self.engine.prefill(r),
                    self.deadline, name=f"serve-prefill-{req.id}")
            except CacheExhausted:
                # backpressure: this request (and the rest of this
                # step's admissions) goes back to the queue front — a
                # DEFER, not a requeue: none of them started, so nothing
                # is reset or counted — and the step FALLS THROUGH to
                # decode, whose progress (and evictions) is what will
                # free the blocks; an early return here would starve
                # decode and livelock.  Attribution: the bounced attempt
                # (and the wait until its retry) is a defer_stall; the
                # admissions behind it never started — their wait keeps
                # its label until the stall begins
                req.timeline.mark_prefill_failed()
                for later in admits[i + 1:]:
                    later.timeline.mark_defer()
                self.scheduler.defer(admits[i:])
                _tracing.set_context(request=None)
                break
            except BaseException:
                # engine fault mid-prefill (numeric divergence, wedged
                # deadline): take_prefills() already popped this step's
                # admissions and the restart path only requeues RUNNING
                # requests — put them back before the classified
                # restart or they are silently lost (state "queued" in
                # neither queue; wait() hangs forever).  The faulting
                # request pays a requeue (its destroyed attempt is
                # restart_penalty); the ones behind it never started
                # and keep accruing queue wait.
                self.scheduler.defer(admits[i + 1:])
                self.scheduler.requeue(req, front=True,
                                       replay=self.replay)
                self._journal_requeue([req])
                raise
            finally:
                _tracing.set_context(request=None)
            req.timeline.mark_prefill_end(cached_tokens=cached)
            self.scheduler.mark_running(req)
            if req.sampler is not None:
                # the engine hands LOGITS back for sampled requests:
                # the sample runs HERE, on the stepping thread, after the
                # watchdog join — an abandoned zombie prefill can never
                # advance the journaled RNG
                first = req.sampler.sample(first)
            self._commit_token(req, first)
            worked = True
        # --- decode (one step across the running batch: one token per
        # sequence, or an accepted speculative window) -----------------------
        batch = self.scheduler.decode_batch()
        if batch:
            if self._t_first_work is None:
                self._t_first_work = time.perf_counter()
            items = [(r, r.tokens[-1] if r.tokens else r.prompt[-1])
                     for r in batch]
            t0 = time.perf_counter()
            results, preempted = run_with_deadline(
                lambda: self.engine.decode(items), self.deadline,
                name=f"serve-decode-step{self._steps}")
            fresh = 0
            for req in batch:
                tokens = results.get(req.id)
                if tokens is None or req.done:
                    continue   # preempted, or a static-padding slot
                if isinstance(tokens, np.ndarray):
                    # a sampled row came back as LOGITS: the sample runs
                    # here on the stepping thread, after the watchdog
                    # join, so a zombie decode step can never advance
                    # the journaled RNG (zombie-step discipline)
                    tokens = [req.sampler.sample(tokens)]
                # a step yields a LIST (one token, or an accepted
                # speculative window); commit in stream order and stop
                # at the first finisher — tokens past an EOS or the
                # length budget were never part of the stream (the
                # sequence's cache is evicted with it either way)
                for token in tokens:
                    fresh += 1
                    self._commit_token(req, token)
                    if req.done:
                        break
            for req in preempted:
                # a FINISHED victim was a static-batching padding slot:
                # its tokens were already delivered, so it is simply
                # dropped from the books — requeueing it would corrupt a
                # done handle and re-decode a completed request
                done_padding = req.done
                _tracing.set_context(request=req.id)
                _tracing.emit("serve.evict", request=req.id,
                              reason="padding" if done_padding
                              else "preempted",
                              generated=len(req.tokens))
                _tracing.set_context(request=None)
                if done_padding:
                    self.scheduler.discard(req)
                else:
                    self.scheduler.requeue(req, front=True,
                                           replay=self.replay)
                    self._journal_requeue([req])
            _telemetry.counter("serve.decode_steps").inc()
            _tracing.emit("serve.decode", batch=len(items), tokens=fresh,
                          t0=t0, t1=time.perf_counter())
            worked = True
        if self.journal is not None:
            # the once-per-step durability point: every token committed
            # this step hits disk BEFORE step() returns — and stream()
            # only yields after step() returns, so every client-visible
            # token is journaled
            self.journal.flush()
        self._update_gauges()
        return worked

    def _journal_requeue(self, reqs):
        """Legacy-arm journal consistency: a ``replay=False`` requeue
        discards the ledger (``reset_generation``), so the re-rolled
        stream journals token records from ``i=0`` again while the file
        already holds higher indices for the request — which load()'s
        index-gap check would misread as corruption and degrade to
        prompt replay.  Re-begin each entry (last-incarnation-wins),
        capturing the sampler's post-reset capsule — exactly the state
        the re-roll consumes.  Buffered, not fsync'd: every requeue
        path flushes before the stream can advance.  No-op on the
        replay arm, where the ledger (and its indices) survive."""
        if self.journal is None or self.replay:
            return
        for req in reqs:
            self.journal.begin(req, sync=False)

    def _commit_token(self, req, token):
        """Record one generated token and finish/evict when done."""
        req.record_token(token)
        self._tokens_generated += 1
        _telemetry.counter("serve.generated_tokens").inc()
        if self.journal is not None:
            # buffered, not fsync'd: the step-end flush() is the
            # durability point (one fsync per step, not per token)
            self.journal.commit_token(req, token)
        done_len = len(req.tokens) >= req.max_new_tokens
        done_eos = self.eos_id is not None and int(token) == self.eos_id
        if done_len or done_eos:
            reason = "eos" if done_eos else "length"
            if self.journal is not None:
                self.journal.end(req, reason)
            for ev in self.scheduler.finish(req, reason):
                self._evict(ev)

    def _evict(self, req):
        """Free a finished sequence's cache immediately (continuous
        batching's whole point) and close out its telemetry."""
        self.engine.evict(req)
        _telemetry.counter("serve.requests", state="completed").inc()
        _tracing.set_context(request=req.id)
        _tracing.emit("serve.evict", request=req.id,
                      reason=req.finish_reason or "length",
                      generated=len(req.tokens))
        _tracing.set_context(request=None)

    def _update_gauges(self):
        _telemetry.gauge("serve.cache_utilization").set(
            self.engine.cache.utilization())
        _telemetry.gauge("serve.pool_device_resident").set(
            float(self.engine.cache.device_resident))
        _telemetry.gauge("serve.queue_depth").set(
            self.scheduler.queue_depth())
        if self._t_first_work is not None:
            dt = time.perf_counter() - self._t_first_work
            if dt > 0:
                _telemetry.gauge("serve.tokens_per_sec").set(
                    self._tokens_generated / dt)
        self._publish_capacity()
        if self.slo is not None:
            # rate-limited inside the monitor; the signal lands on the
            # scheduler for admission policies that weigh it
            self.scheduler.slo_signal = self.slo.refresh()

    def _publish_capacity(self):
        """Publish the capacity ledger live: the pool-state
        gauges, the per-tenant amortized/exclusive byte attribution
        (bounded labels — tenancy.label_for; two tenants collapsed into
        the overflow label are SUMMED, preserving the accounting
        identity), and the scheduler's ``capacity_signal`` hook — the
        would-fit data admission consults before popping a prefill that
        can only bounce (the symmetric twin of ``slo_signal``).

        Throttled like the SLO monitor's refresh: the full ledger walk
        (holders + tenants + trie reclaimable + free-list sort) runs
        only when the pool's used-block count moved since the last
        publish or 0.25 s elapsed — a steady decode loop pays one O(1)
        counter read per step, not an O(pool + trie) scan."""
        used_now = self.engine.cache.allocator.used
        now = time.monotonic()
        if self._cap_published is not None:
            last_used, last_t = self._cap_published
            if used_now == last_used and now - last_t < 0.25:
                return
        self._cap_published = (used_now, now)
        cap = self.engine.cache.capacity_stats()
        _telemetry.gauge("serve.pool_used_bytes").set(
            float(cap["used_bytes"]))
        _telemetry.gauge("serve.pool_fragmentation").set(
            cap["fragmentation"])
        _telemetry.gauge("serve.pool_high_watermark_bytes").set(
            float(cap["high_watermark_bytes"]))
        _telemetry.gauge("serve.prefix_index_bytes").set(
            float(cap["index_bytes"]))
        _telemetry.gauge("serve.pool_pinned_blocks").set(
            float(cap["pinned_blocks"]))
        by_label = {}
        for tenant, d in cap["tenants"].items():
            # ledger pseudo-tenants (_index and friends) are bounded by
            # construction and keep their names; client-controlled ids
            # go through the cardinality cap
            label = tenant if tenant.startswith("_") else label_for(tenant)
            acc = by_label.setdefault(label, [0.0, 0.0])
            acc[0] += d["bytes_amortized"]
            acc[1] += float(d["bytes_exclusive"])
        for label, (amortized, exclusive) in by_label.items():
            _telemetry.gauge("serve.pool_bytes", tenant=label,
                             kind="amortized").set(amortized)
            _telemetry.gauge("serve.pool_bytes", tenant=label,
                             kind="exclusive").set(exclusive)
        for label in self._pool_tenants_seen - set(by_label):
            _telemetry.gauge("serve.pool_bytes", tenant=label,
                             kind="amortized").set(0.0)
            _telemetry.gauge("serve.pool_bytes", tenant=label,
                             kind="exclusive").set(0.0)
        self._pool_tenants_seen |= set(by_label)
        self.scheduler.capacity_signal = {
            "num_blocks": cap["num_blocks"],
            "block_size": cap["block_size"],
            "block_bytes": cap["block_bytes"],
            "used_blocks": cap["used_blocks"],
            "free_blocks": cap["free_blocks"],
            "free_bytes": cap["free_blocks"] * cap["block_bytes"],
            "reclaimable_blocks": cap["reclaimable_blocks"],
        }

    @property
    def slo_signal(self):
        """The SLO monitor's latest signal dict, or None when no
        monitor is armed (the hook the fleet-scale fairness item
        consumes — see serving/slo.py).  A property, matching
        ``scheduler.slo_signal``'s attribute access — one name, one
        access style on both surfaces."""
        return self.slo.signal() if self.slo is not None else None

    @property
    def capacity_signal(self):
        """The latest capacity ledger signal published to the
        scheduler (``_publish_capacity``), or None before the first
        step — the symmetric twin of :attr:`slo_signal`."""
        return self.scheduler.capacity_signal

    # -- self-healing --------------------------------------------------------
    def _swap_engine(self):
        """Advance to a fresh engine generation (restart, handoff, the
        degraded drain).  The old engine — and any watchdog thread
        still wedged inside it — is garbage from here: threads touching
        its private cache mutate nothing the new generation reads.  The
        rebuilt pool starts empty, so the stale would-fit signal (and
        stale pool gauges) must not gate admission on the DEAD pool."""
        self.generation += 1
        _tracing.set_context(generation=self.generation)
        self.engine = self._new_engine()
        self.scheduler.capacity_signal = None
        self._cap_published = None

    def _restart(self, err):
        """Classified engine restart: fresh engine + cache, every
        in-flight request requeued (ONE replay prefill re-establishes
        its committed tokens — or a full prompt re-run on the legacy
        arm), black box dumped; budget exhaustion degrades — queued
        requests are failed loudly, never silently lost."""
        self.restarts += 1
        reason = f"{type(err).__name__}: {err}"[:300]
        log.warning("serving: engine fault (%s) — restart %d/%d",
                    reason, self.restarts, self.max_restarts)
        if self.restarts > self.max_restarts:
            self._degrade(err)
            return
        requeued = self.scheduler.requeue_all_running(replay=self.replay)
        self._journal_requeue(requeued)
        if self.journal is not None:
            # tokens the faulted step committed before the fault are
            # real (record_token ran; stream() may yield them) — make
            # them durable with the restart instead of waiting for the
            # next clean step boundary
            self.journal.flush()
        _telemetry.counter("serve.engine_restarts").inc()
        # serve.restart lands under the FAILING step's (step, generation)
        # context — the injection and the decision correlate in the black
        # box; only then does the context advance to the new
        # generation, so the fresh engine's serve.decode_path event is
        # stamped with the generation it will actually run as
        _tracing.emit("serve.restart", n=self.restarts, reason=reason,
                      requeued=len(requeued))
        self._swap_engine()
        self._dump_blackbox(f"serving engine restart "
                            f"{self.restarts}/{self.max_restarts}: "
                            f"{reason}")
        _telemetry.flush()
        if self.backoff:
            time.sleep(min(30.0, self.backoff * 2 ** (self.restarts - 1)))

    def _degrade(self, err):
        """Restart budget exhausted: admission closes and QUEUED
        requests fail loudly — but the running batch is not abandoned.
        It migrates (the same replay path a restart uses) onto one
        final engine generation and drains to completion under
        ``step()``'s degraded-drain mode, so budget exhaustion fails
        only queued, never mid-stream, work.  A further fault during
        that drain fails the remainder (``_fail_inflight``)."""
        self.degraded = True
        reason = (f"degraded: restart budget exhausted "
                  f"({type(err).__name__}: {err})")[:300]
        log.error("serving: %s", reason)
        # drain the QUEUE, don't requeue it: these requests are being
        # FAILED, so a requeue would both double-count them as
        # "requeued" and leave each one processed twice
        failed = self.scheduler.drain_pending()
        for req in failed:
            req.fail(reason)
            if self.journal is not None:
                self.journal.end(req, "degraded")
        requeued = self.scheduler.requeue_all_running(replay=self.replay)
        self._journal_requeue(requeued)
        _tracing.emit("serve.drain", kind="degrade",
                      inflight=len(requeued), pending=len(failed))
        if self.journal is not None:
            self.journal.flush()
        if requeued:
            self._swap_engine()
        self._dump_blackbox(reason)
        _telemetry.flush()

    def _fail_inflight(self, reason):
        """Terminal: fail everything still queued or running (a second
        fault inside the degraded drain — no generation left to
        migrate to)."""
        log.error("serving: %s", reason)
        failed = self.scheduler.drain_running()
        failed.extend(self.scheduler.drain_pending())
        for req in failed:
            req.fail(reason)
            if self.journal is not None:
                self.journal.end(req, "failed")
        if self.journal is not None:
            self.journal.flush()
        self._dump_blackbox(reason)
        _telemetry.flush()

    def _dump_blackbox(self, reason):
        if not self.blackbox:
            return None
        if self.slo is not None:
            # capture the fault-time SLO window state in the box's
            # telemetry snapshot (bypassing the refresh rate limit);
            # box-less servers skip it — the per-step refresh keeps the
            # gauges fresh within the rate limit anyway
            try:
                self.scheduler.slo_signal = self.slo.refresh(force=True)
            except Exception as slo_err:  # noqa: BLE001 — best effort
                log.warning("serving: SLO refresh at black-box time "
                            "failed: %s", slo_err)
        try:
            return _tracing.dump_blackbox(self.blackbox, reason=reason)
        except Exception as dump_err:  # noqa: BLE001 — best effort
            log.warning("serving: black-box dump failed: %s", dump_err)
            return None

    # -- planned maintenance: drain / handoff / recover ----------------------
    def drain(self, max_steps=1_000_000):
        """Graceful drain: admission closes (new submits reject with
        reason ``"draining"``) and the loop runs until every admitted
        request completes — quiescing at decode-step boundaries with
        zero client-visible failures.  Admission stays closed
        afterwards (:meth:`resume_admission` reopens it); returns the
        number of steps the drain took.  :meth:`handoff` is the
        live-migration sibling that never stops serving."""
        self._draining = True
        _tracing.emit("serve.drain", kind="drain",
                      inflight=self.scheduler.running_count(),
                      pending=self.scheduler.queue_depth())
        return self.run_until_idle(max_steps)

    def resume_admission(self):
        """Reopen admission after :meth:`drain`."""
        self._draining = False

    def handoff(self):
        """Hot engine handoff: quiesce at the current decode-step
        boundary (the single stepping thread owns it — call between
        ``step()``s) and migrate every live session onto a fresh engine
        generation via ONE replay prefill each.  A planned upgrade: no
        restart budget spent, no backoff, no black box, nothing
        re-yielded — greedy/journaled streams continue bit-identically.
        Returns the number of migrated sessions."""
        requeued = self.scheduler.requeue_all_running(replay=self.replay)
        self._journal_requeue(requeued)
        if self.journal is not None:
            self.journal.flush()
        _tracing.emit("serve.drain", kind="handoff",
                      inflight=len(requeued),
                      pending=self.scheduler.queue_depth())
        self._swap_engine()
        log.info("serving: handoff to generation %d (%d live sessions "
                 "migrated)", self.generation, len(requeued))
        return len(requeued)

    def recover(self):
        """Resume every unfinished stream from the journal — the
        cross-process half of zero-regeneration recovery (a kill −9'd
        server's successor calls this once before stepping).  Each live
        journal entry becomes a Request with its committed tokens
        pre-loaded as the in-memory ledger and its sampler restored
        from the last per-token RNG capsule; the next step re-
        establishes it with ONE ``prefill(prompt + committed)`` and the
        stream continues exactly where the dead process left it.  A
        torn/corrupt entry degrades LOUDLY to prompt replay (tokens
        dropped, ``serve.replay_fallbacks`` counted) — never guesses.
        Returns ``{request_id: Request}``."""
        if self.journal is None:
            raise MXNetError("serving: recover() needs Server("
                             "journal=...) — there is no journal to "
                             "recover from")
        out = {}
        for rid, entry in _journal_load(self.journal.path).items():
            if entry["ended"]:
                continue
            req = Request(entry["prompt"], entry["max_new"],
                          request_id=rid, tenant=entry["tenant"])
            req.tenant_weight = \
                self.scheduler.tenants.get(req.tenant).weight
            req.sampler = self._sampler_for(req)
            if entry["fallback"]:
                _telemetry.counter("serve.replay_fallbacks").inc()
                log.error("serving: journal entry for %s was torn/"
                          "corrupt — recovering from the prompt "
                          "(committed tokens dropped, stream restarts "
                          "from scratch)", rid)
            if req.sampler is not None:
                # the RNG capsule after the LAST committed token (or
                # the admission-time state when none committed yet)
                state = (entry["rngs"][-1] if entry["rngs"]
                         else entry["sampler"])
                if state is not None:
                    req.sampler.load_state_dict(state)
            if entry["tokens"]:
                req.tokens = [int(t) for t in entry["tokens"]]
            if len(req.tokens) >= req.max_new_tokens:
                # the stream finished but its end record died with the
                # process: retire it here — re-admitting would decode
                # past the length budget
                self.journal.end(req, "length")
                req.finish("length")
                out[rid] = req
                continue
            # gate-bypassing re-admission (scheduler.restore, the same
            # cap bypass requeue/defer use): the dead process already
            # admitted this request — its journaled begin is the
            # admission receipt — and a server killed at full load
            # journals up to max_pending + max_batch unfinished
            # streams, so routing recovery back through submit() would
            # queue_full-reject the overflow, abort the remaining
            # streams, and break the zero-lost-streams guarantee.
            # server.submit would also journal a fresh begin and
            # rebuild a fresh sampler — this request CONTINUES its
            # existing journal entry (token indices stay contiguous
            # with what is already on disk).
            self.scheduler.restore(req)
            out[rid] = req
        if self.journal is not None:
            self.journal.flush()
        return out

    # -- loops ---------------------------------------------------------------
    def run_until_idle(self, max_steps=1_000_000):
        """Drive ``step()`` until no request is pending or running;
        returns the number of steps taken."""
        from ..contrib import chaos as _chaos
        _chaos.configure_from_env()   # arm TPUMX_CHAOS faults, like run()
        n = 0
        while not self.scheduler.idle():
            if n >= max_steps:
                raise MXNetError(
                    f"serving: run_until_idle exceeded {max_steps} steps "
                    "with work still queued — wedged scheduler?")
            self.step()
            n += 1
        _telemetry.flush()
        return n

    def stream(self, prompt, max_new_tokens=16, request_id=None):
        """Submit and yield tokens as they are generated (drives the
        engine loop from the consuming thread)."""
        req = self.submit(prompt, max_new_tokens, request_id=request_id)
        seen = 0
        guard = 0
        while True:
            # on the prefill-replay arm an engine restart KEEPS
            # req.tokens (the ledger survives; nothing to re-yield).
            # On the legacy arm a restart resets req.tokens and re-runs
            # from the prompt; greedy decode is deterministic, so the
            # regenerated prefix matches what was already yielded —
            # wait for the length to catch back up to `seen` instead of
            # re-yielding.  Either way the cursor only moves forward.
            while seen < len(req.tokens):
                yield req.tokens[seen]
                seen += 1
            if req.done:
                if req.state == "failed":
                    raise MXNetError(
                        f"serving: request {req.id} failed: "
                        f"{req.finish_reason}")
                return
            guard += 1
            if guard > 1_000_000:
                raise MXNetError("serving: stream wedged — no progress")
            self.step()
