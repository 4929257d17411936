"""Request admission + continuous batching policy.

The port of ``tpu_mx/serving/scheduler.py``.  The scheduler is pure
policy: it owns the **pending** queue (bounded — the backpressure
boundary) and the **running** set (the live decode batch), and decides
each engine step which requests to prefill and which sequences to
decode.  It never touches the model or the cache.

- **Continuous batching** (:class:`ContinuousBatchingScheduler`): new
  requests join the running batch on EVERY step as slots and token
  budget allow, and finished sequences leave immediately — the batch
  never waits for its slowest member.
- **Admission control**: reject-with-reason gates before any memory is
  committed — ``queue_full``, ``request_too_large``, the per-tenant
  ``tenant_quota`` and the chaos ``reject_storm``.  A reject is an
  :class:`AdmissionReject` with ``.reason``; nothing is dropped silently.
- **Token budget**: admission stops while the in-flight worst case
  (``sum(len(prompt) + max_new_tokens)`` over running) would exceed
  ``max_tokens``.
- **Weighted fairness** across tenants (serving/tenancy.py), boosted for
  a tenant whose SLO burn is breaching (``slo_signal``), and a would-fit
  gate on the capacity ledger's ``capacity_signal``.
- **Recovery**: :meth:`~ContinuousBatchingScheduler.restore` re-admits a
  journal-recovered request past the gates; requeues keep a request's
  committed tokens (``replay=True``) or discard them (the legacy
  prompt-replay arm).
- **Static baseline** (:class:`StaticBatchingScheduler`): admit a full
  batch and run it until every member finishes (finished members keep
  their slot as padding), then admit the next.

Thread-safety: all public methods take the scheduler lock; ``submit``
may be called from any thread while the server's step thread admits and
evicts.
"""
from __future__ import annotations

import itertools
import threading
import time

from ..base import MXNetError
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..contrib import chaos as _chaos
from .tenancy import DEFAULT_TENANT, TenantTable, label_for
from .timeline import RequestTimeline

__all__ = ["Request", "AdmissionReject", "ContinuousBatchingScheduler",
           "StaticBatchingScheduler"]

_req_counter = itertools.count()


class AdmissionReject(MXNetError):
    """The front-end refused this request; ``reason`` says why
    (``queue_full`` / ``request_too_large`` / ``reject_storm``).  This is
    backpressure, not failure: the client resubmits later."""

    def __init__(self, reason, detail=""):
        super().__init__(f"request rejected: {reason}"
                         + (f" ({detail})" if detail else ""))
        self.reason = reason
        # reasons: queue_full / request_too_large / reject_storm /
        # degraded / tenant_quota (the submitting tenant is
        # over its max_inflight or token_quota; resubmit after its own
        # in-flight work drains, other tenants are unaffected) /
        # draining (the server is quiescing for a drain or
        # handoff; resubmit once admission reopens)


class Request:
    """One generation request and its lifecycle record (the handle the
    front-end returns).

    States: ``queued`` → ``running`` → ``done`` (or ``failed``).  A
    requeued request (engine restart, cache preemption) goes back to
    ``queued``; on the prefill-replay arm (the default) its
    committed tokens SURVIVE — they are the in-memory token ledger the
    recovery prefill replays in one call — while the legacy
    prompt-replay arm discards them and re-runs from the prompt.
    ``requeues`` counts how often either happened.  ``sampler`` (serving/sampling.py) is the
    per-request host sampler for non-greedy modes, or None for the
    engine's batched-argmax fast path.  Latency bookkeeping
    (``submitted_at``, ``first_token_at``, ``token_times``) feeds the
    TTFT/ITL telemetry."""

    def __init__(self, prompt, max_new_tokens, request_id=None,
                 tenant=None):
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("Request: empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("Request: max_new_tokens must be >= 1")
        self.id = request_id or f"req-{next(_req_counter):06d}"
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        # the submitting tenant: the fairness/quota identity
        # and the bounded telemetry label.  tenant_weight is resolved by
        # the server from its TenantTable at submit (1.0 bare) — the
        # engine's preemption victim selection reads it without needing
        # the table.
        self.tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        self.tenant_weight = 1.0
        self.sampler = None
        self.state = "queued"
        self.tokens = []
        self.finish_reason = None
        self.requeues = 0
        self.submitted_at = time.perf_counter()
        self.first_token_at = None
        self.finished_at = None
        self.token_times = []
        # the attribution ledger shares the submit timestamp so phases
        # and the TTFT/latency bookkeeping run on one clock
        # (serving/timeline.py)
        self.timeline = RequestTimeline(self.submitted_at)
        self._done = threading.Event()

    @property
    def budget_tokens(self):
        """Worst-case in-flight footprint: prompt + full generation."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def done(self):
        return self._done.is_set()

    @property
    def ttft(self):
        """Submit → first token, seconds (None before the first token)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    def record_token(self, token):
        now = time.perf_counter()
        if self.first_token_at is None:
            self.first_token_at = now
        else:
            gap = now - self.token_times[-1]
            _telemetry.histogram("serve.itl_seconds").observe(gap)
            # the per-tenant twin (bounded label — tenancy.label_for):
            # the unlabeled series stays the fleet aggregate every
            # existing dashboard and the global SLO monitor read; the
            # labeled one is what the per-tenant burn/boost loop and
            # slo_report's tenant section consume
            _telemetry.histogram("serve.itl_seconds",
                                 tenant=label_for(self.tenant)).observe(gap)
        self.token_times.append(now)
        self.tokens.append(int(token))
        self.timeline.mark_token(now)

    def reset_generation(self, keep_tokens=False):
        """Put the request back in ``queued`` for a re-run
        (restart/preemption).  ``keep_tokens=True`` is the
        prefill-replay arm: committed tokens, delivery times, and the
        measured TTFT all stand — the recovery prefill replays them
        without re-yielding.  ``keep_tokens=False`` is the legacy
        prompt-replay arm: generated state is discarded, and a stateful
        sampler rewinds to its initial capsule so the re-rolled stream
        reproduces the discarded one bit-for-bit."""
        if keep_tokens:
            self.requeues += 1
            self.state = "queued"
            self.timeline.mark_replay_requeue()
            return
        committed = len(self.tokens)
        self.tokens = []
        self.token_times = []
        self.first_token_at = None
        self.requeues += 1
        self.state = "queued"
        if self.sampler is not None:
            self.sampler.reset()
        self.timeline.mark_requeue(committed=committed)

    def _observe_ttft(self):
        # one serve.ttft_seconds sample per REQUEST, stamped at terminal
        # time from the final attempt's first token: a per-attempt
        # observe would let a restart's discarded attempt contribute an
        # extra, optimistic sample (no restart penalty) to exactly the
        # histogram the SLO monitor alerts on during an incident.
        # Deliberate tradeoff: the sample lands when the request ENDS,
        # so TTFT breach detection lags by the decode duration and
        # still-decoding requests are invisible to the window — fine at
        # this runtime's generation lengths; long-generation serving
        # would want an in-flight-aware read.
        if self.first_token_at is not None:
            _telemetry.histogram("serve.ttft_seconds").observe(self.ttft)
            _telemetry.histogram(
                "serve.ttft_seconds",
                tenant=label_for(self.tenant)).observe(self.ttft)

    def finish(self, reason="length"):
        self.state = "done"
        self.finish_reason = reason
        self.finished_at = time.perf_counter()
        self._observe_ttft()
        # per-tenant terminal count (the unlabeled completed/rejected
        # totals live at the scheduler/server seams, unchanged)
        _telemetry.counter("serve.requests", state="completed",
                           tenant=label_for(self.tenant)).inc()
        self.timeline.finalize(self.id, "done", ttft=self.ttft,
                               tenant=self.tenant)
        self._done.set()

    def fail(self, reason):
        self.state = "failed"
        self.finish_reason = reason
        self.finished_at = time.perf_counter()
        self._observe_ttft()
        outcome = ("rejected" if str(reason).startswith("rejected")
                   else "failed")
        _telemetry.counter("serve.requests", state=outcome,
                           tenant=label_for(self.tenant)).inc()
        self.timeline.finalize(self.id, outcome, ttft=self.ttft,
                               tenant=self.tenant)
        self._done.set()

    def wait(self, timeout=None):
        """Block until done/failed; returns the terminal state reached."""
        self._done.wait(timeout)
        return self.state

    def __repr__(self):
        return (f"Request({self.id}, state={self.state}, "
                f"prompt={len(self.prompt)}t, "
                f"generated={len(self.tokens)}/{self.max_new_tokens})")


class ContinuousBatchingScheduler:
    """Split prefill/decode queues with per-step continuous admission
    (policy details in the module docstring).

    **Multi-tenant fairness**: ``tenants`` (anything
    :meth:`~tpu_mx_torch.serving.tenancy.TenantTable.coerce` accepts) arms
    per-tenant policy.  Admission enforces each tenant's
    ``max_inflight``/``token_quota`` (reject reason ``tenant_quota``),
    and :meth:`take_prefills` becomes **SLO-weighted fair**: candidates
    are the per-tenant QUEUE HEADS (FIFO within a tenant — one tenant's
    oversized head no longer blocks every other tenant's admissible
    work), picked by weighted virtual time — each admission advances its
    tenant's clock by ``budget_tokens / effective_weight``, so admitted
    token bandwidth converges to the weight ratio, deficit-style.  A
    tenant whose per-tenant SLO burn is breaching (``slo_signal``, the
    server's hook — serving/slo.py publishes per-tenant burn when
    tenant-labeled series exist) gets its weight multiplied by
    ``slo_boost`` until the breach clears.  With a single tenant every
    rule degenerates to exactly the pre-tenancy FIFO behavior."""

    def __init__(self, max_pending=64, max_batch=8, max_tokens=8192,
                 tenants=None, slo_boost=2.0):
        self.max_pending = int(max_pending)
        self.max_batch = int(max_batch)
        self.max_tokens = int(max_tokens)
        self.tenants = TenantTable.coerce(tenants)
        self.slo_boost = float(slo_boost)
        self._lock = threading.RLock()
        self._pending = []
        self._running = []
        # weighted-fairness state: tenant -> virtual time (service
        # received / effective weight), plus the monotone SYSTEM floor:
        # the highest virtual time any pick has been served at.  A new
        # or long-idle tenant enters at max(own, floor) — it competes
        # from "now", not from a stale-low clock that would let it
        # monopolize admission for an unbounded catch-up period.  (For
        # continuously backlogged tenants the floor is provably inert:
        # a candidate with a lower clock would have been picked first.)
        self._vtime = {}
        self._vfloor = 0.0
        # requests popped by take_prefills but not yet running (the
        # mid-prefill window): in neither queue, but still in flight —
        # the tenant quota count must see them or a concurrent submit
        # in that window slips past max_inflight/token_quota.  Removed
        # at mark_running / defer / requeue.
        self._admitting = set()
        # the vtime charge each pending admission paid at pick time, so
        # a DEFERRED admission (cache backpressure, never started) can
        # be refunded — without the refund a tenant under memory
        # pressure is charged once per bounce while receiving zero
        # service, skewing the weight ratio against it
        self._vtime_charges = {}
        # the server publishes its SLO monitor's latest signal here each
        # step (tpu_mx/serving/slo.py) — take_prefills consults it for
        # the per-tenant burn-rate boost
        self.slo_signal = None
        # the capacity ledger's would-fit signal (the
        # symmetric twin of slo_signal, published by the server from
        # cache.capacity_stats each step): admission skips a prefill
        # whose blocks cannot fit free + pressure-reclaimable capacity
        # instead of popping it just to bounce on CacheExhausted.  None
        # (no server driving, or right after an engine restart) means
        # no gating — exactly the pre-ledger behavior.
        self.capacity_signal = None
        # per-request gate-skip counts: the would-fit need is computed
        # from the FULL prompt, but a shared-prefix hit may need far
        # fewer fresh blocks — after a bounded number of gated rounds
        # the head is admitted anyway (the pre-ledger pop-and-maybe-
        # defer path), so the gate can delay but never starve
        self._capacity_skips = {}

    # -- admission (any thread) ----------------------------------------------
    def _tenant_inflight(self, tenant):
        """(requests, budget tokens) admitted and unfinished for
        ``tenant`` — pending + running + the mid-prefill window
        (popped by ``take_prefills``, not yet ``mark_running``).
        Called under the lock; O(n) over bounded queues beats a
        drift-prone incremental counter."""
        n = toks = 0
        for bucket in (self._pending, self._running, self._admitting):
            for r in bucket:
                if r.tenant == tenant:
                    n += 1
                    toks += r.budget_tokens
        return n, toks

    def submit(self, req):
        """Enqueue ``req`` or raise :class:`AdmissionReject`."""
        if _chaos.forced_reject():
            self.reject(req, "reject_storm",
                         "chaos reject_storm injection armed")
        if req.budget_tokens > self.max_tokens:
            self.reject(
                req, "request_too_large",
                f"prompt+max_new = {req.budget_tokens} tokens > "
                f"max_tokens = {self.max_tokens}")
        cfg = self.tenants.get(req.tenant)
        with self._lock:
            # the reject itself (handle fail + timeline finalize +
            # telemetry + event) runs OUTSIDE the lock: a client-thread
            # reject burst must not block the step thread's queue ops
            quota = None
            if cfg.max_inflight is not None or cfg.token_quota is not None:
                n, toks = self._tenant_inflight(req.tenant)
                if cfg.max_inflight is not None and n >= cfg.max_inflight:
                    quota = (f"tenant {req.tenant!r} has {n} in-flight "
                             f">= max_inflight = {cfg.max_inflight}")
                elif cfg.token_quota is not None \
                        and toks + req.budget_tokens > cfg.token_quota:
                    quota = (f"tenant {req.tenant!r} in-flight worst case "
                             f"{toks} + {req.budget_tokens} tokens > "
                             f"token_quota = {cfg.token_quota}")
            depth = len(self._pending)
            full = quota is None and depth >= self.max_pending
            if quota is None and not full:
                self._pending.append(req)
        if quota is not None:
            self.reject(req, "tenant_quota", quota)
        if full:
            self.reject(
                req, "queue_full",
                f"{depth} pending >= max_pending = {self.max_pending}")
        _telemetry.counter("serve.requests", state="admitted").inc()
        _telemetry.gauge("serve.queue_depth").set(self.queue_depth())
        _tracing.emit("serve.admit", request=req.id,
                      prompt_tokens=len(req.prompt),
                      max_new_tokens=req.max_new_tokens,
                      tenant=req.tenant)
        return req

    def restore(self, req):
        """Re-admit a RECOVERED request (``server.recover``)
        with every admission gate bypassed: the dead process already
        admitted it, and its journaled ``begin`` IS the admission
        receipt.  A server killed at full load journals up to
        ``max_pending + max_batch`` unfinished streams (pending plus
        the running batch), so routing recovery through :meth:`submit`
        would ``queue_full``-reject the overflow and break the
        zero-lost-streams guarantee — this is the same deliberate cap
        bypass :meth:`requeue`/:meth:`defer` use for in-flight work.
        Appended (not fronted) so journal order is preserved."""
        with self._lock:
            self._pending.append(req)
        _telemetry.counter("serve.requests", state="admitted").inc()
        _telemetry.gauge("serve.queue_depth").set(self.queue_depth())
        _tracing.emit("serve.admit", request=req.id,
                      prompt_tokens=len(req.prompt),
                      max_new_tokens=req.max_new_tokens,
                      tenant=req.tenant, recovered=True)
        return req

    def reject(self, req, reason, detail=""):
        """Refuse ``req`` with full bookkeeping — fail the handle, count
        it, put it on the timeline — then raise :class:`AdmissionReject`.
        The ONE reject implementation; the server's own gates (pool-size,
        degraded) route through it too."""
        req.fail(f"rejected: {reason}")
        _telemetry.counter("serve.requests", state="rejected").inc()
        _tracing.emit("serve.reject", request=req.id, reason=reason)
        raise AdmissionReject(reason, detail)

    # -- per-step policy (the server's step thread) --------------------------
    def budget_used(self):
        with self._lock:
            return sum(r.budget_tokens for r in self._running)

    def _breaching_tenants(self):
        """Tenant LABELS whose per-tenant SLO burn is breaching, read
        off the last published ``slo_signal`` (tpu_mx/serving/slo.py
        adds a ``tenants`` sub-map per target when tenant-labeled
        series exist).  These are telemetry labels, not raw tenant ids:
        measurement happens under the cardinality-capped label, so a
        past-cap tenant breaches — and boosts — as the aggregated
        ``_other`` group.  Called under the lock; empty set when no
        monitor is armed."""
        sig = self.slo_signal
        if not sig:
            return frozenset()
        out = set()
        for st in sig.get("slos", {}).values():
            for tenant, ts in st.get("tenants", {}).items():
                if ts.get("breaching"):
                    out.add(tenant)
        return out

    def _effective_weight(self, tenant, boosted):
        """``boosted`` holds breaching LABELS — compare through
        ``label_for`` so a tenant measured under the overflow label
        still receives the boost its (aggregated) burn earned."""
        w = self.tenants.get(tenant).weight
        return w * self.slo_boost if label_for(tenant) in boosted else w

    # consecutive gated rounds before a head is admitted regardless: the
    # gate's need estimate ignores shared-prefix reuse (a fully cached
    # prompt may need ZERO fresh blocks), so it must be able to delay
    # but never starve — the escape hands the request to the ordinary
    # pop-and-maybe-defer path, which resolves the cached case exactly
    CAPACITY_GATE_MAX_SKIPS = 4

    def _fits_capacity(self, req):
        """Would-fit admission gate (under the lock): with a published
        ``capacity_signal``, a prefill whose block need exceeds free +
        optimistically-reclaimable capacity is left queued this step —
        popping it could only bounce on ``CacheExhausted`` and stall as
        a deferral.  The bound is approximate in BOTH directions
        (reclaimable is optimistic; the need ignores shared-prefix
        hits), so a gated head escapes after
        :data:`CAPACITY_GATE_MAX_SKIPS` rounds and an admitted prefill
        can still bounce into the ordinary defer path — the gate
        removes the common bounce, it never replaces backpressure."""
        sig = self.capacity_signal
        if not sig:
            return True
        bs = max(int(sig.get("block_size", 1)), 1)
        need = -(-len(req.prompt) // bs)
        if need <= (sig.get("free_blocks", 0)
                    + sig.get("reclaimable_blocks", 0)):
            self._capacity_skips.pop(req, None)
            return True
        skips = self._capacity_skips.get(req, 0) + 1
        if skips >= self.CAPACITY_GATE_MAX_SKIPS:
            self._capacity_skips.pop(req, None)   # anti-starvation escape
            return True
        self._capacity_skips[req] = skips
        return False

    def _pick_next(self, used):
        """The weighted-fair admission pick (under the lock): among the
        per-tenant queue heads that fit the remaining token budget AND
        the pool's would-fit capacity, the tenant with the LOWEST
        virtual time goes next (ties: queue order — ``heads`` preserves
        first-seen order, so keeping the earliest on equal vtime is
        FIFO).  Returns the request, or None when nothing admissible."""
        heads = {}
        for r in self._pending:
            if r.tenant not in heads:
                heads[r.tenant] = r
        if not heads:
            return None
        boosted = self._breaching_tenants()
        if len(heads) == 1:
            # single tenant: the pre-tenancy ORDER bit-for-bit,
            # including stop-at-the-head (no in-tenant reordering) —
            # but the clock still runs, so a tenant that served alone
            # does not look idle-cheap the moment a second one appears
            r = self._pending[0]
            if used + r.budget_tokens > self.max_tokens:
                return None
            if not self._fits_capacity(r):
                return None
            self._charge(r, boosted)
            return r
        best, best_vt = None, None
        for r in heads.values():
            if used + r.budget_tokens > self.max_tokens:
                continue
            if not self._fits_capacity(r):
                continue
            vt = max(self._vtime.get(r.tenant, 0.0), self._vfloor)
            if best is None or vt < best_vt:
                best, best_vt = r, vt
        if best is not None:
            self._charge(best, boosted)
            # bound the vtime map: tenant ids are client-controlled
            # strings, so an adversarial id-per-request stream would
            # otherwise grow it forever.  Pruning idle tenants is
            # harmless — the re-entry floor already handles a returning
            # tenant fairly.
            if len(self._vtime) > 4 * max(len(heads), 16):
                live = ({r.tenant for r in self._pending}
                        | {r.tenant for r in self._running}
                        | {r.tenant for r in self._admitting})
                self._vtime = {t: v for t, v in self._vtime.items()
                               if t in live}
        return best

    def _charge(self, req, boosted):
        """Advance the picked tenant's virtual clock and the system
        floor; remember the charge so a deferred (never-started)
        admission can be refunded on its way back to the queue."""
        vt = max(self._vtime.get(req.tenant, 0.0), self._vfloor)
        cost = req.budget_tokens / self._effective_weight(req.tenant,
                                                          boosted)
        self._vtime[req.tenant] = vt + cost
        self._vfloor = max(self._vfloor, vt)
        self._vtime_charges[req] = cost

    def take_prefills(self):
        """Pop the pending requests admissible THIS step: batch slots
        free and the worst-case token budget respected, ordered by the
        SLO-weighted fair policy across tenants (class docstring) —
        plain FIFO when one tenant is present.  Continuous: runs every
        step, so a finishing sequence's slot is refilled on the very
        next iteration."""
        out = []
        with self._lock:
            used = sum(r.budget_tokens for r in self._running)
            while (self._pending
                   and len(self._running) + len(out) < self.max_batch):
                req = self._pick_next(used)
                if req is None:
                    break
                self._pending.remove(req)
                self._admitting.add(req)
                used += req.budget_tokens
                out.append(req)
            if self._capacity_skips:
                # bound the skip ledger to requests still queued (a
                # drained/rejected request must not pin its handle)
                pending = set(self._pending)
                self._capacity_skips = {
                    r: n for r, n in self._capacity_skips.items()
                    if r in pending}
        if out:
            _telemetry.gauge("serve.queue_depth").set(self.queue_depth())
        return out

    def mark_running(self, req):
        with self._lock:
            req.state = "running"
            self._admitting.discard(req)
            self._vtime_charges.pop(req, None)   # service delivered
            self._running.append(req)

    def decode_batch(self):
        """The sequences to decode this step (continuous: every running,
        unfinished request — finished ones were already evicted)."""
        with self._lock:
            return list(self._running)

    def finish(self, req, reason="length"):
        """Mark ``req`` finished; returns the requests whose cache should
        be evicted NOW (continuous: immediately — the block pool is the
        scarce resource and a finished sequence holds it for no one).
        ``req.finish`` (terminal telemetry: TTFT observe, per-phase
        histograms, the timeline event) runs OUTSIDE the lock — only the
        step thread calls this, and holding the lock through it would
        serialize submitting threads against per-request telemetry."""
        req.finish(reason)
        with self._lock:
            if req in self._running:
                self._running.remove(req)
        return [req]

    def requeue(self, req, front=True, replay=False):
        """Bounce a running request back to pending for a re-run
        (engine restart, cache preemption).  ``replay=True`` (the
        server's prefill-replay arm) keeps its committed
        tokens — the recovery prefill replays them in one call;
        ``replay=False`` discards them (legacy prompt replay).
        ``front=True`` preserves arrival order fairness.  The vtime
        charge is NOT refunded: a requeued request consumed real
        service (its interrupted attempt) — unlike a deferral."""
        with self._lock:
            if req in self._running:
                self._running.remove(req)
            self._admitting.discard(req)
            self._vtime_charges.pop(req, None)
            req.reset_generation(keep_tokens=replay)
            if front:
                self._pending.insert(0, req)
            else:
                self._pending.append(req)
        _telemetry.counter("serve.requests", state="requeued").inc()
        _telemetry.gauge("serve.queue_depth").set(self.queue_depth())

    def defer(self, reqs):
        """Push admissions that never STARTED back to the queue front
        (prefill hit cache backpressure).  Unlike :meth:`requeue` this
        neither resets generation nor counts a requeue — a deferred
        request was not re-run, merely not admitted yet — and its
        pick-time vtime charge is REFUNDED: a tenant bouncing on memory
        pressure received no service, so charging it per bounce would
        skew the weighted ratio against exactly the tenant being
        starved."""
        with self._lock:
            for req in reqs:
                self._admitting.discard(req)
                charge = self._vtime_charges.pop(req, None)
                if charge is not None and req.tenant in self._vtime:
                    self._vtime[req.tenant] -= charge
            self._pending[0:0] = list(reqs)
        _telemetry.gauge("serve.queue_depth").set(self.queue_depth())

    def requeue_all_running(self, replay=False):
        """Engine restart / handoff: every in-flight sequence survives
        by going back to pending (newest first so fronted order stays
        FIFO).  ``replay`` as in :meth:`requeue`."""
        with self._lock:
            running = list(self._running)
        for req in reversed(running):
            self.requeue(req, front=True, replay=replay)
        return running

    def drain_running(self):
        """Remove and return every UNFINISHED in-flight request without
        requeueing (degraded shutdown: the server fails them — they were
        never re-admitted, so nothing counts as requeued)."""
        with self._lock:
            out = list(self._running)
            self._running = []
        return out

    def discard(self, req):
        """Drop a request from the scheduler's books with NO state
        change on the handle (a finished padding slot whose cache was
        preempted away — it already delivered its tokens)."""
        with self._lock:
            if req in self._running:
                self._running.remove(req)

    def drain_pending(self):
        """Remove and return EVERY pending request (degraded shutdown:
        the server fails them loudly instead of leaving them queued
        forever)."""
        with self._lock:
            out = list(self._pending)
            self._pending = []
        _telemetry.gauge("serve.queue_depth").set(0)
        return out

    # -- observables ---------------------------------------------------------
    def queue_depth(self):
        with self._lock:
            return len(self._pending)

    def running_count(self):
        with self._lock:
            return len(self._running)

    def idle(self):
        with self._lock:
            return not self._pending and not self._running


class StaticBatchingScheduler(ContinuousBatchingScheduler):
    """The naive static-batching baseline (the A/B arm — module
    docstring).  Admission waits for a FULL drain; finished sequences
    stay in the decode batch as padding (their decode output is
    discarded by the server) and their cache is only freed when the
    whole batch completes."""

    def __init__(self, max_pending=64, max_batch=8, max_tokens=8192,
                 tenants=None, slo_boost=2.0):
        super().__init__(max_pending=max_pending, max_batch=max_batch,
                         max_tokens=max_tokens, tenants=tenants,
                         slo_boost=slo_boost)
        self._finished = []

    def take_prefills(self):
        with self._lock:
            if self._running or self._finished:
                return []   # static: the whole batch must drain first
        return super().take_prefills()

    def decode_batch(self):
        # finished members keep their slot (and their padding decodes)
        # until the batch drains — the waste continuous batching removes
        with self._lock:
            return list(self._running) + list(self._finished)

    def finish(self, req, reason="length"):
        req.finish(reason)   # terminal telemetry outside the lock
        with self._lock:
            if req in self._running:
                self._running.remove(req)
                self._finished.append(req)
            if self._running:
                return []
            drained = list(self._finished)
            self._finished = []
        return drained

    def requeue_all_running(self, replay=False):
        with self._lock:
            # padding members' cache is freed by the server on restart
            # like everyone else's; only unfinished ones re-run
            self._finished = []
        return super().requeue_all_running(replay=replay)

    def drain_running(self):
        with self._lock:
            self._finished = []   # done already — nothing to fail
        return super().drain_running()

    def discard(self, req):
        with self._lock:
            if req in self._finished:
                self._finished.remove(req)
        super().discard(req)

    def idle(self):
        with self._lock:
            return (not self._pending and not self._running
                    and not self._finished)
