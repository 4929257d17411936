"""Request admission + continuous batching policy.

The port of ``tpu_mx/serving/scheduler.py``'s :class:`Request` and
:class:`ContinuousBatchingScheduler`.  The scheduler is pure policy: it
owns the **pending** queue (bounded — the backpressure boundary) and the
**running** set (the live decode batch), and decides each engine step
which requests to prefill and which sequences to decode.  It never
touches the model or the cache.

- **Continuous batching**: new requests join the running batch on EVERY
  step as slots and token budget allow, and finished sequences leave
  immediately — the batch never waits for its slowest member.
- **Admission control**: reject-with-reason gates before any memory is
  committed — ``queue_full``, ``request_too_large`` and the per-tenant
  ``tenant_quota``.  A reject is an :class:`AdmissionReject` with
  ``.reason``; nothing is dropped silently.
- **Token budget**: admission stops while the in-flight worst case
  (``sum(len(prompt) + max_new_tokens)`` over running) would exceed
  ``max_tokens``.
- **Weighted fairness** across tenants (serving/tenancy.py): candidates
  are the per-tenant queue heads, picked by weighted virtual time.

Not yet ported (ROADMAP): the static-batching baseline, the SLO-burn
weight boost, the capacity-ledger admission gate, journal recovery and
the chaos reject storm.

Thread-safety: all public methods take the scheduler lock; ``submit``
may be called from any thread while the server's step thread admits and
evicts.
"""
from __future__ import annotations

import itertools
import threading
import time

from ..base import MXNetError, refuse_unported
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from .tenancy import DEFAULT_TENANT, TenantTable, label_for
from .timeline import RequestTimeline

__all__ = ["Request", "AdmissionReject", "ContinuousBatchingScheduler"]

_req_counter = itertools.count()


class AdmissionReject(MXNetError):
    """The front-end refused this request; ``reason`` says why
    (``queue_full`` / ``request_too_large`` / ``tenant_quota``).  This is
    backpressure, not failure: the client resubmits later."""

    def __init__(self, reason, detail=""):
        super().__init__(f"request rejected: {reason}"
                         + (f" ({detail})" if detail else ""))
        self.reason = reason


class Request:
    """One generation request and its lifecycle record (the handle the
    front-end returns).

    States: ``queued`` → ``running`` → ``done`` (or ``failed``).  A
    request preempted for cache room goes back to ``queued`` with its
    committed tokens kept: the next prefill replays ``prompt + tokens``
    in one call and the stream continues where it stopped.
    ``requeues`` counts how often that happened."""

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
        self.tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        self.tenant_weight = 1.0
        self.sampler = None     # the server's per-request sampler (top-k)
        self.state = "queued"
        self.tokens = []
        self.finish_reason = None
        self.requeues = 0
        self.submitted_at = time.perf_counter()
        self.first_token_at = None
        self.finished_at = None
        self.token_times = []
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
            _telemetry.histogram("serve.itl_seconds",
                                 tenant=label_for(self.tenant)).observe(gap)
        self.token_times.append(now)
        self.tokens.append(int(token))
        self.timeline.mark_token(now)

    def requeue(self):
        """Back to ``queued`` after a preemption; committed tokens, their
        delivery times and the measured TTFT all stand."""
        self.requeues += 1
        self.state = "queued"
        self.timeline.mark_replay_requeue()

    def _observe_ttft(self):
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

    def __repr__(self):
        return (f"Request({self.id}, state={self.state}, "
                f"prompt={len(self.prompt)}t, "
                f"generated={len(self.tokens)}/{self.max_new_tokens})")


class ContinuousBatchingScheduler:
    """Split prefill/decode queues with per-step continuous admission
    (module docstring).  ``tenants`` (anything
    :meth:`~tpu_mx_torch.serving.tenancy.TenantTable.coerce` accepts)
    arms per-tenant quotas and weights; with one tenant the policy is
    plain FIFO."""

    def __init__(self, max_pending=64, max_batch=8, max_tokens=8192,
                 tenants=None, slo_boost=2.0):
        refuse_unported("ContinuousBatchingScheduler", "A12 (slo.py)",
                        slo_boost=(slo_boost, 2.0))
        self.max_pending = int(max_pending)
        self.max_batch = int(max_batch)
        self.max_tokens = int(max_tokens)
        self.tenants = TenantTable.coerce(tenants)
        self._lock = threading.RLock()
        self._pending = []
        self._running = []
        # weighted fairness: tenant -> virtual time (service received /
        # weight) and the monotone floor a returning tenant re-enters at
        self._vtime = {}
        self._vfloor = 0.0
        # popped by take_prefills, not yet running: still in flight for
        # the quota count
        self._admitting = set()
        # each admission's vtime charge, refunded if it is deferred
        self._vtime_charges = {}

    # -- admission (any thread) ----------------------------------------------
    def _tenant_inflight(self, tenant):
        """(requests, budget tokens) admitted and unfinished for
        ``tenant``.  Called under the lock."""
        n = toks = 0
        for bucket in (self._pending, self._running, self._admitting):
            for r in bucket:
                if r.tenant == tenant:
                    n += 1
                    toks += r.budget_tokens
        return n, toks

    def submit(self, req):
        """Enqueue ``req`` or raise :class:`AdmissionReject`."""
        if req.budget_tokens > self.max_tokens:
            self.reject(
                req, "request_too_large",
                f"prompt+max_new = {req.budget_tokens} tokens > "
                f"max_tokens = {self.max_tokens}")
        cfg = self.tenants.get(req.tenant)
        with self._lock:
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
                      max_new_tokens=req.max_new_tokens, tenant=req.tenant)
        return req

    def reject(self, req, reason, detail=""):
        """Refuse ``req`` with full bookkeeping — fail the handle, count
        it, put it on the timeline — then raise :class:`AdmissionReject`."""
        req.fail(f"rejected: {reason}")
        _telemetry.counter("serve.requests", state="rejected").inc()
        _tracing.emit("serve.reject", request=req.id, reason=reason)
        raise AdmissionReject(reason, detail)

    # -- per-step policy (the server's step thread) --------------------------
    def _pick_next(self, used):
        """The weighted-fair pick (under the lock): among the per-tenant
        queue heads that fit the remaining token budget, the tenant with
        the lowest virtual time (ties: queue order).  With one tenant,
        the queue head or nothing."""
        heads = {}
        for r in self._pending:
            heads.setdefault(r.tenant, r)
        best, best_vt = None, None
        for r in heads.values():
            if used + r.budget_tokens > self.max_tokens:
                continue
            vt = max(self._vtime.get(r.tenant, 0.0), self._vfloor)
            if best is None or vt < best_vt:
                best, best_vt = r, vt
        if best is not None:
            cost = best.budget_tokens / self.tenants.get(best.tenant).weight
            self._vtime[best.tenant] = best_vt + cost
            self._vfloor = max(self._vfloor, best_vt)
            self._vtime_charges[best] = cost
        return best

    def take_prefills(self):
        """Pop the pending requests admissible THIS step: batch slots
        free and the worst-case token budget respected."""
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
        if out:
            _telemetry.gauge("serve.queue_depth").set(self.queue_depth())
        return out

    def mark_running(self, req):
        with self._lock:
            req.state = "running"
            self._admitting.discard(req)
            self._vtime_charges.pop(req, None)
            self._running.append(req)

    def decode_batch(self):
        """The sequences to decode this step (every running request)."""
        with self._lock:
            return list(self._running)

    def finish(self, req, reason="length"):
        """Mark ``req`` finished and drop it from the running set; the
        server evicts its cache at once."""
        req.finish(reason)
        with self._lock:
            if req in self._running:
                self._running.remove(req)

    def requeue(self, req, front=True):
        """Bounce a running request back to pending (cache preemption),
        its committed tokens kept: the next prefill replays them (the
        reference's ``replay=True`` arm).  ``front`` keeps arrival-order
        fairness."""
        with self._lock:
            if req in self._running:
                self._running.remove(req)
            self._admitting.discard(req)
            self._vtime_charges.pop(req, None)
            req.requeue()
            if front:
                self._pending.insert(0, req)
            else:
                self._pending.append(req)
        _telemetry.counter("serve.requests", state="requeued").inc()
        _telemetry.gauge("serve.queue_depth").set(self.queue_depth())

    def defer(self, reqs):
        """Push admissions that never STARTED back to the queue front
        (prefill hit cache backpressure), refunding their vtime charge."""
        with self._lock:
            for req in reqs:
                self._admitting.discard(req)
                charge = self._vtime_charges.pop(req, None)
                if charge is not None and req.tenant in self._vtime:
                    self._vtime[req.tenant] -= charge
            self._pending[0:0] = list(reqs)
        _telemetry.gauge("serve.queue_depth").set(self.queue_depth())

    # -- observables ---------------------------------------------------------
    def queue_depth(self):
        with self._lock:
            return len(self._pending)

    def idle(self):
        with self._lock:
            return not self._pending and not self._running
