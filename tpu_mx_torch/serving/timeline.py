"""Per-request latency attribution: every request's wall clock, typed.

A copy of ``tpu_mx/serving/timeline.py``.  Each :class:`~tpu_mx_torch.serving.scheduler.Request` owns a
:class:`RequestTimeline` that decomposes its lifetime — submit to
finish/fail — into typed phases stamped at the scheduler/engine/server
seams:

- ``queue_wait``   — pending-queue time before a prefill attempt starts
- ``prefill``      — the prompt's engine prefill
- ``decode_gap``   — per token: from the previous committed token (or
  prefill end) to this commit — scheduler share and decode compute both
- ``restart_penalty`` — what an engine restart or a cache preemption
  cost this request: the in-flight interval at the fault, the wait until
  its recovery starts, and the recovery work — the one replay prefill
  (``replay=True``), or on the legacy prompt-replay arm the re-run
  prefill plus every re-decoded catch-up token
- ``defer_stall``  — cache-backpressure deferrals: the wait after a
  prefill admission bounced on ``CacheExhausted``
- ``reject``       — the (tiny) interval a rejected admission consumed

The accounting is interval-complete by construction: one ``_mark``
cursor advances monotonically from ``submitted_at`` and every seam
closes ``[mark, now]`` into exactly one phase, so the phases sum to the
measured wall clock.  At the first token the sums are snapshotted as
``ttft_breakdown``.  One ``serve.request_timeline`` event per request
is emitted at finish/fail, and each phase total lands in the
``serve.phase_seconds{phase=...}`` histogram.
"""
from __future__ import annotations

import time

from .. import telemetry as _telemetry
from .. import tracing as _tracing

__all__ = ["PHASES", "RequestTimeline"]

PHASES = ("queue_wait", "prefill", "decode_gap", "restart_penalty",
          "defer_stall", "reject")


class RequestTimeline:
    """See module docstring.  ``t0`` is the request's ``submitted_at``
    (the same ``perf_counter`` reading, so the attribution and the SLO
    bookkeeping share one clock)."""

    __slots__ = ("t0", "_mark", "_wait_kind", "_in_flight", "phases",
                 "defers", "requeues", "tokens", "ttft_breakdown",
                 "_first_token_pending", "ended_at", "outcome",
                 "cached_tokens", "_replay_pending", "_catchup")

    def __init__(self, t0=None):
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self._mark = self.t0
        self._wait_kind = "queue_wait"   # what the NEXT wait interval is
        self._in_flight = False          # prefill done, decoding
        self.phases = {}
        self.defers = 0
        self.requeues = 0
        self.tokens = 0
        self.ttft_breakdown = None
        self._first_token_pending = True
        self.ended_at = None
        self.outcome = None
        self.cached_tokens = 0           # prompt tokens the last prefill
        #                                  took from the prefix cache
        self._replay_pending = False     # next prefill is a replay
        self._catchup = 0                # legacy re-decodes still owed

    def _close(self, phase, now=None):
        """Close ``[mark, now]`` into ``phase`` and advance the mark."""
        now = time.perf_counter() if now is None else now
        if now > self._mark:
            self.phases[phase] = (self.phases.get(phase, 0.0)
                                  + (now - self._mark))
            self._mark = now
        return self._mark

    # -- seams (server/scheduler call these) ---------------------------------
    def mark_prefill_start(self):
        """The server picked this request's prefill: the wait so far was
        queue_wait (or restart_penalty/defer_stall after a requeue or
        deferral)."""
        self._close(self._wait_kind)
        self._wait_kind = "queue_wait"

    def mark_prefill_end(self, cached_tokens=0):
        """A replay prefill (after a preemption) is recovery work: it
        closes into ``restart_penalty``, keeping ``prefill`` comparable
        across preempted and clean requests.  ``cached_tokens`` is how
        many leading prompt tokens this prefill took from the shared
        prefix cache (a fast ``prefill`` then reads as a cache hit)."""
        self._close("restart_penalty" if self._replay_pending
                    else "prefill")
        self._replay_pending = False
        self._in_flight = True
        self.cached_tokens = int(cached_tokens)

    def mark_prefill_failed(self):
        """The prefill attempt bounced on cache backpressure: the attempt
        itself, and the wait until the retry starts, are a defer stall."""
        self._close("defer_stall")
        self._wait_kind = "defer_stall"
        self._in_flight = False
        self.defers += 1

    def mark_defer(self):
        """Deferred before starting (an earlier admission in the same
        step exhausted the cache): the wait so far keeps its label, the
        wait from here to the retried prefill is a defer stall."""
        self._close(self._wait_kind)
        self._wait_kind = "defer_stall"
        self.defers += 1

    def mark_token(self, now=None):
        """A token committed: the gap since the previous commit (or the
        prefill end) is decode_gap.  The first token snapshots the
        cumulative phase sums — the TTFT breakdown.  On the legacy
        prompt-replay arm the first ``committed`` tokens after a requeue
        are catch-up re-decodes the client already had: restart penalty
        (each counts ``serve.redecode_tokens``)."""
        if self._catchup > 0:
            self._catchup -= 1
            self._close("restart_penalty", now)
            _telemetry.counter("serve.redecode_tokens").inc()
        else:
            self._close("decode_gap", now)
        self.tokens += 1
        if self._first_token_pending:
            self._first_token_pending = False
            self.ttft_breakdown = dict(self.phases)

    def mark_requeue(self, committed=0):
        """A restart or preemption discarded this request's generation
        (the legacy prompt-replay arm): the in-flight interval, and
        everything until the re-run's prefill starts, is restart penalty,
        and the re-run's first ``committed`` decodes are catch-up.  The
        first-token snapshot resets with the generation."""
        self._close("restart_penalty")
        self._wait_kind = "restart_penalty"
        self._in_flight = False
        self.requeues += 1
        self.tokens = 0
        self.cached_tokens = 0
        self._catchup += int(committed)
        self._first_token_pending = True
        self.ttft_breakdown = None

    def mark_replay_requeue(self):
        """A restart, handoff or preemption requeued this request; its
        committed tokens stand.  Everything from here to the end of the one replay
        prefill is restart penalty."""
        self._close("restart_penalty")
        self._wait_kind = "restart_penalty"
        self._in_flight = False
        self.requeues += 1
        self._replay_pending = True

    # -- terminal ------------------------------------------------------------
    def finalize(self, request_id, outcome, ttft=None, now=None,
                 tenant=None):
        """Close the books (idempotent) and emit the one-per-request
        ``serve.request_timeline`` event + phase histograms."""
        if self.ended_at is not None:
            return
        if outcome == "rejected":
            self._close("reject", now)
        elif outcome != "done":
            self._close("decode_gap" if self._in_flight
                        else self._wait_kind, now)
        self.ended_at = self._mark
        self.outcome = outcome
        for phase, seconds in self.phases.items():
            _telemetry.histogram("serve.phase_seconds",
                                 phase=phase).observe(seconds)
        payload = {p: self.phases.get(p, 0.0) for p in PHASES}
        if ttft is not None:
            payload["ttft"] = float(ttft)
        if tenant is not None:
            payload["tenant"] = str(tenant)
        _tracing.emit("serve.request_timeline", request=request_id,
                      outcome=outcome, latency=self.ended_at - self.t0,
                      tokens=self.tokens, requeues=self.requeues,
                      defers=self.defers, cached_tokens=self.cached_tokens,
                      **payload)

    @property
    def total(self):
        """Sum of all attributed phases (== ended_at - t0 once
        finalized)."""
        return sum(self.phases.values())
