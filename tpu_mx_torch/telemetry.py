"""Runtime telemetry: counters, gauges and windowed histograms.

A copy of ``tpu_mx/telemetry.py``'s registry (stdlib only, so copied
rather than imported — importing ``tpu_mx`` would import jax).  Metric
names are the reference's (``serve.*``), so a dashboard reads both
packages alike:

- **Registry**: :func:`counter` / :func:`gauge` / :func:`histogram`
  create-or-fetch named metrics; ``key=value`` labels make distinct
  series (:func:`series` lists them).  Thread-safe.
- **Sliding windows**: every counter and histogram also keeps a ring of
  subwindows covering the trailing :data:`WINDOW_SECONDS`, so "p99 over
  the last minute" (``window_quantile``), SLO attainment
  (``window_fraction_le``) and windowed rates are O(subwindows x
  buckets) reads — the serving SLO monitor (``serving/slo.py``) sits on
  them.  The serving latency pair uses the dense
  :data:`SLO_LATENCY_BUCKETS` ladder.
- **Spans** (:class:`span`) time a region into a histogram.
- **Export**: :func:`snapshot` (one record per metric, schema checked by
  :func:`validate_record`), :func:`flush` (JSONL append to ``path`` or
  ``TPUMX_TELEMETRY``; ``final=True`` rewrites the file through
  ``checkpoint.atomic_write``) and :func:`exposition` (the Prometheus
  text format).  Every export refreshes the ``host.rss_bytes`` and
  ``tracing.events_dropped`` gauges first; :func:`set_fleet_identity`
  stamps every record with a rank and a membership generation.
- **Catalog**: :data:`KNOWN_METRICS` lists every metric name, the
  reference's and the port's own (``rnn.arm``,
  ``serve.prefill_attention``, ``serve.forensic_dump_failures``).
"""
from __future__ import annotations

import atexit
import json
import math
import os
import re
import sys
import threading
import time
from bisect import bisect_left

__all__ = ["counter", "gauge", "histogram", "span", "get", "series",
           "reset", "snapshot", "flush", "exposition", "validate_record",
           "set_fleet_identity", "fleet_identity", "muted",
           "configured_path", "Counter", "Gauge", "Histogram",
           "KNOWN_METRICS", "LATENCY_BUCKETS", "SEGMENT_OPS_BUCKETS",
           "SLO_LATENCY_BUCKETS", "WINDOW_SECONDS", "WINDOW_SUBWINDOWS",
           "quantile_from_cumulative", "fraction_le_from_cumulative",
           "parse_slo_spec", "DEFAULT_SLOS", "ATTRIBUTION_TOLERANCE"]

# fixed log-scale latency buckets, in SECONDS: 10µs → 30s in 1–3–10 steps.
# Fixed — never derived from data — so histograms from any two runs merge.
LATENCY_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                   0.1, 0.3, 1.0, 3.0, 10.0, 30.0)

# count-valued buckets for fusion segment lengths (power-of-two edges)
SEGMENT_OPS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def _geometric_ladder(lo, hi, ratio):
    out, v = [], float(lo)
    while v < hi:
        out.append(round(v, 12))
        v *= ratio
    out.append(float(hi))
    return tuple(out)


# The SLO ladder: a denser fixed geometric grid (ratio 1.05, ~306 edges
# over the same 10µs→30s span) for the serving latency histograms.  The
# 1–3–10 ladder is fine for dashboards but a 3× bucket cannot support a
# "p99 within 10% of exact" claim.  The bucket-merge estimate is
# guaranteed within ONE bucket of the exact percentile, and a sparse
# tail (p99 of a 64-request trace rides its top two order statistics)
# realizes that worst case — so the ratio is sized to make one bucket
# ≈ ±5%, keeping a 10% live-vs-exact bar honest rather than lucky.  ~2.5 KB of ints per histogram series; observe
# cost is one bisect (9 compares).  Fixed like every other ladder
# (derived from a formula, never from data) so any two runs' snapshots
# merge.
SLO_LATENCY_BUCKETS = _geometric_ladder(1e-5, 30.0, 1.05)

# Sliding-window defaults: every Counter/Histogram additionally keeps a
# ring of subwindows covering the trailing WINDOW_SECONDS, so "p99 over
# the last minute" is an O(buckets) read with bounded memory
# (subwindows × buckets ints per histogram).  configure_window() resizes
# a metric's ring (resetting its window contents, never the cumulative
# state).
WINDOW_SECONDS = 60.0
WINDOW_SUBWINDOWS = 15

# Per-name bucket defaults, applied when histogram() is called without
# explicit buckets — every creation site agrees on the edges without
# repeating them (first-creation-wins would otherwise make the edges
# depend on call order).
_DEFAULT_BUCKETS = {
    "serve.ttft_seconds": SLO_LATENCY_BUCKETS,
    "serve.itl_seconds": SLO_LATENCY_BUCKETS,
    "serve.phase_seconds": SLO_LATENCY_BUCKETS,
}

# The stable metric-name catalog, the reference's names (a dashboard reads
# both packages alike) and, at its end, the port's own.
KNOWN_METRICS = frozenset({
    # fusion engine (fusion.py)
    "fusion.flushes", "fusion.flush_cause", "fusion.segment_ops",
    "fusion.ops_fused", "fusion.segments_dead",
    "fusion.cache_hits", "fusion.cache_misses", "fusion.eager_fallbacks",
    # durability layer (checkpoint.py; save_seconds is the span at
    # the whole-checkpoint save sites, write_seconds the per-file commit)
    "checkpoint.save_seconds", "checkpoint.write_seconds",
    "checkpoint.verify_seconds", "checkpoint.atomic_writes",
    "checkpoint.retries", "checkpoint.corrupt_detected",
    # elastic resume (elastic.py)
    "elastic.resume_attempts", "elastic.epochs_skipped_corrupt",
    "elastic.legacy_fallbacks",
    # compiled train step (parallel/train_step.py)
    "train_step.seconds", "train_step.steps", "train_step.recompiles",
    "train_step.examples_per_sec",
    # kvstore eager path (kvstore.py).  checksums counts payload
    # digests recorded at push time, checksum_failures the pulls whose
    # aggregate no longer matched — silent corruption crossing the sync
    # seam, raised loudly as kvstore.IntegrityError
    "kvstore.pushes", "kvstore.pulls",
    "kvstore.push_bytes", "kvstore.pull_bytes",
    "kvstore.checksums", "kvstore.checksum_failures",
    # self-healing supervisor (supervisor.py; corruptions counts
    # DataCorruption verdicts the classify discipline handled)
    "supervisor.restarts", "supervisor.rollbacks",
    "supervisor.corruptions",
    "supervisor.batches_skipped", "supervisor.watchdog_fires",
    "supervisor.degraded",
    # SDC defense plane (parallel/integrity.py,
    # docs/robustness.md "Silent data corruption defense").
    # fingerprints counts published cross-replica digests, votes the
    # cohort comparisons, mismatches the disagreeing votes (corruption
    # verdicts); verified_step is a gauge: the newest step PROVEN clean
    # by an all-agree vote (the rollback anchor, carried by the
    # capsule).  shadow_audits / shadow_mismatches count sampled
    # bit-exact re-executions and their failures (the dp=1 detector);
    # self_checks / self_check_mismatches are the serving decode twin;
    # quarantined counts ranks permanently barred by a corruption
    # verdict (fleet.quarantine — never re-admitted).
    "integrity.fingerprints", "integrity.votes", "integrity.mismatches",
    "integrity.verified_step",
    "integrity.shadow_audits", "integrity.shadow_mismatches",
    "integrity.self_checks", "integrity.self_check_mismatches",
    "integrity.quarantined",
    # deterministic-resume capsules (resume.py; resume_step_gap is
    # the batches a recovery could NOT replay exactly — 0 under capsules,
    # and the soak CI tier fails if it is ever nonzero)
    "resume.capsules_written", "resume.capsule_restore_seconds",
    "resume.resume_step_gap",
    # fault injection (contrib/chaos.py)
    "chaos.injections",
    # elastic fleet membership (parallel/fleet.py + tools/launch.py
    # --supervise; docs/robustness.md "Elastic fleets").  membership_epoch
    # is the monotone fleet generation this process has adopted (a gauge —
    # its value IS the current membership epoch); reshards counts
    # world-size transitions driven through the reshard seam; rejoins
    # counts members re-admitted at a new membership epoch; lost_workers
    # counts members evicted (heartbeat-lease expiry or launcher-observed
    # death); worker_restarts counts fleet-supervisor restarts of
    # preempted local workers; heartbeats counts liveness beats written
    # (suppressed beats under the partition_worker fault are NOT counted —
    # their absence is the observable).
    "fleet.membership_epoch", "fleet.reshards", "fleet.rejoins",
    "fleet.lost_workers", "fleet.worker_restarts", "fleet.heartbeats",
    # fleet observability plane (parallel/fleet_obs.py
    # + tools/launch.py --supervise; docs/observability.md "Fleet
    # observability").  obs_records counts telemetry records this worker
    # shipped to <fleet_dir>/obs/rank-N.jsonl; the rest are the
    # CONTROLLER'S rollups: step_rate is fleet-wide steps/sec summed
    # over reporting ranks' windows; ranks_reporting counts ranks whose
    # shipped snapshot the last aggregation pass actually merged (a
    # missing rank is a reported gap, never interpolated);
    # agg_lag_seconds is the age of the OLDEST shipped snapshot the pass
    # consumed; step_skew_seconds is the max-min cross-rank wall clock
    # of the latest (epoch, step, generation)-correlated step;
    # straggler_signal is the windowed persistent-straggler detector's
    # 0/1 state and straggler_rank the rank it attributes (-1 = none) —
    # the scheduler.slo_signal/capacity_signal twin the fleet
    # supervisor surfaces in evict/degrade decisions.
    "fleet.obs_records", "fleet.step_rate", "fleet.ranks_reporting",
    "fleet.agg_lag_seconds", "fleet.step_skew_seconds",
    "fleet.straggler_signal", "fleet.straggler_rank",
    # flight recorder (tracing.py; event NAMES live in its own
    # KNOWN_EVENTS catalog — blackbox_dumps counts black boxes persisted,
    # events_dropped surfaces tracing.stats()["dropped"] as a gauge
    # refreshed at flush/black-box time so silent ring overflow is
    # visible on dashboards, not only in-process)
    "tracing.blackbox_dumps", "tracing.events_dropped",
    # inference serving runtime (serving/; docs/serving.md).  The
    # SLO pair: ttft = submit→first token (queueing + prefill), itl = the
    # gap between consecutive generated tokens — p50/p99 read off the
    # fixed latency buckets.  requests{state} counts every admission
    # outcome (admitted/rejected/completed/requeued); decode_steps and
    # generated_tokens are the throughput numerators; queue_depth /
    # cache_utilization are the backpressure observables.
    "serve.ttft_seconds", "serve.itl_seconds",
    "serve.tokens_per_sec", "serve.queue_depth", "serve.cache_utilization",
    "serve.requests", "serve.engine_restarts",
    "serve.decode_steps", "serve.generated_tokens",
    # decode data plane: which attention arm each call took
    # (kind=dense/paged/paged-kernel) and whether the KV block pool is
    # device-resident (1.0) or host numpy (0.0)
    "serve.decode_attention", "serve.pool_device_resident",
    # whole-step fused decode + speculative windows.
    # fused_steps counts decode steps run as ONE jitted device program
    # (serving/jax_model.py); host_crossings counts host<->device
    # boundary crossings the decode step paid (a constant 3 per fused
    # step vs 4 per LAYER host-resident) and host_crossings_per_token
    # is that step's crossings amortized over the tokens it emitted —
    # the O(1)-vs-O(layers) receipt.  spec_drafted / spec_accepted
    # count proposer-drafted tokens and the verified prefix tokens the
    # engine accepted; spec_accept_ratio is their lifetime quotient
    # (serving/speculative.py — correctness never depends on it).
    "serve.fused_steps", "serve.host_crossings",
    "serve.host_crossings_per_token",
    "serve.spec_drafted", "serve.spec_accepted",
    "serve.spec_accept_ratio",
    # SLO engine (serving/slo.py + timeline.py).
    # phase_seconds{phase=...} is the per-request attribution total for
    # each typed phase (queue_wait/prefill/decode_gap/restart_penalty/
    # defer_stall/reject); the slo_* gauges are the live monitor state —
    # windowed quantile estimate, good-fraction attainment and
    # error-budget burn rate per (slo, window), and the 0/1 breach flag
    # the scheduler hook consumes.
    "serve.phase_seconds",
    "serve.slo_estimate_seconds", "serve.slo_attainment",
    "serve.slo_burn_rate", "serve.slo_breaching",
    # multi-tenant serving (serving/prefix_cache.py +
    # tenancy.py).  prefill_bytes counts K/V bytes a prefill COMPUTED,
    # prefill_bytes_saved the bytes served from the shared-prefix index
    # instead (the bench receipt's ">= 2x reduction" pair);
    # prefix_hit_ratio is cached/total prompt tokens over the cache's
    # lifetime; cow_copies counts copy-on-write tail-block duplications;
    # prefix_evictions counts index entries released under pool
    # pressure.  slo_tenant_burn_rate{slo,tenant} is the per-tenant
    # worst-window burn the fairness boost consumes — tenant labels are
    # cardinality-capped (tenancy.label_for: first N tenants keep their
    # name, the rest collapse into the "_other" overflow label).
    "serve.prefix_hits", "serve.prefix_hit_ratio",
    "serve.prefill_bytes", "serve.prefill_bytes_saved",
    "serve.prefix_evictions", "serve.cow_copies",
    "serve.slo_tenant_burn_rate",
    # capacity accounting (serving/accounting.py).
    # pool_bytes{tenant,kind} is the per-tenant block-pool attribution —
    # kind=amortized (1/refcount share of shared blocks; sums across
    # tenants to pool_used_bytes EXACTLY, the CI-gated identity) or
    # kind=exclusive (the full-block exclusive-if-forked cost).
    # pool_fragmentation is the free-list contiguity signal,
    # pool_high_watermark_bytes the lifetime peak, prefix_index_bytes
    # the shared-prefix index's amortized residency, pool_pinned_blocks
    # the references pinned by in-flight prefill plans.
    "serve.pool_bytes", "serve.pool_used_bytes",
    "serve.pool_fragmentation", "serve.pool_high_watermark_bytes",
    "serve.prefix_index_bytes", "serve.pool_pinned_blocks",
    # zero-regeneration recovery (serving/journal.py +
    # the prefill-replay restart path).  journal_requests/tokens/bytes
    # count durable admissions, committed-token records, and bytes
    # fsync'd to the append-only journal.  replay_requests/replay_tokens
    # count restart recoveries that re-established a stream with ONE
    # prefill and the already-committed tokens that prefill replayed
    # (vs serve.decode_steps — the "zero re-decoded steps" receipt);
    # redecode_tokens counts tokens the LEGACY prompt-replay arm
    # regenerated one decode step at a time (the A/B cost the CI gate
    # compares); replay_fallbacks counts streams a torn/corrupt journal
    # loudly degraded to prompt replay.
    "serve.journal_requests", "serve.journal_tokens",
    "serve.journal_bytes",
    "serve.replay_requests", "serve.replay_tokens",
    "serve.replay_fallbacks", "serve.redecode_tokens",
    # training-side capacity twins: jit builds per batch
    # shape-signature and their wall-clock (first-call XLA compile
    # included), the newest checkpoint's manifest bytes-on-disk, and
    # the process's host resident set (refreshed at every flush /
    # black-box export, like tracing.events_dropped)
    "train_step.compiles", "train_step.compile_seconds",
    "checkpoint.bytes_on_disk", "host.rss_bytes",
    # module-API training (callback.py)
    "speedometer.samples_per_sec",
    # the port's own: the recurrence arm an RNN call took
    # (ndarray/rnn_op.py), the prefill attention arm (serving),
    # capacity forensic dumps that failed (serving/kv_cache.py), and the
    # bytes and wall seconds of mesh collectives staged through the host
    # (parallel/collectives.py: CUDA tensors over a gloo group)
    "rnn.arm", "serve.prefill_attention", "serve.forensic_dump_failures",
    "mesh.host_staged_bytes", "mesh.host_staged_seconds",
})

_lock = threading.RLock()
_metrics: dict = {}          # (name, labels_tuple) -> metric object

# the fleet identity every exported record carries once set: this
# process's rank and the membership generation the snapshot reflects.
# Both None (the default) stamps nothing.
_fleet_identity = {"rank": None, "generation": None}
_UNSET = object()


def set_fleet_identity(rank=_UNSET, generation=_UNSET):
    """Stamp every subsequently exported record with this process's
    fleet identity (plain labels: ``rank``, ``fleet_generation``).
    Omitted fields keep their value; None clears one."""
    with _lock:
        if rank is not _UNSET:
            _fleet_identity["rank"] = None if rank is None else int(rank)
        if generation is not _UNSET:
            _fleet_identity["generation"] = \
                None if generation is None else int(generation)


def fleet_identity():
    """The live ``(rank, generation)`` stamp, or ``(None, None)``."""
    with _lock:
        return _fleet_identity["rank"], _fleet_identity["generation"]

# the window clock.  Monotonic (a wall-clock step must not expire or
# resurrect subwindows); module-level so tests can substitute a fake
# clock and drive subwindow rollover deterministically.
_monotonic = time.monotonic


def _labels_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _WindowRing:
    """Ring of ``n`` subwindow slots covering the trailing ``seconds``.

    Each slot is stamped with the epoch (``monotonic // slot_seconds``)
    it belongs to; writing into a slot whose stamp is stale resets it
    first, and reads simply skip slots whose epoch has rotated out — so
    neither writes nor reads ever pay more than O(n) and memory is
    bounded no matter how long the process runs.  All methods are called
    under the registry lock."""

    __slots__ = ("seconds", "n", "slot_seconds", "epochs", "slots",
                 "created", "_make_slot")

    def __init__(self, seconds, n, make_slot):
        seconds = float(seconds)
        n = int(n)
        if seconds <= 0 or n < 2:
            raise ValueError("window needs seconds > 0 and >= 2 subwindows")
        self.seconds = seconds
        self.n = n
        self.slot_seconds = seconds / n
        self.epochs = [-1] * n
        self.slots = [make_slot() for _ in range(n)]
        self.created = _monotonic()
        self._make_slot = make_slot

    def slot(self):
        """The live slot for the current epoch (reset if stale)."""
        e = int(_monotonic() // self.slot_seconds)
        i = e % self.n
        if self.epochs[i] != e:
            self.epochs[i] = e
            self.slots[i] = self._make_slot()
        return self.slots[i]

    def live(self, window=None):
        """(covered_seconds, [slot, ...]) for the trailing ``window``
        (clamped to the ring horizon; quantized to whole subwindows).
        ``covered`` is additionally clamped to the ring's AGE (floored
        at one subwindow): a 5 s-old ring must not claim 60 s of
        coverage, or every rate derived from it under-reports ~12x
        during exactly the warm-up an operator watches."""
        if window is None:
            horizon = self.seconds
        else:
            horizon = min(max(float(window), self.slot_seconds),
                          self.seconds)
        k = max(1, min(self.n, int(math.ceil(horizon / self.slot_seconds
                                             - 1e-9))))
        now = _monotonic()
        e = int(now // self.slot_seconds)
        out = [self.slots[i] for i in range(self.n)
               if self.epochs[i] >= 0 and e - self.epochs[i] < k]
        covered = min(k * self.slot_seconds,
                      max(now - self.created, self.slot_seconds))
        return covered, out


class _Metric:
    __slots__ = ("name", "labels")
    kind = None

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels


class Counter(_Metric):
    """Monotonically increasing count (resets only with the process).
    Additionally keeps a subwindow ring so :meth:`window_delta` /
    :meth:`window_rate` answer "how many in the last N seconds" without
    a scraper diffing snapshots."""

    __slots__ = ("value", "_win")
    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0
        self._win = _WindowRing(WINDOW_SECONDS, WINDOW_SUBWINDOWS,
                                lambda: [0])

    def inc(self, n=1):
        with _lock:
            self.value += n
            self._win.slot()[0] += n
        return self

    def configure_window(self, seconds, subwindows=None):
        """Resize the subwindow ring (resets the WINDOW contents only;
        the cumulative value is untouched)."""
        with _lock:
            self._win = _WindowRing(seconds,
                                    subwindows or WINDOW_SUBWINDOWS,
                                    lambda: [0])
        return self

    def window_delta(self, window=None):
        """Increments observed over the trailing ``window`` seconds
        (default: the full ring horizon, quantized to subwindows)."""
        with _lock:
            _, slots = self._win.live(window)
            return sum(s[0] for s in slots)

    def window_rate(self, window=None):
        """Increments per second over the trailing window."""
        with _lock:
            covered, slots = self._win.live(window)
            return sum(s[0] for s in slots) / covered

    def _record(self, ts):
        rec = _rec(self, ts, self.value)
        with _lock:
            covered, slots = self._win.live()
            rec["window"] = {"seconds": covered,
                             "value": sum(s[0] for s in slots)}
        return rec


class Gauge(_Metric):
    """Last-written value (e.g. examples/sec)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, value):
        with _lock:
            self.value = float(value)
        return self

    def _record(self, ts):
        return _rec(self, ts, self.value)


class Histogram(_Metric):
    """Fixed-bucket distribution; default buckets are the log-scale
    latency ladder (:data:`LATENCY_BUCKETS`, seconds).  Tracks count, sum,
    min and max alongside the cumulative bucket counts.  ``unit`` rides
    the JSONL record so renderers know whether ms-scaling applies.

    Every histogram additionally maintains a **sliding window**: a ring
    of subwindow slots (each a full bucket array + count/sum/min/max)
    covering the trailing :data:`WINDOW_SECONDS`.  Merging the live
    slots answers "p99 over the last N seconds" in O(subwindows ×
    buckets) with bounded memory — the live-SLO read the serving
    monitor (serving/slo.py) sits on."""

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max", "unit",
                 "dropped_nonfinite", "_win")
    kind = "histogram"

    def __init__(self, name, labels, buckets=None, unit="seconds"):
        super().__init__(name, labels)
        self.unit = unit
        # sorted + deduped so cumulative()/exposition() emit `le` bounds
        # in ascending order with +Inf last, per the Prometheus text
        # format, whatever order a caller passed
        self.buckets = tuple(sorted({float(b)
                                     for b in (buckets or LATENCY_BUCKETS)}))
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.dropped_nonfinite = 0   # NaN/±Inf observations, never bucketed
        self._win = _WindowRing(WINDOW_SECONDS, WINDOW_SUBWINDOWS,
                                self._make_slot)

    def _make_slot(self):
        # [bucket counts, count, sum, min, max] — one subwindow's state
        return [[0] * (len(self.buckets) + 1), 0, 0.0, None, None]

    def observe(self, value):
        value = float(value)
        if not math.isfinite(value):
            # a non-finite sample has no honest bucket: bisect would
            # file NaN under the FASTEST bucket (every `edge < nan`
            # compare is False), the overflow slot would force false
            # breaches for legitimate >30s samples, and one nan+x
            # would poison the running sum forever — breaking the
            # strict-JSON JSONL/black-box contract.  Drop it VISIBLY:
            # the dropped_nonfinite field rides every record.
            with _lock:
                self.dropped_nonfinite += 1
            return self
        with _lock:
            # first bucket whose upper bound >= value (values above the
            # last edge land in the +Inf overflow slot)
            i = bisect_left(self.buckets, value)
            self.counts[i] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            s = self._win.slot()
            s[0][i] += 1
            s[1] += 1
            s[2] += value
            s[3] = value if s[3] is None else min(s[3], value)
            s[4] = value if s[4] is None else max(s[4], value)
        return self

    def configure_window(self, seconds, subwindows=None):
        """Resize the subwindow ring (resets the WINDOW contents only;
        cumulative bucket state is untouched)."""
        with _lock:
            self._win = _WindowRing(seconds,
                                    subwindows or WINDOW_SUBWINDOWS,
                                    self._make_slot)
        return self

    def cumulative(self):
        """[(upper_bound | "+Inf", cumulative_count), ...] — monotone."""
        with _lock:
            cum = _cumulate(self.counts)
        out = list(zip(self.buckets, cum))
        out.append(("+Inf", cum[-1]))
        return out

    # -- windowed reads ------------------------------------------------------
    def _window_merged(self, window=None):
        """(covered_seconds, counts, count, sum, min, max) — the live
        subwindows merged; called under the registry lock."""
        covered, slots = self._win.live(window)
        counts = [0] * (len(self.buckets) + 1)
        n, total, mn, mx = 0, 0.0, None, None
        for s in slots:
            for j, c in enumerate(s[0]):
                counts[j] += c
            n += s[1]
            total += s[2]
            if s[3] is not None:
                mn = s[3] if mn is None else min(mn, s[3])
                mx = s[4] if mx is None else max(mx, s[4])
        return covered, counts, n, total, mn, mx

    def window_cumulative(self, window=None):
        """Like :meth:`cumulative`, over the trailing window only."""
        with _lock:
            _, counts, _, _, _, _ = self._window_merged(window)
        cum = _cumulate(counts)
        out = list(zip(self.buckets, cum))
        out.append(("+Inf", cum[-1]))
        return out

    def window_stats(self, window=None):
        """{seconds, count, sum, min, max} over the trailing window."""
        with _lock:
            covered, _, n, total, mn, mx = self._window_merged(window)
        return {"seconds": covered, "count": n, "sum": total,
                "min": mn, "max": mx}

    def window_quantile(self, q, window=None):
        """Bucket-merge estimate of the ``q`` quantile over the trailing
        window (within-bucket linear interpolation, clamped to the
        window's observed min/max), or None when the window is empty.
        O(subwindows × buckets)."""
        with _lock:
            _, counts, n, _, mn, mx = self._window_merged(window)
        if not n:
            return None
        return _quantile(self.buckets, _cumulate(counts), q,
                         vmin=mn, vmax=mx)

    def window_fraction_le(self, threshold, window=None):
        """Fraction of window samples <= ``threshold`` seconds (linear
        interpolation inside the straddling bucket; overflow-bucket
        samples count as above any finite threshold — conservative for
        SLO attainment), or None when the window is empty."""
        with _lock:
            _, counts, n, _, mn, mx = self._window_merged(window)
        if not n:
            return None
        return _fraction_le(self.buckets, _cumulate(counts),
                            float(threshold), vmin=mn, vmax=mx)

    def quantile(self, q):
        """Lifetime (cumulative-since-start) quantile estimate, same
        bucket interpolation as :meth:`window_quantile`."""
        with _lock:
            counts = list(self.counts)
            n, mn, mx = self.count, self.min, self.max
        if not n:
            return None
        return _quantile(self.buckets, _cumulate(counts), q,
                         vmin=mn, vmax=mx)

    def _record(self, ts):
        rec = _rec(self, ts, self.count)
        rec["sum"] = self.sum
        rec["unit"] = self.unit
        if self.count:
            rec["min"] = self.min
            rec["max"] = self.max
        if self.dropped_nonfinite:
            rec["dropped_nonfinite"] = self.dropped_nonfinite
        rec["buckets"] = [[b, c] for b, c in self.cumulative()]
        with _lock:
            covered, counts, n, total, mn, mx = self._window_merged()
        win = {"seconds": covered, "count": n, "sum": total}
        if n:
            win["min"] = mn
            win["max"] = mx
        cum = _cumulate(counts)
        win["buckets"] = ([[b, c] for b, c in zip(self.buckets, cum)]
                          + [["+Inf", cum[-1]]])
        rec["window"] = win
        return rec


def _rec(metric, ts, value):
    rec = {"name": metric.name, "type": metric.kind, "value": value,
           "ts": ts}
    if metric.labels:
        rec["labels"] = dict(metric.labels)
    if _fleet_identity["rank"] is not None:
        rec["rank"] = _fleet_identity["rank"]
    if _fleet_identity["generation"] is not None:
        rec["fleet_generation"] = _fleet_identity["generation"]
    return rec


# ---------------------------------------------------------------------------
# bucket quantile math (shared by the live monitor and the snapshot
# readers)
# ---------------------------------------------------------------------------
def _cumulate(counts):
    """Per-bucket counts (overflow last) → cumulative counts, the +Inf
    overflow included as the last entry — the shape every quantile /
    fraction / record path consumes."""
    cum, acc = [], 0
    for c in counts[:-1]:
        acc += c
        cum.append(acc)
    cum.append(acc + counts[-1])
    return cum


def _quantile(bounds, cum, q, vmin=None, vmax=None):
    """Estimate the ``q`` quantile from cumulative bucket counts.

    ``bounds`` are the ascending finite upper edges; ``cum`` the
    cumulative counts per bucket INCLUDING the +Inf overflow as its last
    entry.  Linear interpolation inside the straddling bucket; the
    estimate is clamped to [vmin, vmax] when known (which makes the
    all-samples-in-one-bucket case exact when min == max).  Returns None
    on an empty distribution."""
    total = cum[-1]
    if total <= 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    prev_c, prev_b = 0, 0.0
    est = None
    for b, c in zip(bounds, cum):
        if c >= rank and c > prev_c:
            frac = (rank - prev_c) / (c - prev_c)
            est = prev_b + (b - prev_b) * max(0.0, min(1.0, frac))
            break
        prev_c, prev_b = c, b
    if est is None:
        # the rank lives in the +Inf overflow bucket: the best bounded
        # answer is the observed max (or the last finite edge)
        est = vmax if vmax is not None else (bounds[-1] if bounds else 0.0)
    if vmin is not None:
        est = max(est, vmin)
    if vmax is not None:
        est = min(est, vmax)
    return est


def _fraction_le(bounds, cum, threshold, vmin=None, vmax=None):
    """Fraction of samples <= ``threshold`` from cumulative bucket
    counts (``cum`` includes the +Inf overflow last).  Interpolates
    inside the straddling bucket; overflow samples count as ABOVE any
    threshold below the observed max (conservative for SLO attainment).
    Known ``vmin``/``vmax`` short-circuit the degenerate cases exactly:
    a threshold at or above every observed sample is full attainment
    (sound because observe() drops non-finite values — every counted
    sample, overflow included, is <= vmax), one below every sample is
    zero."""
    total = cum[-1]
    if total <= 0:
        return None
    if vmax is not None and threshold >= vmax:
        return 1.0
    if vmin is not None and threshold < vmin:
        return 0.0
    prev_c, prev_b = 0, 0.0
    for b, c in zip(bounds, cum):
        if threshold <= b:
            if threshold >= b:
                return c / total
            width = b - prev_b
            frac = (threshold - prev_b) / width if width > 0 else 1.0
            return (prev_c + (c - prev_c) * max(0.0, min(1.0, frac))) / total
        prev_c, prev_b = c, b
    return (cum[-2] if len(cum) > 1 else cum[-1]) / total


def _split_record_buckets(buckets):
    """A record-shaped ``[[bound | "+Inf", cum], ...]`` list split into
    (finite_bounds, cum_counts_incl_overflow)."""
    bounds = [float(b) for b, _ in buckets if b != "+Inf"]
    cum = [c for b, c in buckets if b != "+Inf"]
    inf = [c for b, c in buckets if b == "+Inf"]
    cum.append(inf[0] if inf else (cum[-1] if cum else 0))
    return bounds, cum


def quantile_from_cumulative(buckets, q, vmin=None, vmax=None):
    """The ``q`` quantile estimate from a record-shaped cumulative
    bucket list (``[[bound | "+Inf", count], ...]`` — the JSONL/window
    schema), or None when empty.  A snapshot reader gets live-window
    SLO state from snapshots with exactly this call."""
    bounds, cum = _split_record_buckets(buckets)
    return _quantile(bounds, cum, q, vmin=vmin, vmax=vmax)


def fraction_le_from_cumulative(buckets, threshold, vmin=None, vmax=None):
    """Fraction of samples <= ``threshold`` from a record-shaped
    cumulative bucket list, or None when empty (``vmin``/``vmax`` —
    e.g. a window record's min/max — make the all-above/all-below
    cases exact)."""
    bounds, cum = _split_record_buckets(buckets)
    return _fraction_le(bounds, cum, float(threshold),
                        vmin=vmin, vmax=vmax)


# ---------------------------------------------------------------------------
# SLO target specs ("itl_p99 < 50ms") — one grammar for the serving
# monitor and every reader
# ---------------------------------------------------------------------------
# the serving pair, shared by serving.SLOMonitor's default arming and
# the reference's report tool — one source, no drift
DEFAULT_SLOS = ("ttft_p99 < 500ms", "itl_p99 < 50ms")

# the attribution invariant's bar: |sum(phases) - latency| must stay
# within this fraction of the latency (plus a 1 ms absolute floor for
# sub-ms requests)
ATTRIBUTION_TOLERANCE = 0.05

SLO_METRIC_ALIASES = {
    "itl": "serve.itl_seconds",
    "ttft": "serve.ttft_seconds",
}

_SLO_SPEC_RE = re.compile(
    r"^\s*([A-Za-z0-9_.]+?)_p(\d{1,2}(?:\.\d+)?)\s*<\s*"
    r"([0-9]*\.?[0-9]+)\s*(us|ms|s)\s*$")

_SLO_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0}


def parse_slo_spec(spec):
    """``"itl_p99 < 50ms"`` → ``{name, metric, quantile,
    threshold_seconds, objective}``.  The left side is a metric alias
    (``itl``/``ttft``) or a full histogram name, suffixed ``_p<NN>``;
    the right side a latency with unit ``us``/``ms``/``s``.  The
    objective (required good fraction) defaults to the quantile: "p99
    below X" means 99% of samples must land below X, i.e. an error
    budget of 1%."""
    m = _SLO_SPEC_RE.match(str(spec))
    if not m:
        raise ValueError(
            f"unparseable SLO spec {spec!r} (want e.g. 'itl_p99 < 50ms')")
    base, pct, value, unit = m.groups()
    quantile = float(pct) / 100.0
    if not 0.0 < quantile < 1.0:
        raise ValueError(f"SLO spec {spec!r}: p{pct} out of (0, 100)")
    return {
        "name": f"{base}_p{pct}",
        "metric": SLO_METRIC_ALIASES.get(base, base),
        "quantile": quantile,
        "threshold_seconds": float(value) * _SLO_UNITS[unit],
        "objective": quantile,
    }


# name prefixes whose metrics this thread does not record (:func:`muted`)
_muted = threading.local()


class muted:
    """Context manager: inside it, this thread's metrics whose names
    start with ``prefix`` are fresh unregistered objects, so their
    updates reach no series (the serving engine's warm-up is not serving
    work and leaves the ``serve.*`` series untouched)."""

    def __init__(self, prefix):
        self.prefix = prefix

    def __enter__(self):
        _muted.prefixes = getattr(_muted, "prefixes", ()) + (self.prefix,)
        return self

    def __exit__(self, *exc):
        _muted.prefixes = _muted.prefixes[:-1]
        return False


def _get_or_make(cls, name, labels, **kw):
    if any(name.startswith(p) for p in getattr(_muted, "prefixes", ())):
        return cls(name, _labels_key(labels), **kw)
    key = (name, _labels_key(labels))
    with _lock:
        m = _metrics.get(key)
        if m is None:
            m = _metrics[key] = cls(name, _labels_key(labels), **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}")
        return m


def counter(name, **labels):
    """Create-or-fetch the Counter `name` (labels make distinct series)."""
    return _get_or_make(Counter, name, labels)


def gauge(name, **labels):
    """Create-or-fetch the Gauge `name`."""
    return _get_or_make(Gauge, name, labels)


def histogram(name, buckets=None, unit="seconds", **labels):
    """Create-or-fetch the Histogram `name`; `buckets` and `unit` only
    apply on first creation (fixed thereafter — merged snapshots depend
    on the bucket edges).  Names in ``_DEFAULT_BUCKETS`` (the serving
    SLO pair and phase attribution) default to the dense
    :data:`SLO_LATENCY_BUCKETS` ladder so every creation site agrees
    without repeating the edges."""
    if buckets is None:
        buckets = _DEFAULT_BUCKETS.get(name)
    return _get_or_make(Histogram, name, labels, buckets=buckets, unit=unit)


def get(name, **labels):
    """The already-registered metric, or None (no create side effect)."""
    with _lock:
        return _metrics.get((name, _labels_key(labels)))


def series(name):
    """Every registered series of ``name`` as ``[(labels_dict, metric),
    ...]`` (no create side effect).  The per-tenant SLO evaluation uses
    this to find the tenant-labeled variants of a target's histogram
    without knowing the tenant set in advance."""
    with _lock:
        return [(dict(m.labels), m)
                for (n, _), m in _metrics.items() if n == name]


def reset():
    """Drop every metric and the fleet-identity stamp (test hook)."""
    with _lock:
        _metrics.clear()
        _fleet_identity.update(rank=None, generation=None)
    _finalized.clear()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class span:
    """Context manager: time a region into the histogram ``name``."""

    __slots__ = ("name", "labels", "_t0")

    def __init__(self, name, **labels):
        self.name = name
        self.labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        histogram(self.name, **self.labels).observe(
            time.perf_counter() - self._t0)
        return False


# ---------------------------------------------------------------------------
# JSONL exporter
# ---------------------------------------------------------------------------
def configured_path():
    """The JSONL sink from the TPUMX_TELEMETRY env var, or None."""
    return os.environ.get("TPUMX_TELEMETRY") or None


def snapshot():
    """One record per live metric, sharing a wall-clock ``ts``.

    Built entirely under the registry lock (no I/O happens here): a
    concurrent ``observe()`` between reading ``count`` and the bucket
    array would otherwise produce a record violating the schema's own
    +Inf-count == value invariant."""
    ts = time.time()
    with _lock:
        return [m._record(ts) for m in _metrics.values()]


def flush(path=None, final=False):
    """Append one snapshot to the JSONL sink (`path` or TPUMX_TELEMETRY).

    No sink configured → no-op (returns None), which is what makes
    instrumentation free to call this unconditionally.  ``final=True``
    rewrites the file — full history + this snapshot — through
    ``checkpoint.atomic_write``, so the at-exit dump can never leave a
    truncated file; intermediate flushes are plain appends (cheap, and a
    torn tail there is recoverable line-by-line).  Returns the records."""
    path = path or configured_path()
    if not path:
        return None
    _refresh_bridge_gauges()
    recs = snapshot()
    payload = "".join(json.dumps(r, sort_keys=True) + "\n" for r in recs)
    # The registry _lock is NEVER held across file I/O: the write path
    # below re-enters instrumented code (atomic_write counts itself).  _flush_io_lock serializes concurrent flush()
    # calls instead, so a final read-modify-rewrite cannot drop a
    # concurrent append.  Earlier snapshots are re-read from disk for the
    # final rewrite — no in-memory history accumulates over a long run.
    with _flush_io_lock:
        if final:
            _finalized.add(path)
            try:
                with open(path, encoding="utf-8") as f:
                    prev = f.read()
            except OSError:
                prev = ""
            from .checkpoint import atomic_write
            with atomic_write(path, "w") as f:
                f.write(prev + payload)
        else:
            with open(path, "a", encoding="utf-8") as f:
                f.write(payload)
    return recs


def _host_rss_bytes():
    """The process's resident set in bytes (``/proc/self/statm``; the
    peak resident set from ``getrusage`` elsewhere), or None."""
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        peak = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        # linux and BSD report KiB, darwin bytes
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return None


def _refresh_bridge_gauges():
    """Pull cross-module observables into the registry right before a
    snapshot leaves the process: the host resident set
    (``host.rss_bytes``) and the flight recorder's overflow count
    (``tracing.events_dropped``, read only from a tracing module that is
    already imported)."""
    rss = _host_rss_bytes()
    if rss is not None:
        gauge("host.rss_bytes").set(float(rss))
    mod = sys.modules.get(__package__ + ".tracing") if __package__ else None
    if mod is None:
        return
    try:
        gauge("tracing.events_dropped").set(float(mod.stats()["dropped"]))
    except Exception:
        pass  # a torn-down tracing module must not break a flush


# paths a final flush already rewrote — the atexit hook must not append a
# duplicate final snapshot after an explicit flush(final=True)
_finalized: set = set()
_flush_io_lock = threading.Lock()


@atexit.register
def _flush_at_exit():
    try:
        path = configured_path()
        if path and _metrics and path not in _finalized:
            flush(final=True)
    except Exception:
        pass


def validate_record(rec):
    """Raise ValueError unless `rec` is a schema-valid telemetry record.

    Schema: every record
    has a str ``name``, ``type`` in {counter, gauge, histogram}, numeric
    ``value`` and ``ts``; histograms additionally carry a numeric ``sum``
    and cumulative ``buckets`` [[bound, count], ...] whose counts are
    monotone non-decreasing, whose last bound is "+Inf", and whose total
    equals ``value``."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is {type(rec).__name__}, not an object")
    name = rec.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError(f"record missing name: {rec!r}")
    kind = rec.get("type")
    if kind not in ("counter", "gauge", "histogram"):
        raise ValueError(f"{name}: bad type {kind!r}")
    for field in ("value", "ts"):
        if not isinstance(rec.get(field), (int, float)) \
                or isinstance(rec.get(field), bool):
            raise ValueError(f"{name}: missing numeric {field!r}")
    if "labels" in rec and not (
            isinstance(rec["labels"], dict)
            and all(isinstance(k, str) and isinstance(v, str)
                    for k, v in rec["labels"].items())):
        raise ValueError(f"{name}: labels must be a str->str object")
    # the fleet-identity stamp is optional — records from
    # static-world processes simply lack both keys and stay valid
    for field in ("rank", "fleet_generation"):
        v = rec.get(field)
        if v is not None and (not isinstance(v, int)
                              or isinstance(v, bool)):
            raise ValueError(f"{name}: {field!r} must be int, got {v!r}")
    if kind == "histogram":
        if not isinstance(rec.get("sum"), (int, float)):
            raise ValueError(f"{name}: histogram missing numeric 'sum'")
        buckets = rec.get("buckets")
        if not isinstance(buckets, list) or not buckets:
            raise ValueError(f"{name}: histogram missing 'buckets'")
        prev = None
        for entry in buckets:
            if (not isinstance(entry, list) or len(entry) != 2
                    or not isinstance(entry[1], int)):
                raise ValueError(f"{name}: malformed bucket {entry!r}")
            if prev is not None and entry[1] < prev:
                raise ValueError(
                    f"{name}: bucket counts not monotone "
                    f"({entry[1]} after {prev})")
            prev = entry[1]
        if buckets[-1][0] != "+Inf":
            raise ValueError(f"{name}: last bucket bound must be '+Inf', "
                             f"got {buckets[-1][0]!r}")
        if buckets[-1][1] != rec["value"]:
            raise ValueError(
                f"{name}: +Inf bucket count {buckets[-1][1]} != "
                f"value {rec['value']}")
    if "window" in rec:
        _validate_window(name, kind, rec["window"])
    return rec


def _validate_window(name, kind, win):
    """The optional ``window`` sub-object (trailing-window state riding
    counter/histogram records): numeric ``seconds``; counters carry a
    numeric ``value``, histograms a numeric ``count``/``sum`` and a
    monotone cumulative bucket list ending at ``+Inf`` whose total
    equals the window count — the same invariants as the record
    proper.  Records written before the window layer simply lack the
    key and stay valid."""
    if not isinstance(win, dict):
        raise ValueError(f"{name}: 'window' must be an object")
    if not isinstance(win.get("seconds"), (int, float)) \
            or isinstance(win.get("seconds"), bool):
        raise ValueError(f"{name}: window missing numeric 'seconds'")
    if kind == "counter":
        if not isinstance(win.get("value"), (int, float)) \
                or isinstance(win.get("value"), bool):
            raise ValueError(f"{name}: counter window missing 'value'")
        return
    if kind != "histogram":
        raise ValueError(f"{name}: {kind} records carry no window")
    for field in ("count", "sum"):
        if not isinstance(win.get(field), (int, float)) \
                or isinstance(win.get(field), bool):
            raise ValueError(f"{name}: window missing numeric {field!r}")
    buckets = win.get("buckets")
    if not isinstance(buckets, list) or not buckets:
        raise ValueError(f"{name}: window missing 'buckets'")
    prev = None
    for entry in buckets:
        if (not isinstance(entry, list) or len(entry) != 2
                or not isinstance(entry[1], int)):
            raise ValueError(f"{name}: malformed window bucket {entry!r}")
        if prev is not None and entry[1] < prev:
            raise ValueError(f"{name}: window bucket counts not monotone")
        prev = entry[1]
    if buckets[-1][0] != "+Inf":
        raise ValueError(f"{name}: window's last bucket must be '+Inf'")
    if buckets[-1][1] != win["count"]:
        raise ValueError(
            f"{name}: window +Inf count {buckets[-1][1]} != "
            f"count {win['count']}")


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    return "tpumx_" + _NAME_RE.sub("_", name)


def _prom_escape(v):
    """Label-value escaping per the Prometheus text format: backslash,
    double-quote and line-feed — in that order (escaping the escape
    character first keeps the round trip unambiguous)."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_labels(pairs):
    if not pairs:
        return ""
    body = ",".join('%s="%s"' % (_NAME_RE.sub("_", k), _prom_escape(v))
                    for k, v in pairs)
    return "{" + body + "}"


def _prom_num(v):
    return repr(float(v)) if isinstance(v, float) else str(v)


def exposition():
    """The registry in Prometheus text exposition format (one string —
    serve it over whatever transport exists; no HTTP server here).
    Counters get the conventional ``_total`` suffix; histograms emit the
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` family.  Rendered under
    the registry lock (pure string building, no I/O) so a concurrent
    ``observe()`` cannot tear a histogram's bucket/sum/count family."""
    with _lock:
        return _exposition_locked()


def _exposition_locked():
    metrics = sorted(_metrics.values(), key=lambda m: (m.name, m.labels))
    lines = []
    typed = set()

    def type_line(pname, kind):
        if pname not in typed:
            typed.add(pname)
            lines.append(f"# TYPE {pname} {kind}")

    for m in metrics:
        if m.kind == "counter":
            pname = _prom_name(m.name) + "_total"
            type_line(pname, "counter")
            lines.append(f"{pname}{_prom_labels(m.labels)} "
                         f"{_prom_num(m.value)}")
        elif m.kind == "gauge":
            pname = _prom_name(m.name)
            type_line(pname, "gauge")
            lines.append(f"{pname}{_prom_labels(m.labels)} "
                         f"{_prom_num(m.value)}")
        else:
            pname = _prom_name(m.name)
            type_line(pname, "histogram")
            for bound, cum in m.cumulative():
                le = "+Inf" if bound == "+Inf" else repr(float(bound))
                lab = _prom_labels(tuple(m.labels) + (("le", le),))
                lines.append(f"{pname}_bucket{lab} {cum}")
            lines.append(f"{pname}_sum{_prom_labels(m.labels)} "
                         f"{_prom_num(m.sum)}")
            lines.append(f"{pname}_count{_prom_labels(m.labels)} "
                         f"{m.count}")
    return "\n".join(lines) + ("\n" if lines else "")
