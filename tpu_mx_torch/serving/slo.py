"""Live SLO monitor: declarative targets, windowed attainment, burn rate.

The port of ``tpu_mx/serving/slo.py``.  It turns the telemetry layer's
sliding windows (``tpu_mx_torch/telemetry.py``) into the three numbers
an operator (or the scheduler) acts on, per declared target:

- **estimate** — the windowed quantile ("p99 ITL over the last minute");
- **attainment** — the fraction of window samples inside the threshold;
- **burn rate** — attainment in error-budget terms: an ``itl_p99 <
  50ms`` target allows 1% of tokens over 50 ms, so a window where 3% ran
  over burns the budget at 3x.  The monitor evaluates every window in
  ``windows`` (default 10 s and 60 s) and declares a **breach** only
  when the burn bar is exceeded in all of them.

:meth:`SLOMonitor.refresh` publishes the state as the ``serve.slo_*``
gauges (so every flush and black box carries the live SLO window),
emits a ``serve.slo`` event on each breach transition, and returns the
signal dict the ``Server`` hands to ``scheduler.slo_signal`` (the
per-tenant weight boost).  Targets are spec strings —
``SLOMonitor(("itl_p99 < 50ms", "ttft_p99 < 500ms"))`` — in the grammar
of ``telemetry.parse_slo_spec``.
"""
from __future__ import annotations

import logging
import time

from .. import telemetry as _telemetry
from .. import tracing as _tracing

log = logging.getLogger(__name__)

__all__ = ["SLO", "SLOMonitor", "DEFAULT_SLOS", "DEFAULT_WINDOWS",
           "NO_DATA"]

DEFAULT_SLOS = _telemetry.DEFAULT_SLOS   # the serving pair (one source)
DEFAULT_WINDOWS = (10.0, 60.0)

# sentinel published to serve.slo_estimate_seconds / serve.slo_attainment
# when the evaluation window holds no samples: estimates are positive and
# attainment lives in [0, 1], so -1 is unambiguous, survives strict JSON
# (NaN does not), and can never be mistaken for a live measurement
NO_DATA = -1.0


class SLO:
    """One declarative target: ``metric``'s ``quantile`` must stay under
    ``threshold_seconds``; equivalently, at least ``objective`` of the
    samples must land at or under the threshold (objective defaults to
    the quantile — "p99 < X" allows a 1% error budget)."""

    __slots__ = ("name", "metric", "quantile", "threshold_seconds",
                 "objective")

    def __init__(self, metric, quantile, threshold_seconds, name=None,
                 objective=None):
        self.metric = str(metric)
        self.quantile = float(quantile)
        self.threshold_seconds = float(threshold_seconds)
        self.objective = float(quantile if objective is None else objective)
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO objective must be in (0, 1), "
                             f"got {self.objective}")
        if self.threshold_seconds <= 0:
            raise ValueError("SLO threshold must be positive")
        self.name = name or f"{self.metric}_p{self.quantile * 100:g}"

    @classmethod
    def parse(cls, spec):
        """``"itl_p99 < 50ms"`` → an :class:`SLO` (grammar:
        ``telemetry.parse_slo_spec``)."""
        d = _telemetry.parse_slo_spec(spec)
        return cls(d["metric"], d["quantile"], d["threshold_seconds"],
                   name=d["name"], objective=d["objective"])

    def __repr__(self):
        return (f"SLO({self.name}: {self.metric} p{self.quantile * 100:g}"
                f" < {self.threshold_seconds * 1e3:g}ms)")


class SLOMonitor:
    """See module docstring.

    ``slos``: SLO objects or spec strings; ``windows``: the trailing
    windows (seconds) evaluated — must fit inside the histograms' ring
    horizon (``telemetry.WINDOW_SECONDS`` unless reconfigured);
    ``breach_burn``: the burn-rate bar (1.0 = exactly consuming the
    budget); ``min_refresh_seconds`` rate-limits :meth:`refresh` so a
    per-step caller costs one clock read between evaluations
    (``force=True`` bypasses it — the restart path does, so black boxes
    capture fault-time state)."""

    def __init__(self, slos=DEFAULT_SLOS, windows=DEFAULT_WINDOWS,
                 breach_burn=1.0, min_refresh_seconds=0.25):
        self.slos = [s if isinstance(s, SLO) else SLO.parse(s)
                     for s in slos]
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError("SLOMonitor needs at least one window")
        if self.windows[-1] > _telemetry.WINDOW_SECONDS:
            # the ring silently clamps an oversized window to its
            # horizon, degenerating the multi-window anti-flapping AND
            # into near-identical windows — make that loud (a warning,
            # not an error: a caller may configure_window() individual
            # histograms to a larger horizon)
            log.warning(
                "SLOMonitor window %gs exceeds the default %gs histogram "
                "ring horizon; unless the SLO metrics' windows are "
                "reconfigured larger, reads will be clamped",
                self.windows[-1], _telemetry.WINDOW_SECONDS)
        self.breach_burn = float(breach_burn)
        self.min_refresh_seconds = float(min_refresh_seconds)
        self._last_refresh = None
        self._breaching = {}
        self._signal = {"breaching": False, "max_burn_rate": 0.0,
                        "slos": {}}

    # -- evaluation (pure read; no gauges, no events) -------------------------
    def _eval_windows(self, h, slo, allowed):
        """One histogram's multi-window read for one target:
        ``(attainments, burns, sampled)`` aligned with
        ``self.windows`` (attainment None / burn 0 for an empty
        window).  The ONE place the burn rule lives — the global and
        per-tenant evaluations must never drift apart."""
        atts, burns, sampled = [], [], False
        for w in self.windows:
            frac = (h.window_fraction_le(slo.threshold_seconds,
                                         window=w) if h else None)
            if frac is None:
                atts.append(None)
                burns.append(0.0)
            else:
                sampled = True
                atts.append(frac)
                burns.append((1.0 - frac) / allowed)
        return atts, burns, sampled

    def evaluate(self):
        """The full state dict, computed from the live telemetry
        windows: ``{breaching, max_burn_rate, breaching_tenants,
        slos: {name: {...}}}``.  An SLO with no samples in a window is
        healthy-by-absence there (attainment None, burn 0) — breach
        requires evidence in every window, never its lack.

        **Per-tenant**: when tenant-labeled series of a
        target's histogram exist (``serve.itl_seconds{tenant=...}`` —
        the bounded labels tenancy.label_for mints), each is evaluated
        with the same multi-window rule into ``slos[name]["tenants"]
        [tenant] = {burn_rate, attainment, breaching}``, and the union
        of breaching tenants lands in ``breaching_tenants`` — the
        signal the scheduler's SLO-weighted boost consumes."""
        out = {"breaching": False, "max_burn_rate": 0.0,
               "breaching_tenants": [], "slos": {}}
        breaching_tenants = set()
        for slo in self.slos:
            h = _telemetry.get(slo.metric)
            if getattr(h, "kind", None) != "histogram":
                h = None
            allowed = 1.0 - slo.objective
            # read the estimate over the SLOWEST evaluation window so it
            # describes the same time range as the attainment/burn it is
            # published next to — window=None would read the histogram's
            # full ring horizon (60s default), showing a long-recovered
            # p99 beside an already-clean attainment
            est = (h.window_quantile(slo.quantile, window=self.windows[-1])
                   if h else None)
            atts, burns, sampled = self._eval_windows(h, slo, allowed)
            windows = {w: {"attainment": atts[i], "burn_rate": burns[i]}
                       for i, w in enumerate(self.windows)}
            breaching = sampled and all(b >= self.breach_burn
                                        for b in burns)
            tenants = {}
            for labels, th in _telemetry.series(slo.metric):
                tenant = labels.get("tenant")
                if tenant is None or getattr(th, "kind", None) \
                        != "histogram":
                    continue
                tatts, tburns, tsampled = self._eval_windows(th, slo,
                                                             allowed)
                tbreach = tsampled and all(b >= self.breach_burn
                                           for b in tburns)
                seen = [a for a in tatts if a is not None]
                tenants[tenant] = {
                    "burn_rate": max(tburns),
                    "attainment": min(seen) if seen else None,
                    "breaching": tbreach,
                }
                if tbreach:
                    breaching_tenants.add(tenant)
            out["slos"][slo.name] = {
                "metric": slo.metric,
                "quantile": slo.quantile,
                "threshold_seconds": slo.threshold_seconds,
                "estimate_seconds": est,
                "breaching": breaching,
                "windows": windows,
                "tenants": tenants,
            }
            out["breaching"] = out["breaching"] or breaching
            out["max_burn_rate"] = max(out["max_burn_rate"], *burns)
        out["breaching_tenants"] = sorted(breaching_tenants)
        return out

    # -- publication ---------------------------------------------------------
    def refresh(self, force=False):
        """Evaluate (rate-limited unless ``force``), publish the
        ``serve.slo_*`` gauges, emit ``serve.slo`` on breach
        transitions, and return (and remember) the signal dict."""
        now = time.monotonic()
        if (not force and self._last_refresh is not None
                and now - self._last_refresh < self.min_refresh_seconds):
            return self._signal
        self._last_refresh = now
        result = self.evaluate()
        # an empty window publishes the NO_DATA sentinel (-1.0): a gauge
        # frozen at its last non-empty value would let a dashboard read
        # a stale estimate as live after traffic stops, and NaN — the
        # Prometheus idiom — is invalid strict JSON, which would break
        # the black-box/JSONL "read it anywhere" contract
        for name, st in result["slos"].items():
            est = st["estimate_seconds"]
            _telemetry.gauge("serve.slo_estimate_seconds",
                             slo=name).set(NO_DATA if est is None else est)
            _telemetry.gauge("serve.slo_breaching", slo=name).set(
                1.0 if st["breaching"] else 0.0)
            worst_att, worst_burn = None, 0.0
            for w, pw in st["windows"].items():
                wl = f"{w:g}s"
                att = pw["attainment"]
                _telemetry.gauge("serve.slo_attainment", slo=name,
                                 window=wl).set(
                                     NO_DATA if att is None else att)
                if att is not None:
                    worst_att = (att if worst_att is None
                                 else min(worst_att, att))
                _telemetry.gauge("serve.slo_burn_rate", slo=name,
                                 window=wl).set(pw["burn_rate"])
                worst_burn = max(worst_burn, pw["burn_rate"])
            # per-tenant worst-window burn: one gauge per
            # (slo, tenant) — tenant labels are already cardinality-
            # bounded at the source (tenancy.label_for)
            for tenant, ts in st.get("tenants", {}).items():
                _telemetry.gauge("serve.slo_tenant_burn_rate", slo=name,
                                 tenant=tenant).set(ts["burn_rate"])
            if st["breaching"] != self._breaching.get(name, False):
                _tracing.emit(
                    "serve.slo", slo=name, breaching=st["breaching"],
                    burn_rate=worst_burn,
                    estimate_seconds=(NO_DATA if est is None
                                      else float(est)),
                    attainment=float(NO_DATA if worst_att is None
                                     else worst_att),
                    threshold_seconds=st["threshold_seconds"])
            self._breaching[name] = st["breaching"]
        self._signal = result
        return result

    def signal(self):
        """The most recent :meth:`refresh` result (the scheduler-facing
        hook; cheap — no evaluation)."""
        return self._signal
