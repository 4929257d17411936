#!/usr/bin/env python
"""Render live-window SLO state, burn rate, and worst-request breakdowns;
the port's copy of the reference's ``tools/slo_report.py``, with the same
arguments, output and exit codes.

The serving runtime's telemetry snapshots (TPUMX_TELEMETRY JSONL) carry,
on every counter/histogram record, a ``window`` sub-object — the
trailing-window state the SLO engine reads live (tpu_mx_torch/telemetry.py).
This tool is the host-only ops view over that data:

- **Windowed latency state**: per histogram series, the window's sample
  count and p50/p90/p99 bucket-merge estimates (the same math the live
  monitor uses — ``telemetry.quantile_from_cumulative``);
- **SLO targets**: each ``--slo`` spec (default: the serving pair
  ``ttft_p99 < 500ms`` / ``itl_p99 < 50ms``; grammar:
  ``telemetry.parse_slo_spec``) evaluated against the window —
  estimate vs threshold, attainment, error-budget burn rate, OK/BREACH;
- **Live monitor gauges**: the ``serve.slo_*`` series a running
  ``serving.SLOMonitor`` published, when armed;
- **Worst requests** (``--box <prefix>-blackbox.json``): the
  ``serve.request_timeline`` events from a flight-recorder black box,
  sorted by latency, each decomposed into its typed phases
  (queue_wait/prefill/decode_gap/restart_penalty/defer_stall) with
  percentages — "which phase of this slow request ate the budget";
- **Per-tenant state**: for every tenant-labeled series of a
  target's histogram (``serve.itl_seconds{tenant=...}`` — bounded
  labels, tpu_mx_torch/serving/tenancy.py), the window quantile, attainment
  and burn rate, plus each tenant's worst request by latency with its
  phase breakdown — "WHICH tenant's budget is burning, and on what".

``--validate`` schema-gates every telemetry record (including the
window sub-objects) against the catalog, every box event against
``tracing.KNOWN_EVENTS``, and every request timeline against the
attribution invariant (phases sum to the recorded latency within 5%).
Exit status: 0 ok, 1 validation failure, 2 unreadable input — the same
contract as blackbox_report.py.

    python tpu_mx_torch/tools/slo_report.py metrics.jsonl --box PREFIX-blackbox.json --validate

``telemetry`` and ``tracing`` are loaded standalone from their files
(standard library only at module level): run as a script, the tool never
imports torch or the package, and works on a machine with no accelerator
stack at all.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


def sibling(name):
    """Another tool of this directory, loaded from its file (never
    through the package, which would import torch)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"_tpumx_torch_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# blackbox_report's standalone loader, shared
load_module = sibling("blackbox_report").load_module


def read_series(path, telemetry, validate=False):
    """{(name, labels_json): last_record} from a cumulative-snapshot
    JSONL file, plus the validation error list."""
    series, errors = {}, []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                errors.append(f"line {lineno}: not JSON: {e}")
                continue
            if validate:
                try:
                    telemetry.validate_record(rec)
                except ValueError as e:
                    errors.append(f"line {lineno}: {e}")
                    continue
                if rec["name"] not in telemetry.KNOWN_METRICS:
                    errors.append(
                        f"line {lineno}: unknown metric name "
                        f"{rec['name']!r} — not in telemetry.KNOWN_METRICS")
                    continue
            key = (rec.get("name"),
                   json.dumps(rec.get("labels", {}), sort_keys=True))
            series[key] = rec
    return series, errors


def _label(name, labels_json):
    labels = json.loads(labels_json)
    if not labels:
        return name
    return name + "{%s}" % ",".join(f"{k}={v}"
                                    for k, v in sorted(labels.items()))


def _ms(v):
    return "-" if v is None else f"{v * 1e3:.3f}"


def render_windows(series, telemetry):
    """The windowed-histogram table: per series with window samples,
    count and p50/p90/p99 estimates in ms."""
    lines = ["Windowed latency state (trailing-window bucket-merge "
             "estimates, ms):",
             "  %-44s %8s %7s %10s %10s %10s" %
             ("Series", "win(s)", "count", "p50", "p90", "p99")]
    shown = 0
    for (name, lj), rec in sorted(series.items()):
        if rec.get("type") != "histogram":
            continue
        win = rec.get("window")
        if not win or not win.get("count"):
            continue
        shown += 1
        q = {}
        for p in (0.50, 0.90, 0.99):
            q[p] = telemetry.quantile_from_cumulative(
                win["buckets"], p, vmin=win.get("min"),
                vmax=win.get("max"))
        lines.append("  %-44s %8g %7d %10s %10s %10s" % (
            _label(name, lj), win.get("seconds", 0), win["count"],
            _ms(q[0.50]), _ms(q[0.90]), _ms(q[0.99])))
    if not shown:
        lines.append("  (no histogram series with window samples — "
                     "pre-window snapshot, or the run was idle)")
    return lines


def render_slos(series, telemetry, specs):
    """Evaluate each --slo spec against its histogram's window."""
    lines = ["SLO targets (evaluated over each series' trailing "
             "window):",
             "  %-28s %12s %12s %11s %9s %8s" %
             ("Target", "estimate", "threshold", "attainment", "burn",
              "status")]
    for spec in specs:
        try:
            d = telemetry.parse_slo_spec(spec)
        except ValueError as e:
            lines.append(f"  {spec!r}: {e}")
            continue
        rec = series.get((d["metric"], "{}"))
        win = (rec or {}).get("window")
        if not win or not win.get("count"):
            lines.append("  %-28s %12s %12s %11s %9s %8s" % (
                d["name"], "-", _ms(d["threshold_seconds"]), "-", "-",
                "no data"))
            continue
        est = telemetry.quantile_from_cumulative(
            win["buckets"], d["quantile"], vmin=win.get("min"),
            vmax=win.get("max"))
        att = telemetry.fraction_le_from_cumulative(
            win["buckets"], d["threshold_seconds"], vmin=win.get("min"),
            vmax=win.get("max"))
        burn = (1.0 - att) / (1.0 - d["objective"])
        lines.append("  %-28s %9s ms %9s ms %11.4f %9.2f %8s" % (
            d["name"], _ms(est), _ms(d["threshold_seconds"]), att, burn,
            "BREACH" if burn >= 1.0 else "OK"))
    return lines


# the live monitor's empty-window sentinel (serving.slo.NO_DATA): the
# estimate/attainment gauges publish -1.0 when their window holds no
# samples — a legitimate state, rendered as "n/a", never as a negative
# latency or a negative burn rate in the per-tenant gauge rows
NO_DATA = -1.0


def render_monitor_gauges(series):
    """The serve.slo_* gauges a live SLOMonitor published.  The NO_DATA
    sentinel (-1, published while an evaluation window is empty so a
    dashboard never reads a frozen stale value as live) renders as
    ``n/a``: estimates are positive and attainment lives in [0, 1], so
    -1 is unambiguously no-data, not a measurement."""
    rows = [(k, r) for k, r in sorted(series.items())
            if k[0].startswith("serve.slo_")]
    if not rows:
        return ["Live monitor gauges: (none — no SLOMonitor was armed)"]
    lines = ["Live monitor gauges (serving.SLOMonitor state at last "
             "snapshot):"]
    for (name, lj), rec in rows:
        v = rec.get("value")
        shown = "n/a (empty window)" if v == NO_DATA else "%g" % v
        lines.append("  %-56s %s" % (_label(name, lj), shown))
    return lines


def render_recovery(series, box):
    """The restart-recovery section: how restarts were paid
    for — replayed (one prefill re-establishing the committed ledger)
    vs re-decoded (the legacy prompt-replay arm's catch-up tokens) —
    plus the journal's durability counters and the per-request
    ``restart_penalty`` phase totals from the box's timelines.  The
    replay-vs-redecode split IS the zero-regeneration receipt: a
    healthy replay-arm run shows restarts > 0 with re-decoded == 0."""
    def cval(name):
        rec = series.get((name, "{}"))
        return 0 if rec is None else rec.get("value", 0)

    lines = ["Restart recovery (zero-regeneration serving):"]
    restarts = cval("serve.engine_restarts")
    if not restarts and not cval("serve.journal_requests"):
        lines.append("  (no engine restarts and no journal in this "
                     "snapshot — nothing was recovered)")
        return lines
    lines.append("  engine restarts        %d" % restarts)
    lines.append("  replayed sequences     %d  (ONE prefill each — "
                 "committed ledger kept)" % cval("serve.replay_requests"))
    lines.append("  replayed tokens        %d  (re-established by "
                 "prefill, not re-decoded)" % cval("serve.replay_tokens"))
    lines.append("  re-decoded tokens      %d  (legacy prompt-replay "
                 "catch-up work)" % cval("serve.redecode_tokens"))
    if cval("serve.journal_requests"):
        lines.append("  journal                %d request(s), %d "
                     "token(s), %d byte(s) fsync'd, %d fallback(s)" % (
                         cval("serve.journal_requests"),
                         cval("serve.journal_tokens"),
                         cval("serve.journal_bytes"),
                         cval("serve.replay_fallbacks")))
    if box is not None:
        pens = [(e["data"].get("request", "?"),
                 float(e["data"].get("restart_penalty", 0.0)))
                for e in request_timelines(box)
                if float(e["data"].get("restart_penalty", 0.0)) > 0]
        if pens:
            total = sum(p for _, p in pens)
            worst = max(pens, key=lambda rp: rp[1])
            lines.append(
                "  restart_penalty        %d request(s) paid %.2fms "
                "total; worst %s at %.2fms" % (
                    len(pens), total * 1e3, worst[0], worst[1] * 1e3))
        else:
            lines.append("  restart_penalty        (no request in the "
                         "box paid a restart penalty)")
    return lines


def render_tenants(series, telemetry, specs, box, phases):
    """The per-tenant section: each target evaluated against every
    tenant-labeled series' window (quantile estimate, attainment, burn,
    status), then each tenant's worst recorded request with its phase
    breakdown.  Tenant labels are already cardinality-bounded at the
    source (tenancy.label_for: the overflow label aggregates the long
    tail)."""
    targets = []
    for spec in specs:
        try:
            targets.append(telemetry.parse_slo_spec(spec))
        except ValueError:
            continue
    tenants = set()
    for (name, lj), rec in series.items():
        labels = json.loads(lj)
        if rec.get("type") == "histogram" and "tenant" in labels:
            tenants.add(labels["tenant"])
    by_tenant = {}
    if box is not None:
        for e in request_timelines(box):
            t = e["data"].get("tenant")
            if t is not None:
                tenants.add(t)
                by_tenant.setdefault(t, []).append(e)
    if not tenants:
        return ["Per-tenant SLO state: (no tenant-labeled series — "
                "single-tenant run, or pre-tenancy snapshot)"]
    lines = ["Per-tenant SLO state (window estimates per tenant label):",
             "  %-10s %-24s %7s %12s %11s %9s %8s" %
             ("Tenant", "Target", "count", "estimate", "attainment",
              "burn", "status")]
    for tenant in sorted(tenants):
        for d in targets:
            key = (d["metric"],
                   json.dumps({"tenant": tenant}, sort_keys=True))
            win = (series.get(key) or {}).get("window")
            if not win or not win.get("count"):
                lines.append("  %-10s %-24s %7s %12s %11s %9s %8s" % (
                    tenant, d["name"], 0, "-", "-", "-", "no data"))
                continue
            est = telemetry.quantile_from_cumulative(
                win["buckets"], d["quantile"], vmin=win.get("min"),
                vmax=win.get("max"))
            att = telemetry.fraction_le_from_cumulative(
                win["buckets"], d["threshold_seconds"],
                vmin=win.get("min"), vmax=win.get("max"))
            burn = (1.0 - att) / (1.0 - d["objective"])
            lines.append("  %-10s %-24s %7d %9s ms %11.4f %9.2f %8s" % (
                tenant, d["name"], win["count"], _ms(est), att, burn,
                "BREACH" if burn >= 1.0 else "OK"))
        worst = sorted(by_tenant.get(tenant, ()),
                       key=lambda e: -float(e["data"].get("latency", 0.0)))
        if worst:
            d = worst[0]["data"]
            lat = float(d.get("latency", 0.0))
            parts = []
            for p in phases:
                v = float(d.get(p, 0.0))
                if v > 0:
                    pct = 100.0 * v / lat if lat > 0 else 0.0
                    parts.append(f"{p} {v * 1e3:.2f}ms ({pct:.0f}%)")
            lines.append(
                "    worst request: %-12s %8.2fms %-8s cached=%s"
                % (d.get("request", "?"), lat * 1e3,
                   d.get("outcome", "?"), d.get("cached_tokens", 0)))
            lines.append("      " + (" + ".join(parts) if parts
                                     else "(empty)"))
    return lines


def timeline_phases(tracing):
    """The attribution phases, in render order, derived from the
    ``serve.request_timeline`` event schema — NOT hand-copied from
    tpu_mx_torch/serving/timeline.py, so a new phase can never make this
    tool's invariant re-check under-count and fail correct data."""
    schema = tracing.KNOWN_EVENTS["serve.request_timeline"]
    return tuple(k for k, t in schema.items()
                 if t == "float" and k not in ("latency", "ttft"))


def request_timelines(box):
    """The serve.request_timeline events from a black-box document."""
    return [e for e in box.get("events", [])
            if e.get("event") == "serve.request_timeline"
            and isinstance(e.get("data"), dict)]


def render_worst_requests(box, top, phases):
    """Top-N requests by latency, each with its phase breakdown."""
    tls = sorted(request_timelines(box),
                 key=lambda e: -float(e["data"].get("latency", 0.0)))
    lines = [f"Worst requests by latency (top {top} of {len(tls)} "
             "recorded timelines):"]
    if not tls:
        lines.append("  (no serve.request_timeline events in the box)")
        return lines
    for e in tls[:top]:
        d = e["data"]
        lat = float(d.get("latency", 0.0))
        parts = []
        for p in phases:
            v = float(d.get(p, 0.0))
            if v > 0:
                pct = 100.0 * v / lat if lat > 0 else 0.0
                parts.append(f"{p} {v * 1e3:.2f}ms ({pct:.0f}%)")
        lines.append(
            "  %-12s %8.2fms  %-8s tok=%-3s requeues=%s defers=%s"
            % (d.get("request", "?"), lat * 1e3, d.get("outcome", "?"),
               d.get("tokens", "?"), d.get("requeues", "?"),
               d.get("defers", "?")))
        lines.append("    " + (" + ".join(parts) if parts else "(empty)"))
    return lines


def validate_timelines(box, phases, tolerance):
    """The attribution invariant, re-checked offline: each recorded
    timeline's phases must sum to its latency within tolerance
    (``telemetry.ATTRIBUTION_TOLERANCE`` — the serve CI tier's bar)."""
    errors = []
    for e in request_timelines(box):
        d = e["data"]
        lat = float(d.get("latency", 0.0))
        total = sum(float(d.get(p, 0.0)) for p in phases)
        tol = max(tolerance * lat, 1e-3)
        if abs(total - lat) > tol:
            errors.append(
                f"request {d.get('request', '?')}: phases sum to "
                f"{total * 1e3:.3f}ms but latency is {lat * 1e3:.3f}ms "
                f"(tolerance {tol * 1e3:.3f}ms)")
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", help="TPUMX_TELEMETRY JSONL snapshot file")
    ap.add_argument("--box", default=None,
                    help="a <prefix>-blackbox.json dump: adds the "
                         "worst-request phase-breakdown section")
    ap.add_argument("--slo", action="append", default=[],
                    help="SLO spec to evaluate, e.g. 'itl_p99 < 50ms' "
                         "(repeatable; default: the serving pair)")
    ap.add_argument("--top", type=int, default=5,
                    help="worst requests to show (default 5)")
    ap.add_argument("--validate", action="store_true",
                    help="fail on schema violations or attribution "
                         "invariant breaks")
    opts = ap.parse_args(argv)
    telemetry = load_module("telemetry")
    try:
        series, errors = read_series(opts.file, telemetry,
                                     validate=opts.validate)
    except OSError as e:
        print(f"slo_report: cannot read {opts.file}: {e}",
              file=sys.stderr)
        return 2
    box = None
    tracing = load_module("tracing")
    if opts.box:
        try:
            with open(opts.box, encoding="utf-8") as f:
                box = json.load(f)
        except (OSError, ValueError) as e:
            print(f"slo_report: cannot read {opts.box}: {e}",
                  file=sys.stderr)
            return 2

    specs = opts.slo or list(telemetry.DEFAULT_SLOS)
    out = [f"SLO report: {opts.file}", ""]
    out.extend(render_windows(series, telemetry))
    out.append("")
    out.extend(render_slos(series, telemetry, specs))
    out.append("")
    out.extend(render_monitor_gauges(series))
    out.append("")
    out.extend(render_recovery(series, box))
    out.append("")
    out.extend(render_tenants(series, telemetry, specs, box,
                              timeline_phases(tracing)))
    if box is not None:
        out.append("")
        out.extend(render_worst_requests(box, opts.top,
                                         timeline_phases(tracing)))
    print("\n".join(out))

    if opts.validate:
        if box is not None:
            try:
                tracing.validate_blackbox(box)
            except ValueError as e:
                errors.append(f"box: {e}")
            errors.extend(f"box: {e}" for e in validate_timelines(
                box, timeline_phases(tracing),
                telemetry.ATTRIBUTION_TOLERANCE))
        if not series:
            errors.append("file contains no telemetry records")
        if errors:
            print("VALIDATION FAILED:", file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
        print(f"schema OK: {len(series)} series"
              + (f", {len(request_timelines(box))} request timeline(s)"
                 if box is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
