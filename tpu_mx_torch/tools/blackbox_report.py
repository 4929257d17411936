#!/usr/bin/env python
"""Render a flight-recorder black box as a human-readable post-mortem; the
port's copy of the reference's ``tools/blackbox_report.py``, with the
same arguments, output and exit codes.

A supervised run dumps ``<prefix>-blackbox.json`` (tpu_mx_torch/tracing.py) on
every recovery decision — watchdog fire, NaN rollback, restart, degrade —
and on SIGTERM preemption.  This tool reconstructs what happened:

- the **timeline**: every recorded event with its step-scoped trace
  context ``(epoch, step, generation)`` and relative timestamp;
- the **recovery chains**: for each injected/observed fault, the
  correlated ``injection -> detection -> supervisor decision`` line
  (e.g. ``epoch 2 step 3: chaos hang injected -> watchdog fired at 20.0s
  -> classified transient -> restart #1 from epoch 2``), linked by the
  shared trace context;
- the **telemetry snapshot** taken at dump time (recovery counters and
  latency histograms);
- the **environment fingerprint** (host, pid, python, TPUMX_*/JAX_* env).

``--validate`` additionally schema-checks the box: the format tag, every
event against ``tracing.KNOWN_EVENTS`` (names AND payload field types),
and every telemetry record against the telemetry schema + catalog.
Exit status: 0 ok, 1 validation failure, 2 unreadable input.

    python tpu_mx_torch/tools/blackbox_report.py PREFIX-blackbox.json --validate

``tracing`` and ``telemetry`` are loaded standalone from their files
(standard library only at module level): run as a script, the tool never
imports torch or the package just to read a JSON post-mortem, and works
on a machine with no accelerator stack at all.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(name):
    """Load the package's ``<name>.py`` without importing the package
    (``name`` may name a subpackage's module, ``serving/accounting``;
    tracing.py, telemetry.py and accounting.py are stdlib-only at module
    level)."""
    path = os.path.join(PACKAGE, *f"{name}.py".split("/"))
    spec = importlib.util.spec_from_file_location(
        "_tpumx_torch_" + name.replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(e):
    ep = e.get("epoch")
    st = e.get("step")
    return "e%s/s%s/g%s" % ("-" if ep is None else ep,
                            "-" if st is None else st,
                            e.get("generation", "-"))


def _payload(e):
    data = e.get("data")
    if not isinstance(data, dict):  # malformed: render, don't crash — a
        return "(malformed payload)"  # post-mortem reader needs the rest
    return " ".join(f"{k}={_fmt(v)}" for k, v in sorted(data.items()))


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_timeline(events):
    if not events:
        return ["  (no events recorded — was TPUMX_TRACING=0 set?)"]
    t0 = events[0].get("ts", 0)
    lines = []
    for e in events:
        lines.append("  %+10.3fs  %-10s %-26s %s" % (
            e.get("ts", 0) - t0, _ctx(e), e.get("event", "?"),
            _payload(e)))
    return lines


# fault events that OPEN a recovery chain; keyed by how the chain line
# describes them
_FAULT_EVENTS = ("chaos.inject", "supervisor.watchdog_fire",
                 "supervisor.sentinel_skip")


def recovery_chains(events):
    """One ``injection -> detection -> decision`` line per observed
    fault, linked by the shared (epoch, generation) trace context (the
    decision for a step-K fault can land at step K+1 — e.g. a NaN streak
    whose divergence is declared a batch later — so the step is reported
    but not used for the join)."""
    chains = []
    for i, e in enumerate(events):
        if e.get("event") != "chaos.inject":
            continue
        key = (e.get("epoch"), e.get("generation"))
        data = e.get("data") if isinstance(e.get("data"), dict) else {}
        parts = [f"chaos {data.get('kind', '?')} injected"]
        for later in events[i + 1:]:
            if (later.get("epoch"), later.get("generation")) != key:
                continue
            name = later.get("event")
            d = later.get("data")
            if not isinstance(d, dict):
                d = {}
            if name == "supervisor.watchdog_fire":
                parts.append("watchdog fired at "
                             f"{_fmt(d.get('deadline_seconds', '?'))}s")
            elif name == "supervisor.sentinel_skip":
                parts.append("sentinel skipped batch "
                             f"(bad streak {d.get('consecutive_bad', '?')})")
            elif name == "supervisor.classify":
                parts.append(f"classified {d.get('kind', '?')} "
                             f"({d.get('error', '?')})")
            elif name == "supervisor.restart":
                parts.append(f"restart #{d.get('n', '?')} from epoch "
                             f"{d.get('resume_epoch', '?')}")
                break
            elif name == "supervisor.rollback":
                parts.append(f"rollback #{d.get('n', '?')} to epoch "
                             f"{d.get('resume_epoch', '?')}")
                break
            elif name == "supervisor.degrade":
                parts.append(f"degraded ({d.get('budget', '?')} budget "
                             "exhausted)")
                break
            elif name == "checkpoint.preemption":
                parts.append(f"preempted (signal {d.get('signum', '?')}, "
                             f"emergency save_ok={d.get('save_ok', '?')})")
                break
            # serving runtime decisions (tpu_mx_torch/serving/): the
            # engine-step context has no epoch (None) but the same
            # generation join applies — a decode fault and the engine
            # restart it provoked share (step, generation)
            elif name == "serve.reject":
                parts.append("admission rejected "
                             f"({d.get('reason', '?')}, "
                             f"request {d.get('request', '?')})")
                break
            elif name == "serve.restart":
                parts.append(f"engine restart #{d.get('n', '?')} "
                             f"(requeued {d.get('requeued', '?')} "
                             "in-flight requests)")
                break
        chains.append("  epoch %s step %s: %s" % (
            "-" if e.get("epoch") is None else e["epoch"],
            "-" if e.get("step") is None else e["step"],
            " -> ".join(parts)))
    return chains


def render_telemetry(records):
    lines = []
    for rec in sorted(records, key=lambda r: (r.get("name", ""),
                                              str(r.get("labels", {})))):
        name = rec.get("name", "?")
        labels = rec.get("labels")
        if labels:
            name += "{%s}" % ",".join(f"{k}={v}"
                                      for k, v in sorted(labels.items()))
        if rec.get("type") == "histogram":
            lines.append("  %-50s count=%s sum=%.6gs"
                         % (name, rec.get("value"), rec.get("sum", 0.0)))
        else:
            lines.append("  %-50s %s" % (name, _fmt(rec.get("value"))))
    return lines or ["  (no telemetry in the box)"]


def render(doc, path):
    ctx = doc.get("context", {})
    st = doc.get("stats", {})
    env = doc.get("environment", {})
    out = [f"Black box: {path}",
           f"  format:  {doc.get('format')}",
           f"  reason:  {doc.get('reason') or '(unspecified)'}",
           f"  written: {doc.get('written_at')}",
           f"  run:     {ctx.get('run_id')}  (context at dump: "
           f"epoch={ctx.get('epoch')} step={ctx.get('step')} "
           f"generation={ctx.get('generation')})",
           f"  ring:    {len(doc.get('events', []))} event(s) held, "
           f"capacity {st.get('capacity')}, {st.get('dropped', 0)} "
           f"dropped ({st.get('emitted', 0)} emitted total)", ""]
    chains = recovery_chains(doc.get("events", []))
    if chains:
        out.append("Recovery chains (injection -> detection -> decision, "
                   "correlated by shared trace context):")
        out.extend(chains)
        out.append("")
    out.append("Timeline:")
    out.extend(render_timeline(doc.get("events", [])))
    out.append("")
    out.append("Telemetry at dump time:")
    out.extend(render_telemetry(doc.get("telemetry", [])))
    out.append("")
    out.append("Environment:")
    out.append(f"  host={env.get('hostname')} pid={env.get('pid')} "
               f"python={env.get('python')} platform={env.get('platform')} "
               f"jax={env.get('jax')}")
    for k, v in sorted((env.get("env") or {}).items()):
        out.append(f"  {k}={v}")
    return "\n".join(out)


def validate(doc, tracing, telemetry):
    """Every schema violation as a string (empty = valid)."""
    errors = []
    try:
        tracing.validate_blackbox(doc)
    except ValueError as e:
        errors.append(str(e))
    for i, rec in enumerate(doc.get("telemetry") or []):
        try:
            telemetry.validate_record(rec)
        except ValueError as e:
            errors.append(f"telemetry[{i}]: {e}")
            continue
        if rec["name"] not in telemetry.KNOWN_METRICS:
            errors.append(f"telemetry[{i}]: unknown metric name "
                          f"{rec['name']!r} — not in KNOWN_METRICS")
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", help="a <prefix>-blackbox.json dump")
    ap.add_argument("--validate", action="store_true",
                    help="fail on schema violations (event names/payload "
                         "types outside tracing.KNOWN_EVENTS, malformed "
                         "telemetry records)")
    opts = ap.parse_args(argv)
    try:
        with open(opts.file, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"blackbox_report: cannot read {opts.file}: {e}",
              file=sys.stderr)
        return 2
    tracing = load_module("tracing")
    print(render(doc, opts.file))
    if opts.validate:
        telemetry = load_module("telemetry")
        errors = validate(doc, tracing, telemetry)
        if errors:
            print("VALIDATION FAILED:", file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
        print(f"schema OK: {len(doc.get('events', []))} event(s), "
              f"{len(doc.get('telemetry', []))} telemetry record(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
