#!/usr/bin/env python
"""Render a fleet black box (``<fleet_dir>/fleet-blackbox.json``) as a
cross-rank post-mortem; the port's copy of the reference's
``tools/fleet_report.py``.

A supervised elastic run (``python -m tpu_mx_torch.tools.launch
--supervise``) dumps the fleet black box on every evict/degrade decision
and at exit: the flight-recorder document with a ``fleet`` section —
every live worker's last shipped events and telemetry aligned on the
membership generation, the merged fleet aggregate, the cross-rank
step-skew timeline and the straggler verdict
(:mod:`tpu_mx_torch.parallel.fleet_obs`).  This tool renders that
section: the per-rank table, the fleet aggregate, the skew timeline, the
straggler verdict and the corruption verdict.

``--validate`` schema-checks the section and re-proves the aggregation
identity from the document alone: every merged counter must equal the
sum of its ``per_rank`` breakdown, and re-merging the stored per-rank
snapshots must reproduce the stored aggregate.  Exit status: 0 ok, 1
validation failure, 2 unreadable input.

    python tpu_mx_torch/tools/fleet_report.py FLEET_DIR/fleet-blackbox.json --validate

``fleet_obs``, ``tracing`` and ``telemetry`` are loaded from their files
(standard library only at module level): run as a script, the tool never
imports torch or the package.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(relpath, name):
    """Load one module of the package from its file without importing
    the package (fleet_obs's merge core, telemetry and tracing are
    stdlib-only at module level)."""
    path = os.path.join(PACKAGE, *relpath.split("/"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_ranks(fl):
    lines = ["Per-rank shipped state (generation-aligned):",
             "  %-5s %-4s %-14s %8s %10s" % ("rank", "gen", "context",
                                             "events", "telemetry")]
    ranks = fl.get("ranks", {})
    if not ranks:
        return lines + ["  (no rank shipped a snapshot)"]
    for r in sorted(ranks, key=int):
        body = ranks[r]
        ctx = body.get("context", {})
        ctx_s = "e%s/s%s" % (ctx.get("epoch", "-"), ctx.get("step", "-"))
        lines.append("  %-5s %-4s %-14s %8d %10d" % (
            r, body.get("generation", "?"), ctx_s,
            len(body.get("events", [])), len(body.get("telemetry", []))))
    gap = [str(m) for m in fl.get("world", [])
           if str(m) not in ranks]
    if gap:
        lines.append(f"  MISSING (in world, nothing shipped — gap, not "
                     f"interpolated): rank(s) {', '.join(gap)}")
    return lines


def render_aggregate(fl):
    lines = ["Fleet aggregate (counters summed, gauges spread, "
             "histograms bucket-merged):"]
    agg = fl.get("aggregate", [])
    if not agg:
        return lines + ["  (empty aggregate)"]
    for rec in sorted(agg, key=lambda r: (r.get("name", ""),
                                          str(r.get("labels", {})))):
        name = rec.get("name", "?")
        labels = rec.get("labels")
        if labels:
            name += "{%s}" % ",".join(f"{k}={v}"
                                      for k, v in sorted(labels.items()))
        pr = rec.get("per_rank", {})
        pr_s = " ".join(f"r{r}={_fmt(v)}"
                        for r, v in sorted(pr.items(), key=lambda kv:
                                           int(kv[0])))
        kind = rec.get("type")
        if kind == "gauge":
            val = (f"mean={_fmt(rec.get('mean', rec.get('value')))} "
                   f"min={_fmt(rec.get('min'))} max={_fmt(rec.get('max'))}")
        elif kind == "histogram":
            val = f"count={rec.get('value')} sum={_fmt(rec.get('sum', 0.0))}"
        else:
            val = _fmt(rec.get("value"))
        lines.append("  %-46s %-34s %s" % (name, val, pr_s))
    return lines


def render_skew(fl):
    lines = ["Cross-rank step-skew timeline "
             "(correlated on (epoch, step, generation)):"]
    timeline = fl.get("skew_timeline", [])
    if not timeline:
        return lines + ["  (no step observed by >= 2 ranks)"]
    for c in timeline:
        lines.append("  g%s e%s s%-5s skew=%ss  slowest=rank %s "
                     "(dominant phase: %s)" % (
                         c.get("generation"), c.get("epoch"),
                         c.get("step"), _fmt(c.get("skew_seconds")),
                         c.get("slowest_rank"), c.get("dominant_phase")))
    return lines


def render_signal(fl):
    sig = fl.get("straggler_signal", {})
    if sig.get("straggling"):
        return [f"Straggler verdict: rank {sig.get('rank')} is a "
                f"persistent straggler — +{_fmt(sig.get('excess_seconds'))}"
                f"s/step, dominant phase {sig.get('dominant_phase')!r}, "
                f"slowest in {sig.get('steps')} of the last "
                f"{sig.get('window')} correlated steps"]
    return ["Straggler verdict: none (no rank persistently slowest)"]


def render_corruption(fl):
    corr = fl.get("corruption")
    if not isinstance(corr, dict):
        return ["Corruption verdict: (no integrity data in this dump)"]
    cv = corr.get("verdict", {})
    if cv.get("clean", False):
        head = "Corruption verdict: clean (every vote agreed, no rank " \
               "quarantined)"
    else:
        head = ("Corruption verdict: CORRUPT — mismatching vote(s) at "
                f"step(s) {cv.get('mismatch_steps')}, suspected rank(s) "
                f"{cv.get('suspected')}, quarantined {cv.get('quarantined')}")
    lines = [head]
    fps = corr.get("fingerprints", {})
    if fps:
        lines.append("  Last published fingerprints:")
        for r in sorted(fps, key=int):
            rec = fps[r]
            lines.append("    rank %-4s step %-6s fp=%#010x" % (
                r, rec.get("step", "?"), int(rec.get("fp", 0))))
    votes = corr.get("votes_by_rank", {})
    for r in sorted(votes, key=int):
        for v in votes[r]:
            if v.get("agree", True):
                continue
            lines.append(
                "    rank %s vote @ step %s: DISAGREE majority=%#010x "
                "minority=%s absent=%s" % (
                    r, v.get("step"), int(v.get("majority_fp", 0)),
                    v.get("minority"), v.get("absent")))
    for r in sorted(corr.get("quarantined", {}), key=int):
        rec = corr["quarantined"][r]
        lines.append("    rank %s QUARANTINED at step %s (gen %s): %s" % (
            r, rec.get("step", "?"), rec.get("generation", "?"),
            rec.get("reason", "?")))
    return lines


def render(doc, path):
    fl = doc.get("fleet", {})
    out = [f"Fleet black box: {path}",
           f"  format:     {doc.get('format')} + {fl.get('format')}",
           f"  reason:     {doc.get('reason') or '(unspecified)'}",
           f"  written:    {doc.get('written_at')}",
           f"  generation: {fl.get('generation')}  "
           f"world={fl.get('world')}",
           f"  reporting:  {fl.get('ranks_reporting')}  "
           f"(stale records dropped: {fl.get('stale_dropped')})", ""]
    out.extend(render_ranks(fl))
    out.append("")
    out.extend(render_signal(fl))
    out.append("")
    out.extend(render_corruption(fl))
    out.append("")
    out.extend(render_skew(fl))
    out.append("")
    out.extend(render_aggregate(fl))
    return "\n".join(out)


def validate(doc, fleet_obs, tracing, telemetry):
    """Every violation as a string (empty = valid): the base black-box
    schema, the fleet section schema, and the aggregation identity."""
    errors = []
    try:
        tracing.validate_blackbox(doc)
    except ValueError as e:
        errors.append(f"base document: {e}")
    try:
        fleet_obs.validate_fleet_section(doc, telemetry=telemetry)
    except ValueError as e:
        errors.append(f"fleet section: {e}")
    fl = doc.get("fleet")
    if isinstance(fl, dict):
        for r, body in sorted((fl.get("ranks") or {}).items()):
            for i, ev in enumerate(body.get("events") or []):
                try:
                    tracing.validate_event(ev)
                except ValueError as e:
                    errors.append(f"rank {r} event[{i}]: {e}")
            for i, rec in enumerate(body.get("telemetry") or []):
                try:
                    telemetry.validate_record(rec)
                except ValueError as e:
                    errors.append(f"rank {r} telemetry[{i}]: {e}")
                    continue
                if rec["name"] not in telemetry.KNOWN_METRICS:
                    errors.append(f"rank {r} telemetry[{i}]: unknown "
                                  f"metric {rec['name']!r}")
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", help="a fleet-blackbox.json dump")
    ap.add_argument("--validate", action="store_true",
                    help="fail on schema violations or a broken "
                         "aggregation identity (merged counters must "
                         "equal their per-rank sums, and re-merging the "
                         "stored snapshots must reproduce the aggregate)")
    opts = ap.parse_args(argv)
    try:
        with open(opts.file, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"fleet_report: cannot read {opts.file}: {e}",
              file=sys.stderr)
        return 2
    fleet_obs = load_module("parallel/fleet_obs.py",
                            "_tpumx_torch_fleet_obs")
    print(render(doc, opts.file))
    if opts.validate:
        tracing = load_module("tracing.py", "_tpumx_torch_tracing")
        telemetry = load_module("telemetry.py", "_tpumx_torch_telemetry")
        errors = validate(doc, fleet_obs, tracing, telemetry)
        if errors:
            print("VALIDATION FAILED:", file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
        fl = doc.get("fleet", {})
        print(f"schema OK: {len(fl.get('ranks', {}))} rank(s), "
              f"{len(fl.get('aggregate', []))} aggregate record(s), "
              f"{len(fl.get('skew_timeline', []))} correlated step(s); "
              "aggregation identity holds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
