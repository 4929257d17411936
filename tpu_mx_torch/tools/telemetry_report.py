#!/usr/bin/env python
"""Render a TPUMX_TELEMETRY JSONL file as a human-readable report; the
port's copy of the reference's ``tools/telemetry_report.py``, with the
same arguments, output and exit codes.

Histogram series are rendered in the same per-scope aggregate table format
``mx.profiler.dumps()`` uses (Name / Calls / Total / Mean / Min / Max, in
ms), followed by counter and gauge sections.  Because each flush appends a
CUMULATIVE snapshot, the report aggregates by taking the LAST record of
every (name, labels) series.

Modes:

    python tpu_mx_torch/tools/telemetry_report.py metrics.jsonl
    python tpu_mx_torch/tools/telemetry_report.py metrics.jsonl --validate \
        --require fusion.flushes,checkpoint.save_seconds
    python tpu_mx_torch/tools/telemetry_report.py --diff A.jsonl B.jsonl
    python tpu_mx_torch/tools/telemetry_report.py --merge ctl.jsonl obs/rank-*.jsonl

``--merge`` renders the FLEET view over N per-rank snapshot files using
the cross-worker merge core (tpu_mx_torch/parallel/fleet_obs.py): counters
sum, histograms bucket-merge, gauges spread to min/mean/max — the same
code path the supervising launcher aggregates with, so the offline view
and the live rollup can never disagree.  ``--validate`` additionally
re-proves the aggregation identity (every merged counter equals its
per-rank sum) and ``--require`` gates the merged view (the ``fleet_obs``
preset spans worker + controller registries).

``--diff`` renders the DELTA between two snapshots (soak runs, bench
A/Bs): counter values and histogram count/sum are subtracted (B - A),
gauges — last-written values, not accumulators — are shown side by side.
Series present in only one file are marked ``(only in A/B)``.
``--require`` composes: the gate applies to B, the "after" snapshot.

``--validate`` checks every record against the telemetry schema
(name/type/value/ts present; histogram bucket monotonicity) and fails on
metric names outside ``telemetry.KNOWN_METRICS`` — stable metric names are
an API, and this is the gate that catches accidental renames.
``--require`` additionally fails unless each listed metric exists with a
nonzero value (counter > 0 / histogram count > 0 / gauge != 0).  A token
naming a preset (``supervisor`` — the self-healing recovery counters the
``soak`` CI tier gates on) expands to its metric list.

The telemetry module is loaded standalone from its file (standard
library only at module level): run as a script, the tool never imports
torch or the package just to read JSON.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


# --require presets: one token → a metric family.  "supervisor" gates the
# soak tier: every recovery path must have actually fired (the degraded
# gauge is deliberately absent — it is 0 on any healthy run).  "resume"
# gates the deterministic-resume leg: capsules were written AND a restore
# actually went through the capsule path (resume_step_gap is deliberately
# absent — it must be 0 under capsules, asserted in the soak script).
REQUIRE_PRESETS = {
    "supervisor": ("supervisor.restarts", "supervisor.rollbacks",
                   "supervisor.watchdog_fires",
                   "supervisor.batches_skipped"),
    "resume": ("resume.capsules_written",
               "resume.capsule_restore_seconds"),
    # "serve" gates the serve tier: the SLO histograms must have samples,
    # throughput must be nonzero, and the chaos schedule must have
    # actually driven an engine restart (queue_depth/cache_utilization
    # are deliberately absent — both are rightly 0 once a run drains).
    # The SLO-engine additions: per-request phase attribution
    # must have landed, and the live monitor must have published its
    # windowed estimate and attainment gauges (burn_rate/breaching are
    # deliberately absent — both are rightly 0 on a healthy run).
    # The recovery additions: the storm legs arm the token
    # journal and run on the prefill-replay arm, so restarts must have
    # been paid for with replay prefills and the journal must have
    # actually recorded admissions/tokens/fsyncs (redecode_tokens and
    # replay_fallbacks are deliberately absent — both are rightly 0 on
    # the replay arm with an intact journal).
    "serve": ("serve.requests", "serve.ttft_seconds", "serve.itl_seconds",
              "serve.generated_tokens", "serve.decode_steps",
              "serve.tokens_per_sec", "serve.engine_restarts",
              "serve.phase_seconds", "serve.slo_estimate_seconds",
              "serve.slo_attainment", "serve.replay_requests",
              "serve.replay_tokens", "serve.journal_requests",
              "serve.journal_tokens", "serve.journal_bytes"),
    # "fleet" gates the membership-churn soak leg: the epoch
    # gauge must have moved past 0, at least one reshard was driven
    # through the seam, and at least one evicted/late worker was admitted
    # back (lost_workers/worker_restarts are deliberately absent — a
    # planned-scale-only churn run legitimately loses nobody).
    "fleet": ("fleet.membership_epoch", "fleet.reshards", "fleet.rejoins"),
    # "fleet_obs" gates the fleet observability plane: workers
    # actually shipped snapshots, the controller's aggregation pass saw
    # them, and at least one step was observed by >= 2 ranks so cross-
    # rank skew exists.  Spans worker AND controller registries — meant
    # for `--merge controller.jsonl <fleet_dir>/obs/rank-*.jsonl`
    # (straggler_signal is deliberately absent: it is rightly 0 on a
    # straggler-free run).
    "fleet_obs": ("fleet.obs_records", "fleet.ranks_reporting",
                  "fleet.step_skew_seconds"),
    # "integrity" gates the SDC-storm soak leg: every rank
    # published fingerprints, votes were held, the injected flip was
    # actually seen as a mismatch, and the corrupt rank was quarantined.
    # Spans all ranks' registries — meant for
    # `--merge <fleet_dir>/obs/rank-*.jsonl` (shadow_audits /
    # self_checks are deliberately absent: the vote path needs neither,
    # and a train fleet legitimately runs with both samplers off).
    "integrity": ("integrity.fingerprints", "integrity.votes",
                  "integrity.mismatches", "integrity.quarantined"),
}


def expand_required(spec):
    """Comma-separated metric names / preset tokens → the flat name list."""
    names = []
    for token in spec.split(","):
        if not token:
            continue
        names.extend(REQUIRE_PRESETS.get(token, (token,)))
    return names


PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(relpath, name):
    """Load one module of the package from its file without importing
    the package (telemetry.py and fleet_obs's merge core are stdlib-only
    at module level)."""
    path = os.path.join(PACKAGE, *relpath.split("/"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_telemetry():
    """The package's telemetry.py, loaded standalone."""
    return load_module("telemetry.py", "_tpumx_torch_telemetry")


def load_fleet_obs():
    """The fleet-observability merge core, loaded the same standalone way
    (its merge/correlate functions are stdlib-only; the package bridges
    degrade to None on a standalone load)."""
    return load_module("parallel/fleet_obs.py", "_tpumx_torch_fleet_obs")


def read_records(path, telemetry, validate=False):
    """Parse the JSONL file into (records, stamps, errors) — every
    record in file order.  With validate=True, schema violations and
    unknown metric names land in `errors` instead of being silently
    passed through."""
    records = []
    stamps = set()
    errors = []
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
                        f"{rec['name']!r} — not in telemetry.KNOWN_METRICS "
                        "(stable names are an API; register new metrics in "
                        "the catalog + docs/observability.md)")
                    continue
            records.append(rec)
            if "ts" in rec:
                stamps.add(rec["ts"])
    return records, stamps, errors


def read_series(path, telemetry, validate=False):
    """Parse the JSONL file into {(name, labels_json): last_record}.

    Returns (series, n_snapshots, errors).  With validate=True, schema
    violations and unknown metric names land in `errors` instead of being
    silently passed through."""
    records, stamps, errors = read_records(path, telemetry,
                                           validate=validate)
    series = {}
    for rec in records:
        key = (rec.get("name"),
               json.dumps(rec.get("labels", {}), sort_keys=True))
        series[key] = rec
    return series, len(stamps), errors


def _series_label(name, labels_json):
    labels = json.loads(labels_json)
    if not labels:
        return name
    body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def render(series, n_snapshots, path):
    """The report string: histogram table (profiler.dumps format) +
    counter/gauge sections."""
    hists = {k: r for k, r in series.items() if r["type"] == "histogram"}
    counters = {k: r for k, r in series.items() if r["type"] == "counter"}
    gauges = {k: r for k, r in series.items() if r["type"] == "gauge"}
    lines = [f"Telemetry report: {path}",
             f"  {n_snapshots} snapshot(s), {len(series)} series", ""]

    def table(entries, scale, suffix):
        lines.append("%-40s %8s %12s %12s %12s %12s" %
                     ("Name", "Calls", f"Total{suffix}", f"Mean{suffix}",
                      f"Min{suffix}", f"Max{suffix}"))
        for (name, lj), rec in entries:
            n = rec["value"]
            tot = rec.get("sum", 0.0)
            if n:
                lines.append("%-40s %8d %12.3f %12.3f %12.3f %12.3f" % (
                    _series_label(name, lj), n, tot * scale,
                    tot / n * scale, rec.get("min", 0.0) * scale,
                    rec.get("max", 0.0) * scale))
            else:
                lines.append("%-40s %8d %12.3f %12s %12s %12s" % (
                    _series_label(name, lj), 0, 0.0, "-", "-", "-"))
        lines.append("")

    # seconds-unit histograms render in the profiler.dumps() ms table;
    # count-valued ones (e.g. fusion.segment_ops) keep their own unit
    timed = sorted((k, r) for k, r in hists.items()
                   if r.get("unit", "seconds") == "seconds")
    other = sorted((k, r) for k, r in hists.items()
                   if r.get("unit", "seconds") != "seconds")
    if timed:
        table(timed, 1e3, "(ms)")
    for (name, lj), rec in other:
        table([((name, lj), rec)], 1.0, f"({rec.get('unit', '')})")
    if counters:
        lines.append("Counters:")
        for (name, lj), rec in sorted(counters.items()):
            lines.append("  %-50s %s" % (_series_label(name, lj),
                                         rec["value"]))
        lines.append("")
    if gauges:
        lines.append("Gauges:")
        for (name, lj), rec in sorted(gauges.items()):
            lines.append("  %-50s %g" % (_series_label(name, lj),
                                         rec["value"]))
        lines.append("")
    return "\n".join(lines)


def render_diff(series_a, series_b, path_a, path_b):
    """The delta view: counters/histograms subtracted (B - A), gauges
    side-by-side — what a soak-vs-soak or bench A/B comparison needs
    without hand-parsing two JSONL files."""
    name_a = os.path.basename(path_a)
    name_b = os.path.basename(path_b)
    lines = [f"Telemetry diff: A={path_a}  B={path_b}",
             f"  {len(series_a)} series in A, {len(series_b)} in B", ""]
    keys = sorted(set(series_a) | set(series_b))

    def sided(key):
        a, b = series_a.get(key), series_b.get(key)
        if a is None:
            return b, "(only in B)"
        if b is None:
            return a, "(only in A)"
        return None, None

    rows_c, rows_h, rows_g = [], [], []
    for key in keys:
        label = _series_label(*key)
        rec, only = sided(key)
        kind = (rec or series_b.get(key) or series_a.get(key))["type"]
        if only is not None:
            val = rec["value"]
            if kind == "histogram":
                rows_h.append("  %-50s %s count=%s sum=%.6g"
                              % (label, only, val, rec.get("sum", 0.0)))
            elif kind == "counter":
                rows_c.append("  %-50s %s value=%s" % (label, only, val))
            else:
                rows_g.append("  %-50s %s value=%g" % (label, only, val))
            continue
        a, b = series_a[key], series_b[key]
        if kind == "counter":
            rows_c.append("  %-50s %+d   (A=%d, B=%d)"
                          % (label, b["value"] - a["value"],
                             a["value"], b["value"]))
        elif kind == "histogram":
            dc = b["value"] - a["value"]
            ds = b.get("sum", 0.0) - a.get("sum", 0.0)
            mean = (ds / dc) if dc else 0.0
            rows_h.append("  %-50s count %+d  sum %+.6g  mean %.6g"
                          % (label, dc, ds, mean))
        else:
            rows_g.append("  %-50s A=%-12g B=%-12g"
                          % (label, a["value"], b["value"]))
    if rows_c:
        lines += [f"Counters (B - A; A={name_a}, B={name_b}):",
                  *rows_c, ""]
    if rows_h:
        lines += ["Histograms (count/sum deltas, mean of the delta):",
                  *rows_h, ""]
    if rows_g:
        lines += ["Gauges (side by side — last-written values, "
                  "not accumulators):", *rows_g, ""]
    return "\n".join(lines)


def check_required(series, required):
    """Names in `required` must exist with a nonzero value; returns the
    list of violation strings (empty = good)."""
    problems = []
    by_name = {}
    for (name, _lj), rec in series.items():
        prev = by_name.get(name)
        if prev is None or rec["value"] > prev["value"]:
            by_name[name] = rec
    for name in required:
        rec = by_name.get(name)
        if rec is None:
            problems.append(f"required metric {name!r} never emitted")
        elif not rec["value"]:
            kind = rec["type"]
            what = "count" if kind == "histogram" else "value"
            problems.append(f"required metric {name!r} has zero {what}")
    return problems


def run_merge(opts, telemetry, ap):
    """--merge: fold N per-rank JSONL files through the fleet merge core
    (tpu_mx_torch/parallel/fleet_obs.py — counters sum, histograms bucket-
    merge, gauges spread) and render/gate the FLEET view.  Each file's
    rank comes from its records' ``rank`` stamp; unstamped files (a
    controller's own registry) get distinct negative pseudo-ranks so
    they can ride along without colliding with a real rank."""
    if len(opts.file) < 2:
        ap.error("--merge needs at least two files: a.jsonl b.jsonl ...")
    fleet_obs = load_fleet_obs()
    streams = {}
    errors = []
    for idx, path in enumerate(opts.file):
        recs, _stamps, errs = read_records(path, telemetry,
                                           validate=opts.validate)
        errors += [f"{os.path.basename(path)}: {e}" for e in errs]
        rank = next((r["rank"] for r in recs
                     if isinstance(r.get("rank"), int)
                     and not isinstance(r.get("rank"), bool)), -1 - idx)
        streams.setdefault(rank, []).extend(recs)
    try:
        merged, info = fleet_obs.merge_streams(streams)
    except ValueError as e:
        print(f"VALIDATION FAILED:\n  merge: {e}", file=sys.stderr)
        return 1
    series = {(r["name"],
               json.dumps(r.get("labels", {}), sort_keys=True)): r
              for r in merged}
    print(render(series, len(opts.file),
                 " + ".join(os.path.basename(p) for p in opts.file)))
    print(f"Merged {len(opts.file)} file(s) as rank(s) "
          f"{info['ranks']} ({info['records_read']} record(s) read; "
          "negative ranks are unstamped files)")
    if opts.validate:
        # the aggregation exactness invariant, re-checked on the way out
        for rec in merged:
            if rec["type"] == "counter":
                total = sum(rec["per_rank"].values())
                if total != rec["value"]:
                    errors.append(
                        f"aggregation identity violated: {rec['name']} "
                        f"merged value {rec['value']} != per-rank sum "
                        f"{total}")
    errors += check_required(series, expand_required(opts.require))
    if not series and not errors:
        errors.append("no file contains telemetry records")
    if errors:
        print("VALIDATION FAILED:", file=sys.stderr)
        for e in errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    if opts.validate:
        print(f"schema OK: {len(series)} merged series from "
              f"{len(info['ranks'])} rank(s); aggregation identity holds")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", nargs="+",
                    help="TPUMX_TELEMETRY JSONL file (two with --diff, "
                         "two or more with --merge)")
    ap.add_argument("--validate", action="store_true",
                    help="fail on schema violations or unknown metric names")
    ap.add_argument("--require", default="",
                    help="comma-separated metric names (or preset tokens: "
                         f"{', '.join(REQUIRE_PRESETS)}) that must be "
                         "present and nonzero")
    ap.add_argument("--diff", action="store_true",
                    help="delta view between exactly two snapshot files "
                         "(counters/histograms subtracted, gauges side "
                         "by side)")
    ap.add_argument("--merge", action="store_true",
                    help="fleet view over N per-rank snapshot files "
                         "(counters summed, histograms bucket-merged, "
                         "gauges spread — the fleet_obs merge core); "
                         "--validate/--require apply to the merged view")
    opts = ap.parse_args(argv)
    telemetry = load_telemetry()
    if opts.merge:
        if opts.diff:
            ap.error("--merge and --diff are mutually exclusive")
        return run_merge(opts, telemetry, ap)
    if opts.diff:
        if len(opts.file) != 2:
            ap.error("--diff needs exactly two files: A.jsonl B.jsonl")
        path_a, path_b = opts.file
        series_a, _, errors_a = read_series(path_a, telemetry,
                                            validate=opts.validate)
        series_b, _, errors_b = read_series(path_b, telemetry,
                                            validate=opts.validate)
        print(render_diff(series_a, series_b, path_a, path_b))
        errors = [f"A: {e}" for e in errors_a] + \
                 [f"B: {e}" for e in errors_b]
        # --require composes with --diff: the gate applies to B (the
        # "after" snapshot) — silently ignoring it would let a soak
        # comparison read green with its requirement never evaluated
        errors += [f"B: {e}" for e in
                   check_required(series_b,
                                  expand_required(opts.require))]
        if not (series_a or series_b) and not errors:
            errors.append("neither file contains telemetry records")
        if errors:
            print("VALIDATION FAILED:", file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
        return 0
    if len(opts.file) != 1:
        ap.error("exactly one file expected (use --diff to compare two)")
    series, n_snapshots, errors = read_series(opts.file[0], telemetry,
                                              validate=opts.validate)
    print(render(series, n_snapshots, opts.file[0]))
    required = expand_required(opts.require)
    errors += check_required(series, required)
    if not series and not errors:
        errors.append("file contains no telemetry records")
    if errors:
        print("VALIDATION FAILED:", file=sys.stderr)
        for e in errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    if opts.validate:
        print(f"schema OK: {len(series)} series, all names in the catalog")
    return 0


if __name__ == "__main__":
    sys.exit(main())
