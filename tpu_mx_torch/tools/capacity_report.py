#!/usr/bin/env python
"""Render the capacity ledger: pool timeline, top holders, forensics; the
port's copy of the reference's ``tools/capacity_report.py``, with the
same arguments, output and exit codes.

The serving runtime's capacity accounting layer
(tpu_mx_torch/serving/accounting.py) attributes every KV block-pool byte to a
holder and a tenant, publishes the attribution as the ``serve.pool_*``
gauges on every telemetry flush, and dumps an exhaustion forensic
record — every live holder named — on each ``CacheExhausted`` and
pressure eviction.  This tool is the host-only ops view over that data:

- **Ledger timeline**: one row per telemetry flush — pool-used bytes,
  high watermark and free-list fragmentation over the run (the
  fragmentation trend rides this table);
- **Per-tenant attribution**: the last snapshot's
  ``serve.pool_bytes{tenant,kind}`` gauges — amortized (1/refcount
  shares, sums to pool-used bytes) next to exclusive-if-forked cost —
  plus index residency, pinned blocks and host RSS;
- **Exhaustion forensics** (``--forensics <prefix>-capacity.json``):
  each recorded capacity event with its top holders — sequence/tenant,
  block counts, pinned/shared state, age — "who was holding the pool
  when backpressure hit";
- **Capacity twins**: the training-side gauges (per-shape jit compile
  count/seconds, checkpoint bytes-on-disk) when present.

``--validate`` schema-gates every telemetry record against the catalog,
re-checks the accounting identity offline (per snapshot: the amortized
per-tenant gauges must sum to ``serve.pool_used_bytes``), and validates
the forensic document against its schema — including the
100%-of-holders and per-record identity gates.  Exit status: 0 ok, 1
validation failure, 2 unreadable input — the same contract as
slo_report.py and blackbox_report.py.

    python tpu_mx_torch/tools/capacity_report.py metrics.jsonl --forensics PREFIX-capacity.json --validate

``telemetry`` and ``serving/accounting`` are loaded standalone from their
files (standard library only at module level): run as a script, the tool
never imports torch or the package, and works on a machine with no
accelerator stack at all.
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


# share the standalone loaders: blackbox_report loads the package's
# modules by file path (never the package), slo_report the JSONL series
# reader — one implementation each, no drift
load_module = sibling("blackbox_report").load_module
read_series = sibling("slo_report").read_series

# tolerance for the offline identity re-check: the LIVE identity is
# exact Fraction math; each gauge rounds one tenant's share to a float
IDENTITY_RTOL = 1e-6


def load_accounting():
    """Load the package's serving/accounting.py standalone (stdlib-only,
    like telemetry/tracing — its package-relative imports degrade to
    local fallbacks)."""
    return load_module("serving/accounting")


def read_timeline(path):
    """Every ``serve.pool_*`` gauge record grouped by snapshot ``ts``,
    in file order: ``[(ts, {name: value})]`` — the ledger timeline."""
    rows = []
    by_ts = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # --validate reports it via read_series
            name = rec.get("name", "")
            if not (name.startswith("serve.pool_")
                    or name == "serve.prefix_index_bytes"):
                continue
            ts = rec.get("ts")
            if ts not in by_ts:
                by_ts[ts] = {}
                rows.append((ts, by_ts[ts]))
            labels = rec.get("labels") or {}
            key = name
            if labels:
                key += "{%s}" % ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items()))
            by_ts[ts][key] = rec.get("value")
    return rows


def _mib(v):
    return "-" if v is None else f"{v / 2 ** 20:.3f}"


def render_timeline(timeline):
    lines = ["Ledger timeline (one row per telemetry flush; MiB):",
             "  %-6s %12s %12s %14s %8s" %
             ("snap", "used", "watermark", "index", "frag")]
    if not timeline:
        lines.append("  (no serve.pool_* gauges — training-only "
                     "snapshot, or a pre-ledger run)")
        return lines
    for i, (_, vals) in enumerate(timeline):
        lines.append("  %-6d %12s %12s %14s %8s" % (
            i,
            _mib(vals.get("serve.pool_used_bytes")),
            _mib(vals.get("serve.pool_high_watermark_bytes")),
            _mib(vals.get("serve.prefix_index_bytes")),
            "-" if vals.get("serve.pool_fragmentation") is None
            else f"{vals['serve.pool_fragmentation']:.3f}"))
    return lines


def tenant_rows(series):
    """{tenant: {kind: value}} from the last-snapshot pool_bytes gauges."""
    out = {}
    for (name, lj), rec in series.items():
        if name != "serve.pool_bytes":
            continue
        labels = json.loads(lj)
        tenant = labels.get("tenant", "?")
        out.setdefault(tenant, {})[labels.get("kind", "?")] = \
            rec.get("value", 0.0)
    return out


def render_tenants(series):
    tenants = tenant_rows(series)
    lines = ["Per-tenant pool attribution (last snapshot; MiB):",
             "  %-16s %14s %16s" % ("Tenant", "amortized",
                                    "exclusive-if-forked")]
    if not tenants:
        lines.append("  (no serve.pool_bytes series)")
        return lines
    for tenant in sorted(tenants,
                         key=lambda t: -tenants[t].get("amortized", 0.0)):
        d = tenants[tenant]
        lines.append("  %-16s %14s %16s" % (
            tenant, _mib(d.get("amortized")), _mib(d.get("exclusive"))))
    total = sum(d.get("amortized", 0.0) for d in tenants.values())
    used = (series.get(("serve.pool_used_bytes", "{}")) or {}).get("value")
    lines.append("  %-16s %14s %16s" % ("(sum)", _mib(total), ""))
    lines.append("  %-16s %14s %16s  <- the accounting identity"
                 % ("(pool used)", _mib(used), ""))
    return lines


def render_pool_state(series):
    def val(name):
        return (series.get((name, "{}")) or {}).get("value")

    lines = ["Pool state (last snapshot):"]
    frag = val("serve.pool_fragmentation")
    pinned = val("serve.pool_pinned_blocks")
    rss = val("host.rss_bytes")
    lines.append(f"  used {_mib(val('serve.pool_used_bytes'))} MiB, "
                 f"high watermark "
                 f"{_mib(val('serve.pool_high_watermark_bytes'))} MiB, "
                 f"prefix index {_mib(val('serve.prefix_index_bytes'))} "
                 "MiB")
    lines.append("  fragmentation "
                 + ("-" if frag is None else f"{frag:.3f}")
                 + ", pinned blocks "
                 + ("-" if pinned is None else f"{pinned:g}")
                 + ", host RSS " + _mib(rss) + " MiB")
    return lines


def render_twins(series):
    """The training-side capacity twins, when present."""
    rows = []
    for (name, lj), rec in sorted(series.items()):
        if name == "train_step.compiles":
            sig = json.loads(lj).get("signature", "?")
            rows.append(f"  jit compiles [{sig}]: {rec.get('value')}")
        elif name == "train_step.compile_seconds":
            sig = json.loads(lj).get("signature", "?")
            rows.append(f"  compile seconds [{sig}]: "
                        f"{rec.get('sum', 0.0):.3f}s over "
                        f"{rec.get('value')} build(s)")
        elif name == "checkpoint.bytes_on_disk":
            rows.append(f"  checkpoint bytes on disk: "
                        f"{_mib(rec.get('value'))} MiB")
    if not rows:
        return []
    return ["Training-side capacity twins:"] + rows


def render_forensics(doc, top):
    recs = doc.get("records", [])
    lines = [f"Exhaustion forensics ({len(recs)} recorded capacity "
             "event(s)):"]
    if not recs:
        lines.append("  (no capacity events recorded)")
        return lines
    for rec in recs:
        pool = rec.get("pool", {})
        lines.append(
            "  [%s] need=%s free=%s released=%s used=%s/%s blocks "
            "frag=%.3f" % (
                rec.get("kind"), rec.get("need"), rec.get("free"),
                rec.get("released"), pool.get("used_blocks"),
                pool.get("num_blocks"), pool.get("fragmentation", 0.0)))
        holders = sorted(rec.get("holders", []),
                         key=lambda h: -h.get("blocks", 0))
        lines.append("    %-10s %-22s %-12s %7s %6s %6s %7s %8s" % (
            "kind", "holder", "tenant", "blocks", "excl", "shared",
            "pinned", "age(s)"))
        for h in holders[:top]:
            lines.append("    %-10s %-22s %-12s %7d %6d %6d %7s %8.2f"
                         % (h.get("kind"), h.get("id"), h.get("tenant"),
                            h.get("blocks", 0),
                            h.get("exclusive_blocks", 0),
                            h.get("shared_blocks", 0),
                            "yes" if h.get("pinned") else "no",
                            h.get("age_seconds", 0.0)))
        if len(holders) > top:
            lines.append(f"    ... and {len(holders) - top} more "
                         "holder(s)")
    return lines


def validate_identity(path, telemetry):
    """Re-check the accounting identity offline, per snapshot: the
    amortized per-tenant ``serve.pool_bytes`` gauges must sum to
    ``serve.pool_used_bytes`` within float-rendering tolerance."""
    errors = []
    by_ts = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # reported by the schema pass
            name = rec.get("name")
            if name not in ("serve.pool_bytes", "serve.pool_used_bytes"):
                continue
            snap = by_ts.setdefault(rec.get("ts"), {"used": None,
                                                    "amortized": 0.0})
            if name == "serve.pool_used_bytes":
                snap["used"] = rec.get("value")
            elif (rec.get("labels") or {}).get("kind") == "amortized":
                snap["amortized"] += rec.get("value", 0.0)
    for ts, snap in by_ts.items():
        if snap["used"] is None:
            continue
        drift = abs(snap["amortized"] - snap["used"])
        if drift > max(IDENTITY_RTOL * snap["used"], 1e-6):
            errors.append(
                f"snapshot ts={ts}: per-tenant amortized bytes sum to "
                f"{snap['amortized']} but serve.pool_used_bytes is "
                f"{snap['used']} — the accounting identity is broken")
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file", help="TPUMX_TELEMETRY JSONL snapshot file")
    ap.add_argument("--forensics", default=None,
                    help="a <prefix>-capacity.json forensic dump: adds "
                         "the exhaustion-forensics section")
    ap.add_argument("--top", type=int, default=8,
                    help="holders to show per forensic record (default 8)")
    ap.add_argument("--validate", action="store_true",
                    help="fail on schema violations or accounting-"
                         "identity breaks")
    opts = ap.parse_args(argv)
    telemetry = load_module("telemetry")
    accounting = load_accounting()
    try:
        series, errors = read_series(opts.file, telemetry,
                                     validate=opts.validate)
        timeline = read_timeline(opts.file)
    except OSError as e:
        print(f"capacity_report: cannot read {opts.file}: {e}",
              file=sys.stderr)
        return 2
    doc = None
    if opts.forensics:
        try:
            with open(opts.forensics, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"capacity_report: cannot read {opts.forensics}: {e}",
                  file=sys.stderr)
            return 2

    out = [f"Capacity report: {opts.file}", ""]
    out.extend(render_timeline(timeline))
    out.append("")
    out.extend(render_tenants(series))
    out.append("")
    out.extend(render_pool_state(series))
    twins = render_twins(series)
    if twins:
        out.append("")
        out.extend(twins)
    if doc is not None:
        out.append("")
        out.extend(render_forensics(doc, opts.top))
    print("\n".join(out))

    if opts.validate:
        if not series:
            errors.append("file contains no telemetry records")
        errors.extend(validate_identity(opts.file, telemetry))
        if doc is not None:
            try:
                accounting.validate_forensic_doc(doc)
            except ValueError as e:
                errors.append(f"forensics: {e}")
        if errors:
            print("VALIDATION FAILED:", file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
        n_rec = len((doc or {}).get("records", []))
        print(f"schema OK: {len(series)} series"
              + (f", {n_rec} forensic record(s)" if doc is not None
                 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
