"""Fleet observability, from ``tpu_mx/parallel/fleet_obs.py``:
cross-worker aggregation and straggler attribution.

- **Shipping** (worker side, :class:`ObsShipper`): each worker exports a
  rolling whole-file snapshot of its telemetry registry to
  ``<fleet_dir>/obs/rank-N.jsonl`` and its recent flight-recorder events
  (with trace context and ring stats) to
  ``<fleet_dir>/obs/rank-N-events.json``, both through
  ``checkpoint.atomic_write``, rate-limited (one export per ``interval``
  seconds, forced on :meth:`~tpu_mx_torch.parallel.fleet.Fleet.leave`).
  Every shipped record and event carries the fleet identity stamp
  (``rank`` + ``fleet_generation``).

- **Merging** (:func:`merge_streams`, pure): counters sum across ranks,
  histograms bucket-merge (mismatched edges refuse loudly), gauges keep
  per-rank values plus min/max/mean.  The fleet counter equals the sum
  of the per-rank counters it merged, re-checkable from the ``per_rank``
  breakdown every merged record carries.  Records stamped with another
  membership generation than the aggregation's are excluded; a rank with
  no readable snapshot is a reported gap (``fleet.ranks_reporting``).

- **Attribution** (:func:`correlate_steps` + :class:`StragglerDetector`):
  per-rank ``train_step.phase`` events are correlated by ``(epoch, step,
  fleet_generation)`` into per-step skew (``fleet.step_skew_seconds``)
  and a slowest-rank attribution whose dominant phase explains the gap
  to the fastest rank.  A windowed detector (a rank slowest in >=
  ``frac`` of the last ``window`` correlated steps) feeds the
  ``fleet.straggler_signal`` the launcher's ``--supervise`` reports in
  its evict/degrade decisions and in the fleet black box.

The controller-side :class:`FleetAggregator` runs the whole pass per
poll and publishes the ``fleet.*`` rollups; :func:`dump_fleet_blackbox`
extends the black box with a cross-rank section, which
``tpu_mx_torch/tools/fleet_report.py`` renders.  The formats are the
reference's, so either package's tools read the other's directories.

The module imports only the standard library: it loads standalone from
its file (the package bridges are then None), so the report tool never
imports torch.
"""
from __future__ import annotations

import json
import os
import re
import time
from collections import deque

try:
    from .. import checkpoint as _ckpt
    from .. import telemetry as _telemetry
    from .. import tracing as _tracing
except ImportError:  # standalone module load (tools/fleet_report.py)
    _ckpt = _telemetry = _tracing = None

__all__ = ["OBS_DIR", "OBS_FORMAT", "FLEET_SECTION_FORMAT", "ObsShipper",
           "FleetAggregator", "StragglerDetector", "merge_streams",
           "correlate_steps", "read_obs_dir", "read_integrity_dir",
           "fleet_blackbox_path", "dump_fleet_blackbox",
           "validate_fleet_section"]

#: subdirectory of the fleet membership store holding shipped snapshots
OBS_DIR = "obs"
#: format tag of the per-rank events document
OBS_FORMAT = "tpu_mx-fleet-obs-v1"
#: format tag of the fleet section a fleet black box carries
FLEET_SECTION_FORMAT = "tpu_mx-fleet-section-v1"

#: the phases cross-rank attribution correlates (the host-side stations
#: of the compiled train step, tracing.TRAIN_STEP_PHASES)
ATTRIBUTION_PHASES = ("data_wait", "recompile", "dispatch",
                      "loss_readback", "optimizer_update")

_RANK_JSONL = re.compile(r"^rank-(\d+)\.jsonl$")
_RANK_EVENTS = re.compile(r"^rank-(\d+)-events\.json$")

#: the corruption defense's on-disk state (parallel/integrity.py
#: and Fleet.quarantine write these; read here stdlib-only so the
#: forensics tools never import torch to render a corruption verdict)
INTEGRITY_DIR = "integrity"
QUARANTINE_DIR = "quarantine"
_RANK_FP = re.compile(r"^fp-(\d+)\.json$")
_RANK_VOTES = re.compile(r"^votes-(\d+)\.jsonl$")
_RANK_QUARANTINE = re.compile(r"^(\d+)\.json$")


# ---------------------------------------------------------------------------
# worker side: shipping
# ---------------------------------------------------------------------------
class ObsShipper:
    """Rate-limited exporter of ONE worker's observability state into the
    fleet store.  Constructed lazily by ``Fleet.on_step`` (worker side
    only); every public entry point degrades to a no-op when the handle
    has no member slot or the package bridges are absent."""

    def __init__(self, fleet, interval=1.0, last_events=200):
        self.fleet = fleet
        self.interval = float(interval)
        self.last_events = int(last_events)
        self._next = 0.0          # monotonic deadline for the next export
        self.ships = 0

    def paths(self):
        """(snapshot_jsonl, events_json) for this worker's rank."""
        rank = int(self.fleet.member)
        obs = os.path.join(self.fleet.root, OBS_DIR)
        return (os.path.join(obs, f"rank-{rank}.jsonl"),
                os.path.join(obs, f"rank-{rank}-events.json"))

    def ship(self, force=False):
        """Export this rank's telemetry snapshot + recent events (whole-
        file atomic rewrites — the controller reads complete snapshots
        or nothing).  Returns the snapshot path, or None when rate-
        limited / not a fleet worker."""
        if (self.fleet.member is None or _telemetry is None
                or _ckpt is None):
            return None
        now = time.monotonic()
        if not force and now < self._next:
            return None
        self._next = now + self.interval
        rank = int(self.fleet.member)
        jsonl, events_path = self.paths()
        os.makedirs(os.path.dirname(jsonl), exist_ok=True)
        _telemetry._refresh_bridge_gauges()
        recs = _telemetry.snapshot()
        payload = "".join(json.dumps(r, sort_keys=True) + "\n"
                          for r in recs)
        with _ckpt.atomic_write(jsonl, mode="w") as f:
            f.write(payload)
        doc = {
            "format": OBS_FORMAT,
            "rank": rank,
            "generation": self.fleet.acked_generation,
            "wall_time": time.time(),
            "context": _tracing.get_context(),
            "stats": _tracing.stats(),
            "events": _tracing.snapshot(last=self.last_events),
        }
        body = _strict_json(doc)
        with _ckpt.atomic_write(events_path, mode="w") as f:
            f.write(body)
        self.ships += 1
        # counted AFTER the export: shipped snapshot N carries the count
        # through export N-1 — the off-by-one is inherent to counting
        # one's own shipping and harmless to the sum identity
        _telemetry.counter("fleet.obs_records").inc(len(recs))
        return jsonl


def _strict_json(doc):
    """Strict-JSON serialization with the same non-finite fallback as
    ``tracing.dump_blackbox``: events are non-finite-safe by
    construction, but a gauge someone set to NaN must not lose the
    export."""
    try:
        return json.dumps(doc, sort_keys=True, allow_nan=False)
    except ValueError:
        return json.dumps(doc, sort_keys=True)


# ---------------------------------------------------------------------------
# merge core (pure; loadable standalone by the report tools)
# ---------------------------------------------------------------------------
def _labels_json(rec):
    return json.dumps(rec.get("labels", {}), sort_keys=True)


def _last_per_series(records):
    """{(name, labels_json): record} — the LAST record per series wins
    (shipped snapshots are cumulative, exactly like a JSONL flush)."""
    out = {}
    for rec in records:
        name = rec.get("name")
        if isinstance(name, str) and name:
            out[(name, _labels_json(rec))] = rec
    return out


def _bucket_bounds(buckets):
    return [b for b, _ in buckets]


def _sum_buckets(name, acc, add):
    """Element-wise sum of two record-shaped cumulative bucket lists —
    valid because cumulation is linear.  Refuses loudly on mismatched
    edges: the fixed bucket ladders make edges identical across ranks
    by construction, so a mismatch is corruption, not a case to paper
    over."""
    if _bucket_bounds(acc) != _bucket_bounds(add):
        raise ValueError(
            f"{name}: histogram bucket edges differ across ranks — "
            "refusing to merge (fixed ladders should make them "
            "identical; this snapshot is corrupt or from another build)")
    return [[b, c + c2] for (b, c), (_, c2) in zip(acc, add)]


def _merge_window(kind, wins):
    """Merge the ``window`` sub-objects that exist (None entries are
    ranks whose record predates the window layer).  ``seconds`` is the
    widest coverage (windows are wall-clock-aligned per rank, so the
    union is bounded by the max), values/counts sum."""
    wins = [w for w in wins if isinstance(w, dict)]
    if not wins:
        return None
    out = {"seconds": max(float(w.get("seconds", 0.0)) for w in wins)}
    if kind == "counter":
        out["value"] = sum(w.get("value", 0) for w in wins)
        return out
    out["count"] = sum(int(w.get("count", 0)) for w in wins)
    out["sum"] = sum(float(w.get("sum", 0.0)) for w in wins)
    mins = [w["min"] for w in wins if isinstance(w.get("min"), (int, float))]
    maxs = [w["max"] for w in wins if isinstance(w.get("max"), (int, float))]
    if mins:
        out["min"], out["max"] = min(mins), max(maxs)
    buckets = None
    for w in wins:
        wb = w.get("buckets")
        if not isinstance(wb, list) or not wb:
            continue
        buckets = wb if buckets is None \
            else _sum_buckets("window", buckets, wb)
    if buckets is not None:
        out["buckets"] = buckets
    return out


def merge_streams(streams, generation=None):
    """Merge per-rank record streams into fleet rollup records.

    ``streams`` is ``{rank: [record, ...]}`` (each rank's LAST record
    per (name, labels) series wins).  When ``generation`` is given,
    records stamped with a DIFFERENT ``fleet_generation`` are excluded
    as stale (the evicted-rank rule); unstamped records are kept — a
    controller's own registry legitimately lacks the stamp.

    Returns ``(merged, info)``: ``merged`` is a list of record-shaped
    dicts — counters summed, histograms bucket-merged, gauges carrying
    ``min``/``max``/``mean`` — each with a ``per_rank`` value breakdown
    and the sorted contributing ``ranks`` (the re-checkable exactness
    invariant: ``value == sum(per_rank.values())`` for counters).
    ``info`` is ``{"ranks", "stale_dropped", "records_read"}`` — ranks
    that contributed nothing (missing or fully stale) are simply absent
    from ``info["ranks"]``, never interpolated.
    """
    per_rank_series = {}
    stale = 0
    read = 0
    for rank, records in streams.items():
        rank = int(rank)
        kept = []
        for rec in records:
            read += 1
            gen = rec.get("fleet_generation")
            if (generation is not None and gen is not None
                    and int(gen) != int(generation)):
                stale += 1
                continue
            kept.append(rec)
        last = _last_per_series(kept)
        if last:
            per_rank_series[rank] = last
    # series key -> {rank: record}
    by_series = {}
    for rank, last in sorted(per_rank_series.items()):
        for key, rec in last.items():
            by_series.setdefault(key, {})[rank] = rec
    merged = []
    for (name, lj), by_rank in sorted(by_series.items()):
        ranks = sorted(by_rank)
        recs = [by_rank[r] for r in ranks]
        kind = recs[0].get("type")
        out = {"name": name, "type": kind,
               "ts": max(float(r.get("ts", 0.0)) for r in recs),
               "ranks": ranks,
               "per_rank": {str(r): by_rank[r].get("value")
                            for r in ranks}}
        labels = json.loads(lj)
        if labels:
            out["labels"] = labels
        if generation is not None:
            out["fleet_generation"] = int(generation)
        if kind == "counter":
            out["value"] = sum(r.get("value", 0) for r in recs)
            win = _merge_window("counter", [r.get("window") for r in recs])
            if win is not None:
                out["window"] = win
        elif kind == "histogram":
            out["value"] = sum(int(r.get("value", 0)) for r in recs)
            out["sum"] = sum(float(r.get("sum", 0.0)) for r in recs)
            units = {r.get("unit", "seconds") for r in recs}
            out["unit"] = units.pop() if len(units) == 1 else "seconds"
            mins = [r["min"] for r in recs
                    if isinstance(r.get("min"), (int, float))]
            maxs = [r["max"] for r in recs
                    if isinstance(r.get("max"), (int, float))]
            if mins:
                out["min"], out["max"] = min(mins), max(maxs)
            dropped = sum(int(r.get("dropped_nonfinite", 0)) for r in recs)
            if dropped:
                out["dropped_nonfinite"] = dropped
            buckets = None
            for r in recs:
                rb = r.get("buckets")
                if not isinstance(rb, list) or not rb:
                    continue
                buckets = rb if buckets is None \
                    else _sum_buckets(name, buckets, rb)
            if buckets is not None:
                out["buckets"] = buckets
            win = _merge_window("histogram",
                                [r.get("window") for r in recs])
            if win is not None:
                out["window"] = win
        else:  # gauge: per-rank values + min/max/mean — never summed
            vals = [float(r.get("value", 0.0)) for r in recs]
            out["value"] = sum(vals) / len(vals)
            out["min"] = min(vals)
            out["max"] = max(vals)
            out["mean"] = out["value"]
        merged.append(out)
    info = {"ranks": sorted(per_rank_series),
            "stale_dropped": stale,
            "records_read": read}
    return merged, info


# ---------------------------------------------------------------------------
# cross-rank step correlation + the persistent-straggler detector
# ---------------------------------------------------------------------------
def correlate_steps(events_by_rank, generation=None):
    """Correlate per-rank ``train_step.phase`` events by
    ``(epoch, step, fleet_generation)`` into per-step skew records.

    ``events_by_rank`` is ``{rank: [event, ...]}`` (shipped flight-
    recorder snapshots).  Only steps observed by >= 2 ranks correlate —
    a single-rank step has no skew.  When ``generation`` is given, only
    steps of that membership generation are kept (the cross-rank
    timeline is aligned on the membership epoch: the same (epoch, step)
    pair under different world shapes is a different step).

    Returns a list sorted by (generation, epoch, step); each entry::

        {"generation", "epoch", "step",
         "ranks": {str(rank): {"total": sec, "phases": {phase: sec}}},
         "skew_seconds": max-min of per-rank totals,
         "slowest_rank", "fastest_rank",
         "dominant_phase": the phase explaining the largest share of
                           the slowest-vs-fastest gap}
    """
    per_key = {}
    for rank, events in events_by_rank.items():
        rank = int(rank)
        for ev in events:
            if ev.get("event") != "train_step.phase":
                continue
            epoch, step = ev.get("epoch"), ev.get("step")
            if not isinstance(epoch, int) or not isinstance(step, int):
                continue
            gen = ev.get("fleet_generation")
            gen = 0 if not isinstance(gen, int) else gen
            if generation is not None and gen != int(generation):
                continue
            data = ev.get("data", {})
            phase = data.get("phase")
            secs = data.get("seconds")
            if phase not in ATTRIBUTION_PHASES \
                    or not isinstance(secs, (int, float)):
                continue  # non-finite seconds ship as strings: skip
            slot = per_key.setdefault((gen, epoch, step), {}) \
                          .setdefault(rank, {})
            slot[phase] = slot.get(phase, 0.0) + float(secs)
    out = []
    for (gen, epoch, step), by_rank in sorted(per_key.items()):
        if len(by_rank) < 2:
            continue
        totals = {r: sum(p.values()) for r, p in by_rank.items()}
        slowest = max(totals, key=lambda r: (totals[r], r))
        fastest = min(totals, key=lambda r: (totals[r], -r))
        slow_p, fast_p = by_rank[slowest], by_rank[fastest]
        # the dominant phase is the one explaining the largest share of
        # the slowest-vs-fastest GAP — not the slowest rank's absolute
        # argmax, which a fat dispatch phase every rank pays would win
        gaps = {ph: slow_p.get(ph, 0.0) - fast_p.get(ph, 0.0)
                for ph in set(slow_p) | set(fast_p)}
        dominant = max(gaps, key=lambda ph: (gaps[ph], ph))
        out.append({
            "generation": gen, "epoch": epoch, "step": step,
            "ranks": {str(r): {"total": totals[r],
                               "phases": dict(by_rank[r])}
                      for r in sorted(by_rank)},
            "skew_seconds": totals[slowest] - totals[fastest],
            "slowest_rank": slowest,
            "fastest_rank": fastest,
            "dominant_phase": dominant,
        })
    return out


class StragglerDetector:
    """Windowed persistent-straggler detection over correlated steps.

    One slow step is noise; the detector fires only when the SAME rank
    is the slowest in >= ``frac`` of the last ``window`` correlated
    steps (and at least ``min_steps`` have been judged).  ``signal`` is
    the published hook dict — the ``scheduler.slo_signal`` twin the
    fleet supervisor consumes::

        {"straggling": bool, "rank": int (-1 = none),
         "excess_seconds": mean skew of the rank's slowest steps,
         "dominant_phase": modal dominant phase, "steps": judged count,
         "window": window}

    State flips land on the flight-recorder timeline as
    ``fleet.straggler`` events.
    """

    def __init__(self, window=12, frac=0.5, min_steps=4,
                 min_excess_seconds=0.0):
        self.window = int(window)
        self.frac = float(frac)
        self.min_steps = int(min_steps)
        self.min_excess_seconds = float(min_excess_seconds)
        self._history = deque(maxlen=self.window)
        self._latest = None       # highest (gen, epoch, step) judged
        self.signal = self._clear()

    def _clear(self):
        return {"straggling": False, "rank": -1, "excess_seconds": 0.0,
                "dominant_phase": "", "steps": 0, "window": self.window}

    def update(self, correlated):
        """Feed a (re-read, possibly overlapping) correlated-step list;
        only steps NEWER than the last judged one enter the window —
        shipped event snapshots are rolling, so every poll re-reads the
        recent past.  Returns the (possibly flipped) signal dict."""
        for c in correlated:
            key = (c["generation"], c["epoch"], c["step"])
            if self._latest is not None and key <= self._latest:
                continue
            self._latest = key
            self._history.append((c["slowest_rank"], c["skew_seconds"],
                                  c["dominant_phase"]))
        return self._evaluate()

    def _evaluate(self):
        prev = dict(self.signal)
        n = len(self._history)
        new = self._clear()
        if n >= self.min_steps:
            counts = {}
            for rank, _skew, _ph in self._history:
                counts[rank] = counts.get(rank, 0) + 1
            rank = max(counts, key=lambda r: (counts[r], r))
            entries = [(s, ph) for r, s, ph in self._history if r == rank]
            excess = sum(s for s, _ in entries) / len(entries)
            if (counts[rank] >= self.frac * n
                    and excess >= self.min_excess_seconds):
                phases = {}
                for _, ph in entries:
                    phases[ph] = phases.get(ph, 0) + 1
                new = {"straggling": True, "rank": int(rank),
                       "excess_seconds": excess,
                       "dominant_phase": max(phases,
                                             key=lambda p: (phases[p], p)),
                       "steps": len(entries), "window": self.window}
        self.signal = new
        if (new["straggling"], new["rank"]) != (prev["straggling"],
                                                prev["rank"]) \
                and _tracing is not None:
            _tracing.emit("fleet.straggler", rank=new["rank"],
                          excess_seconds=float(new["excess_seconds"]),
                          phase=new["dominant_phase"],
                          steps=int(new["steps"]))
        return dict(new)


# ---------------------------------------------------------------------------
# controller side: the aggregation pass
# ---------------------------------------------------------------------------
def read_obs_dir(root):
    """Read every shipped snapshot under ``<root>/obs/``.

    Returns ``({rank: [record, ...]}, {rank: events_doc})``.  Unreadable
    or half-written files are skipped (atomic_write makes that rare;
    a skipped rank is a reported gap, not an error)."""
    obs = os.path.join(root, OBS_DIR)
    streams, docs = {}, {}
    try:
        names = sorted(os.listdir(obs))
    except OSError:
        return streams, docs
    for name in names:
        path = os.path.join(obs, name)
        m = _RANK_JSONL.match(name)
        if m:
            recs = []
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict):
                            recs.append(rec)
            except OSError:
                continue
            if recs:
                streams[int(m.group(1))] = recs
            continue
        m = _RANK_EVENTS.match(name)
        if m:
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(doc, dict) and doc.get("format") == OBS_FORMAT:
                docs[int(m.group(1))] = doc
    return streams, docs


def read_integrity_dir(fleet_dir, last_votes=50):
    """Read the SDC defense plane's on-disk state under ``fleet_dir``.

    Returns the black box's ``corruption`` section: each rank's newest
    published fingerprint (``integrity/fp-<rank>.json``), the tail of
    each rank's vote journal (``integrity/votes-<rank>.jsonl``), every
    permanent quarantine record (``quarantine/<rank>.json``), and a
    one-object ``verdict`` summarising them — ``clean`` is True only
    when no vote ever disagreed AND no rank is quarantined.  Unreadable
    or half-written files are skipped, same policy as
    :func:`read_obs_dir`: a gap is reported, never raised."""
    root = os.fspath(fleet_dir)
    fingerprints, votes_by_rank, quarantined = {}, {}, {}
    idir = os.path.join(root, INTEGRITY_DIR)
    try:
        names = sorted(os.listdir(idir))
    except OSError:
        names = []
    for name in names:
        path = os.path.join(idir, name)
        m = _RANK_FP.match(name)
        if m:
            try:
                with open(path, encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict):
                fingerprints[str(int(m.group(1)))] = rec
            continue
        m = _RANK_VOTES.match(name)
        if m:
            recs = []
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict):
                            recs.append(rec)
            except OSError:
                continue
            if recs:
                votes_by_rank[str(int(m.group(1)))] = recs[-last_votes:]
    qdir = os.path.join(root, QUARANTINE_DIR)
    try:
        qnames = sorted(os.listdir(qdir))
    except OSError:
        qnames = []
    for name in qnames:
        m = _RANK_QUARANTINE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(qdir, name), encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict):
            quarantined[str(int(m.group(1)))] = rec
    mismatch_steps, suspected = set(), set()
    for recs in votes_by_rank.values():
        for v in recs:
            if not v.get("agree", True):
                mismatch_steps.add(int(v.get("step", -1)))
                suspected.update(int(m) for m in v.get("minority", []))
    return {
        "fingerprints": fingerprints,
        "votes_by_rank": votes_by_rank,
        "quarantined": quarantined,
        "verdict": {
            "clean": not mismatch_steps and not quarantined,
            "mismatch_steps": sorted(mismatch_steps),
            "suspected": sorted(suspected),
            "quarantined": sorted(int(r) for r in quarantined),
        },
    }


class FleetAggregator:
    """The controller's periodic merge pass over ``<fleet_dir>/obs/``.

    ``poll()`` (rate-limited; ``force=True`` for dump paths) reads every
    rank's shipped snapshot, merges at the CURRENT membership
    generation, correlates phases, updates the straggler detector, and
    publishes the ``fleet.*`` rollup metrics into the controller's own
    registry.  Rollups are published under NEW names only — per-rank
    worker metrics are returned, never re-registered under their own
    names in the controller (the controller may itself train; replaying
    worker counters into its registry would double-count)."""

    def __init__(self, fleet, interval=1.0, detector=None):
        self.fleet = fleet
        self.interval = float(interval)
        self.detector = detector or StragglerDetector()
        self._next = 0.0
        self.last = None

    def poll(self, force=False):
        """Run one aggregation pass (or return the cached one inside the
        rate-limit window).  Returns the pass result dict, or None when
        nothing has been shipped yet."""
        now = time.monotonic()
        if not force and now < self._next:
            return self.last
        self._next = now + self.interval
        streams, docs = read_obs_dir(self.fleet.root)
        generation = self.fleet.generation
        merged, info = merge_streams(streams, generation=generation)
        events_by_rank = {r: d.get("events", []) for r, d in docs.items()
                          if isinstance(d.get("events"), list)}
        # no generation FILTER here: the correlation key already carries
        # the membership generation (same (epoch, step) under another
        # epoch is a different step), and the post-mortem skew timeline
        # must keep the steps that led UP to a churn — only the metric
        # MERGE excludes stale-generation records
        correlated = correlate_steps(events_by_rank)
        signal = self.detector.update(correlated)
        self.last = {
            "generation": generation,
            "world": self.fleet.world(),
            "merged": merged,
            "info": info,
            "streams": streams,
            "docs": docs,
            "correlated": correlated,
            "signal": signal,
            "wall_time": time.time(),
        }
        self._publish(self.last)
        return self.last

    def _publish(self, res):
        if _telemetry is None:
            return
        info = res["info"]
        _telemetry.gauge("fleet.ranks_reporting").set(len(info["ranks"]))
        stamps = [d.get("wall_time") for d in res["docs"].values()
                  if isinstance(d.get("wall_time"), (int, float))]
        if stamps:
            _telemetry.gauge("fleet.agg_lag_seconds").set(
                max(0.0, res["wall_time"] - min(stamps)))
        for rec in res["merged"]:
            if rec["name"] == "train_step.steps" and not rec.get("labels"):
                win = rec.get("window") or {}
                secs = float(win.get("seconds", 0.0))
                if secs > 0:
                    _telemetry.gauge("fleet.step_rate").set(
                        float(win.get("value", 0)) / secs)
        if res["correlated"]:
            _telemetry.gauge("fleet.step_skew_seconds").set(
                res["correlated"][-1]["skew_seconds"])
        sig = res["signal"]
        _telemetry.gauge("fleet.straggler_signal").set(
            1.0 if sig["straggling"] else 0.0)
        _telemetry.gauge("fleet.straggler_rank").set(float(sig["rank"]))


# ---------------------------------------------------------------------------
# the fleet black box
# ---------------------------------------------------------------------------
def fleet_blackbox_path(fleet_dir):
    return os.path.join(os.fspath(fleet_dir), "fleet-blackbox.json")


def _fleet_section(res):
    """The cross-rank section a fleet black box carries, built from one
    aggregation pass so the per-rank data and the aggregate are a
    consistent read (the identity re-check depends on that)."""
    ranks = {}
    for r in sorted(set(res["streams"]) | set(res["docs"])):
        doc = res["docs"].get(r, {})
        ranks[str(r)] = {
            "generation": int(doc.get("generation", 0)),
            "wall_time": doc.get("wall_time"),
            "context": doc.get("context", {}),
            "stats": doc.get("stats", {}),
            "events": doc.get("events", []),
            "telemetry": res["streams"].get(r, []),
        }
    return {
        "format": FLEET_SECTION_FORMAT,
        "generation": int(res["generation"]),
        "world": [int(m) for m in res["world"]],
        "ranks_reporting": res["info"]["ranks"],
        "stale_dropped": res["info"]["stale_dropped"],
        "ranks": ranks,
        "aggregate": res["merged"],
        "skew_timeline": res["correlated"],
        "straggler_signal": res["signal"],
    }


def dump_fleet_blackbox(fleet_dir, reason="", aggregator=None, fleet=None,
                        last=200):
    """Persist ``<fleet_dir>/fleet-blackbox.json``: the black-box
    document (format unchanged — every existing reader still validates
    it) EXTENDED with the cross-rank ``fleet`` section.  Pass the live
    ``aggregator`` for a fresh forced pass, or ``fleet`` to run a one-
    shot pass without one.  Returns the path (None when the package
    bridges are absent)."""
    if _tracing is None or _ckpt is None:
        return None
    if aggregator is None:
        if fleet is None:
            raise ValueError("dump_fleet_blackbox needs an aggregator "
                             "or a fleet handle")
        aggregator = FleetAggregator(fleet)
    res = aggregator.poll(force=True)
    doc = _tracing.blackbox_doc(reason=reason, last=last)
    doc["fleet"] = _fleet_section(res)
    # the corruption verdict rides beside the skew timeline: who
    # published what fingerprint, how every vote went, who is
    # permanently quarantined (read from disk, not from the aggregation
    # pass — the dying rank's last vote must survive its eviction)
    doc["fleet"]["corruption"] = read_integrity_dir(fleet_dir)
    path = fleet_blackbox_path(fleet_dir)
    with _ckpt.atomic_write(path, mode="w") as f:
        f.write(_strict_json(doc))
    if _telemetry is not None:
        _telemetry.counter("tracing.blackbox_dumps").inc()
    _tracing.emit("supervisor.blackbox", path=path, reason=str(reason))
    return path


def validate_fleet_section(doc, telemetry=None):
    """Raise ValueError unless ``doc`` (a black-box document) carries a
    schema-valid ``fleet`` section whose aggregation identity HOLDS:
    re-merging the stored per-rank telemetry at the section's
    generation must reproduce every aggregate counter exactly, and each
    merged counter's value must equal the sum of its own ``per_rank``
    breakdown.  ``telemetry`` (the standalone-loaded module) adds
    per-record schema validation of the aggregate when given."""
    fl = doc.get("fleet")
    if not isinstance(fl, dict):
        raise ValueError("black box has no 'fleet' section")
    if fl.get("format") != FLEET_SECTION_FORMAT:
        raise ValueError(f"unknown fleet-section format "
                         f"{fl.get('format')!r} (this build reads "
                         f"{FLEET_SECTION_FORMAT})")
    if not isinstance(fl.get("generation"), int):
        raise ValueError("fleet section missing int 'generation'")
    ranks = fl.get("ranks")
    if not isinstance(ranks, dict):
        raise ValueError("fleet section missing the 'ranks' object")
    for r, body in ranks.items():
        if not isinstance(body, dict) \
                or not isinstance(body.get("events"), list) \
                or not isinstance(body.get("telemetry"), list):
            raise ValueError(f"fleet section rank {r}: missing "
                             "events/telemetry lists")
    agg = fl.get("aggregate")
    if not isinstance(agg, list):
        raise ValueError("fleet section missing the 'aggregate' list")
    for field in ("skew_timeline",):
        if not isinstance(fl.get(field), list):
            raise ValueError(f"fleet section missing the {field!r} list")
    sig = fl.get("straggler_signal")
    if not isinstance(sig, dict) or "straggling" not in sig \
            or not isinstance(sig.get("rank"), int):
        raise ValueError("fleet section missing a straggler_signal "
                         "object with straggling/rank")
    corr = fl.get("corruption")
    if not isinstance(corr, dict):
        raise ValueError("fleet section missing the 'corruption' object")
    for field in ("fingerprints", "votes_by_rank", "quarantined"):
        if not isinstance(corr.get(field), dict):
            raise ValueError(f"corruption section missing the "
                             f"{field!r} object")
    cv = corr.get("verdict")
    if not isinstance(cv, dict) or not isinstance(cv.get("clean"), bool) \
            or not all(isinstance(cv.get(k), list) for k in
                       ("mismatch_steps", "suspected", "quarantined")):
        raise ValueError("corruption section missing a verdict object "
                         "with clean/mismatch_steps/suspected/quarantined")
    # the verdict must be derivable from the stored votes + quarantine
    # records — a black box claiming 'clean' over a disagreeing vote is
    # itself corrupt
    if cv["clean"] and (cv["mismatch_steps"] or cv["quarantined"]):
        raise ValueError("corruption verdict claims clean over recorded "
                         "mismatches/quarantines")
    for recs in corr["votes_by_rank"].values():
        if not isinstance(recs, list):
            raise ValueError("votes_by_rank values must be lists")
        for v in recs:
            if not isinstance(v, dict) or "agree" not in v \
                    or "step" not in v:
                raise ValueError(f"malformed vote record: {v!r}")
            if not v["agree"] and int(v["step"]) not in cv["mismatch_steps"]:
                raise ValueError(
                    f"vote at step {v['step']} disagreed but is absent "
                    f"from verdict.mismatch_steps")
    for entry in fl["skew_timeline"]:
        if not isinstance(entry, dict) \
                or not isinstance(entry.get("skew_seconds"), (int, float)) \
                or not isinstance(entry.get("slowest_rank"), int) \
                or not isinstance(entry.get("dominant_phase"), str):
            raise ValueError(f"malformed skew_timeline entry: {entry!r}")
    # the exactness invariant, re-checked from the document alone:
    # (a) every merged counter equals the sum of its per_rank breakdown
    for rec in agg:
        if telemetry is not None:
            telemetry.validate_record(rec)
        if rec.get("type") == "counter" and isinstance(
                rec.get("per_rank"), dict):
            total = sum(rec["per_rank"].values())
            if total != rec.get("value"):
                raise ValueError(
                    f"aggregation identity violated: {rec['name']} "
                    f"value {rec.get('value')} != per-rank sum {total}")
    # (b) re-merging the stored per-rank snapshots reproduces the
    # aggregate counters exactly (the end-to-end sum identity)
    streams = {int(r): body["telemetry"] for r, body in ranks.items()}
    remerged, _ = merge_streams(streams, generation=fl["generation"])
    want = {(r["name"], _labels_json(r)): r["value"]
            for r in agg if r.get("type") == "counter"}
    got = {(r["name"], _labels_json(r)): r["value"]
           for r in remerged if r.get("type") == "counter"}
    if want != got:
        diff = {k for k in set(want) | set(got)
                if want.get(k) != got.get(k)}
        raise ValueError(
            "aggregation identity violated: re-merging the per-rank "
            f"snapshots disagrees with the stored aggregate on {sorted(diff)}")
    return doc
