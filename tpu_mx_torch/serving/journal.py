"""The committed-token journal: durable stream resumption in O(tokens).

The port of ``tpu_mx/serving/journal.py``, in the same format
(:data:`JOURNAL_FORMAT`): a journal one package writes, the other loads.
A serving process that dies loses every in-flight generation; K/V is
recomputable (K/V at position p is a function of the tokens before it),
so the only state worth making durable is the committed token stream,
plus the sampler's RNG capsule for non-greedy modes
(serving/sampling.py).  The journal is an append-only JSONL file the
server fsyncs once per engine step, and recovery is one
``prefill(prompt + committed_tokens)`` per stream, never a re-decode.

Record stream (``<prefix>-journal.jsonl``)::

    {"format": "tpu_mx-serve-journal-v1"}
    {"op": "begin", "request": id, "tenant": t, "prompt": [...],
     "max_new": N, "sampler": <capsule or null>}
    {"op": "token", "request": id, "i": 0, "token": 17,
     "rng": <capsule-after-this-sample or null>}
    ...
    {"op": "end", "request": id, "reason": "length"}

Durability:

- ``begin`` is flushed and fsync'd at admission — an accepted request is
  durable before its handle is returned.
- ``token`` records are buffered and fsync'd ONCE per server step,
  before the step returns — so every token a streaming client has been
  handed is already on disk.  A token lost to a tear was never
  client-visible.
- ``end`` retires the request; :meth:`TokenJournal.compact` rewrites the
  file without retired streams through ``checkpoint.atomic_write``.

Recovery (:func:`load`) never guesses:

- A torn final line was never fsync'd complete and never client-visible
  — dropped, loudly.
- Deeper corruption — a mid-file parse error, a token index gap, a token
  without its ``begin`` — degrades that stream (or, when framing is
  lost, every unfinished stream) to **prompt replay**: committed tokens
  are discarded, the sampler falls back to its ``begin``-time state, and
  the stream re-rolls from the start; ``fallback`` on the entry (and
  the server's ``serve.replay_fallbacks``) says so.
- A duplicate ``begin`` for one id — last incarnation wins.
"""
from __future__ import annotations

import json
import logging
import os
import threading

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..checkpoint import atomic_write

__all__ = ["JOURNAL_FORMAT", "TokenJournal", "load", "journal_path"]

log = logging.getLogger(__name__)

JOURNAL_FORMAT = "tpu_mx-serve-journal-v1"


def journal_path(prefix):
    """The journal file a ``Server(journal=prefix)`` appends to."""
    return f"{os.fspath(prefix)}-journal.jsonl"


class TokenJournal:
    """Append-only writer (one per server; see module docstring).

    Thread-safety: ``begin`` runs on submitting threads, ``commit_token``
    / ``end`` / ``flush`` on the step thread — one lock covers the
    buffer and the file handle."""

    def __init__(self, prefix):
        self.path = journal_path(prefix)
        self._lock = threading.Lock()
        self._buf = []
        fresh = not os.path.exists(self.path) \
            or os.path.getsize(self.path) == 0
        self._f = open(self.path, "a", encoding="utf-8")
        if fresh:
            self._append({"format": JOURNAL_FORMAT})
            self._fsync()

    # -- write side ----------------------------------------------------------
    def _append(self, record):
        line = json.dumps(record, separators=(",", ":")) + "\n"
        self._buf.append(line)

    def _fsync(self):
        """Drain the buffer to disk (caller holds the lock or is the
        constructor).  The fsync is the durability boundary — a record
        is only *promised* once this ran after it."""
        if self._buf:
            data = "".join(self._buf)
            self._buf = []
            self._f.write(data)
            _telemetry.counter("serve.journal_bytes").inc(
                len(data.encode("utf-8")))
        self._f.flush()
        os.fsync(self._f.fileno())

    def begin(self, req, sync=True):
        """Journal an admission — durable before the handle returns.
        ``sync=False`` (the legacy-arm re-begin: a ``replay=False``
        requeue re-rolls the stream, so its token indices restart at 0
        and the entry must restart with them — last incarnation wins)
        buffers the record for the next step-boundary flush instead:
        every requeue path flushes before the stream can advance."""
        sampler = getattr(req, "sampler", None)
        with self._lock:
            self._append({"op": "begin", "request": req.id,
                          "tenant": req.tenant,
                          "prompt": list(req.prompt),
                          "max_new": req.max_new_tokens,
                          "sampler": (sampler.state_dict()
                                      if sampler is not None else None)})
            if sync:
                self._fsync()
        if sync:
            # re-begins are incarnations of an already-counted stream —
            # journal_requests stays "streams journaled at admission"
            _telemetry.counter("serve.journal_requests").inc()

    def commit_token(self, req, token):
        """Buffer one committed token (``req.tokens`` already holds it —
        ``i`` is its stream index) plus the sampler state AFTER the
        sample, so a recovered stream continues mid-roll."""
        sampler = getattr(req, "sampler", None)
        with self._lock:
            self._append({"op": "token", "request": req.id,
                          "i": len(req.tokens) - 1, "token": int(token),
                          "rng": (sampler.state_dict()
                                  if sampler is not None else None)})
        _telemetry.counter("serve.journal_tokens").inc()

    def end(self, req, reason):
        with self._lock:
            self._append({"op": "end", "request": req.id,
                          "reason": str(reason)[:120]})

    def flush(self):
        """The once-per-step durability point (module docstring)."""
        with self._lock:
            self._fsync()

    def close(self):
        with self._lock:
            self._fsync()
            self._f.close()

    # -- maintenance ---------------------------------------------------------
    def compact(self):
        """Rewrite the journal without retired streams (atomic_write:
        tmp + fsync + rename), then reopen for append.  Returns the
        number of live streams kept."""
        with self._lock:
            self._fsync()
            self._f.close()
            entries = load(self.path)
            live = {rid: e for rid, e in entries.items()
                    if not e["ended"]}
            with atomic_write(self.path, mode="w") as f:
                f.write(json.dumps({"format": JOURNAL_FORMAT},
                                   separators=(",", ":")) + "\n")
                for rid, e in live.items():
                    f.write(json.dumps(
                        {"op": "begin", "request": rid,
                         "tenant": e["tenant"], "prompt": e["prompt"],
                         "max_new": e["max_new"],
                         "sampler": e["sampler"]},
                        separators=(",", ":")) + "\n")
                    for i, (tok, rng) in enumerate(
                            zip(e["tokens"], e["rngs"])):
                        f.write(json.dumps(
                            {"op": "token", "request": rid, "i": i,
                             "token": tok, "rng": rng},
                            separators=(",", ":")) + "\n")
            self._f = open(self.path, "a", encoding="utf-8")
            return len(live)


def _fresh_entry(rec):
    return {"tenant": rec.get("tenant"),
            "prompt": [int(t) for t in rec.get("prompt", [])],
            "max_new": int(rec.get("max_new", 1)),
            "sampler": rec.get("sampler"),
            "tokens": [], "rngs": [],
            "ended": False, "end_reason": None, "fallback": False}


def load(path):
    """Parse a journal into ``{request_id: entry}`` (module docstring
    for the never-guess rules).  Entry fields: ``prompt`` / ``tenant``
    / ``max_new`` / ``sampler`` (the begin-time capsule) / ``tokens``
    (trusted committed stream) / ``rngs`` (per-token capsules) /
    ``ended`` / ``fallback`` (True = corruption forced this stream to
    prompt replay)."""
    entries = {}
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    if not lines:
        return entries
    head = lines[0].strip()
    try:
        fmt = json.loads(head).get("format")
    except (json.JSONDecodeError, AttributeError):
        fmt = None
    if fmt != JOURNAL_FORMAT:
        raise MXNetError(
            f"serve journal {path}: unrecognized format header {head!r} "
            f"(expected {JOURNAL_FORMAT!r}) — refusing to guess")
    corrupt_at = None
    for n, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            op = rec["op"]
        except (json.JSONDecodeError, KeyError, TypeError):
            if n == len(lines):
                # torn final append: never fsync'd complete, never
                # client-visible — drop it and say so
                log.warning("serve journal %s: dropping torn final "
                            "record (line %d)", path, n)
                break
            corrupt_at = n
            break
        if op == "begin":
            # last incarnation wins (a recovered process re-begins)
            entries[rec["request"]] = _fresh_entry(rec)
        elif op == "token":
            e = entries.get(rec["request"])
            if e is None or e["fallback"]:
                if e is None:
                    log.error("serve journal %s: token for unknown "
                              "request %r at line %d — stream lost",
                              path, rec.get("request"), n)
                continue
            if int(rec.get("i", -1)) != len(e["tokens"]):
                log.error(
                    "serve journal %s: token index gap for %s at line "
                    "%d (got i=%s, expected %d) — degrading this "
                    "stream to prompt replay, never guessing",
                    path, rec["request"], n, rec.get("i"),
                    len(e["tokens"]))
                e["tokens"] = []
                e["rngs"] = []
                e["fallback"] = True
                continue
            e["tokens"].append(int(rec["token"]))
            e["rngs"].append(rec.get("rng"))
        elif op == "end":
            e = entries.get(rec["request"])
            if e is not None:
                e["ended"] = True
                e["end_reason"] = rec.get("reason")
    if corrupt_at is not None:
        # framing is lost mid-file: every record after the break is
        # unattributable, so every unfinished stream keeps its identity
        # (begin) but forfeits its committed tokens — prompt replay
        log.error("serve journal %s: unparseable record at line %d — "
                  "degrading ALL %d unfinished stream(s) to prompt "
                  "replay", path, corrupt_at,
                  sum(1 for e in entries.values() if not e["ended"]))
        for e in entries.values():
            if not e["ended"]:
                e["tokens"] = []
                e["rngs"] = []
                e["fallback"] = True
    return entries
