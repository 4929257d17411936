"""Capacity accounting: who holds every byte of the KV block pool.

The port of ``tpu_mx/serving/accounting.py``.  A physical block can back
several tenants' sequences, the shared-prefix index and a pinned
mid-prefill plan at once; this module is the ledger that says who:

- :class:`CapacityLedger` rides the refcounted
  :class:`~tpu_mx_torch.serving.kv_cache.BlockAllocator`: every
  reference the allocator hands out is attributed to a named **holder**
  — a sequence (``seq:<id>``), the shared-prefix index
  (:data:`INDEX_HOLDER`) or a pinned prefill plan (``plan:<n>``) — each
  with a ``kind``, a ``tenant`` and a ``pinned`` flag.  Ledger mutations
  happen inside the allocator's lock, next to the refcount they mirror,
  so ``sum of holder refs == allocator refcount`` holds at every
  instant.
- **The accounting identity**: shared bytes are attributed *amortized*
  (each holder charged ``block_bytes x its refs / refcount`` per block,
  in :class:`fractions.Fraction`, so per-tenant bytes sum exactly to
  pool-used bytes) and *exclusive-if-forked* (the full block per
  distinct block a tenant references).  ``audit()`` checks both
  identities and raises on any violation.
- **Exhaustion forensics**: the cache records a snapshot of every live
  holder on each genuine ``CacheExhausted`` and each prefix-index
  pressure eviction, and with a path prefix armed persists the rolling
  record set as ``<prefix>-capacity.json`` through
  ``checkpoint.atomic_write``, in the reference's format
  (:data:`FORENSIC_FORMAT`): the two packages' validators accept each
  other's documents.

The ledger has no lock of its own: the allocator calls it under its lock.
"""
from __future__ import annotations

import json
import time
from fractions import Fraction

try:
    from ..base import MXNetError as LedgerError
except ImportError:  # loaded standalone from its file (tools/capacity_report)
    class LedgerError(Exception):
        """A capacity-ledger violation (``MXNetError`` in the package)."""

__all__ = ["CapacityLedger", "LedgerError", "FORENSIC_FORMAT",
           "INDEX_HOLDER", "INDEX_TENANT", "UNATTRIBUTED",
           "FORENSIC_KINDS", "dump_forensics", "validate_forensic_record",
           "validate_forensic_doc"]

FORENSIC_FORMAT = "tpu_mx-capacity-forensic-v1"

# the shared-prefix index's holder id and pseudo-tenant: index-resident
# bytes belong to the fleet, not to the tenant that happened to prefill
# them first — they are attributed under their own name so the identity
# stays exact without inventing a per-tenant split the index cannot know
INDEX_HOLDER = "prefix-index"
INDEX_TENANT = "_index"

# references taken through the bare allocator API (tests, tools) with no
# holder named — still ledgered, still part of the identity
UNATTRIBUTED = "_anon"

FORENSIC_KINDS = ("exhaustion", "pressure_evict")

# relative tolerance for re-checking the float-rendered amortized-bytes
# identity in a persisted forensic record (the LIVE identity is exact
# Fraction math; the JSON rendering rounds each tenant to a float once)
FORENSIC_BYTES_RTOL = 1e-6


class CapacityLedger:
    """Holder-attribution ledger for one block allocator (module
    docstring).  ``block_bytes`` is the physical size of one pool block
    across every layer and both K/V pools — the unit every byte figure
    in the ledger is denominated in."""

    __slots__ = ("block_bytes", "_refs", "_meta", "high_watermark")

    def __init__(self, block_bytes=1):
        self.block_bytes = int(block_bytes)
        self._refs = {}   # holder -> {block_id: refs held}
        self._meta = {}   # holder -> {kind, tenant, pinned, created}
        self.high_watermark = 0   # peak distinct blocks ever held

    # -- mutation (called under the allocator's lock) ------------------------
    def _entry(self, holder):
        refs = self._refs.get(holder)
        if refs is None:
            refs = self._refs[holder] = {}
            self._meta.setdefault(holder, {
                "kind": "holder", "tenant": UNATTRIBUTED,
                "pinned": False, "created": time.monotonic()})
        return refs

    def describe(self, holder, kind=None, tenant=None, pinned=None):
        """Attach/refresh a holder's attribution metadata (kind /
        tenant / pinned).  Safe before or after its first reference."""
        holder = str(holder)
        self._entry(holder)
        meta = self._meta[holder]
        if kind is not None:
            meta["kind"] = str(kind)
        if tenant is not None:
            meta["tenant"] = str(tenant)
        if pinned is not None:
            meta["pinned"] = bool(pinned)

    def hold(self, block_ids, holder=None):
        """One more reference per block, attributed to ``holder``."""
        refs = self._entry(UNATTRIBUTED if holder is None else str(holder))
        for bid in block_ids:
            refs[bid] = refs.get(bid, 0) + 1

    def release(self, block_ids, holder=None):
        """Drop one attributed reference per block.  Releasing a
        reference the named holder does not hold is as loud as a
        double-free: a silent mismatch here would quietly break the
        refcount == sum-of-holder-refs identity the audit gates on."""
        holder = UNATTRIBUTED if holder is None else str(holder)
        refs = self._refs.get(holder, {})
        for bid in block_ids:
            if refs.get(bid, 0) < 1:
                raise LedgerError(
                    f"CapacityLedger: holder {holder!r} does not hold a "
                    f"reference to block {bid} — attribution and "
                    "refcounts would diverge")
        for bid in block_ids:
            refs[bid] -= 1
            if refs[bid] == 0:
                del refs[bid]
        if not refs:
            self._refs.pop(holder, None)
            self._meta.pop(holder, None)

    def transfer(self, block_ids, src, dst):
        """Move one reference per block from ``src`` to ``dst`` without
        touching the refcount — the commit-prefill ownership handoff
        (a plan's pins become the registered sequence's references)."""
        self.release(block_ids, src)
        self.hold(block_ids, dst)

    def note_used(self, used_blocks):
        """Advance the high watermark (called after every allocation)."""
        if used_blocks > self.high_watermark:
            self.high_watermark = used_blocks

    # -- reads (called under the allocator's lock) ---------------------------
    def _block_totals(self):
        totals = {}
        for refs in self._refs.values():
            for bid, n in refs.items():
                totals[bid] = totals.get(bid, 0) + n
        return totals

    def views(self):
        """``(holders, tenants)`` computed off ONE block-totals pass —
        what the per-step gauge publication reads (the separate
        :meth:`holders`/:meth:`tenants` accessors recompute totals and
        are fine for audits and forensics, which are rare)."""
        totals = self._block_totals()
        return self._holder_rows(totals), self._tenant_rows(totals)

    def holders(self):
        """Every live holder's attribution row: ``{kind, id, tenant,
        blocks, exclusive_blocks, shared_blocks, pinned, age_seconds}``
        (shared = the block's TOTAL refcount exceeds this holder's own
        references — someone else also reads it)."""
        return self._holder_rows(self._block_totals())

    def _holder_rows(self, totals):
        now = time.monotonic()
        out = []
        for holder, refs in self._refs.items():
            meta = self._meta[holder]
            excl = sum(1 for bid, n in refs.items() if totals[bid] == n)
            out.append({
                "kind": meta["kind"],
                "id": holder,
                "tenant": meta["tenant"],
                "blocks": sum(refs.values()),
                "exclusive_blocks": excl,
                "shared_blocks": len(refs) - excl,
                "pinned": meta["pinned"],
                "age_seconds": max(now - meta["created"], 0.0),
            })
        out.sort(key=lambda h: (-h["blocks"], h["id"]))
        return out

    def tenants(self):
        """Per-tenant attribution with EXACT amortized math:
        ``{tenant: {bytes_amortized, bytes_exclusive, blocks, refs,
        holders}}`` where ``bytes_amortized`` sums over blocks
        ``block_bytes × holder_refs / block_refcount`` (a
        :class:`fractions.Fraction` internally — the identity
        ``sum over tenants == used_blocks × block_bytes`` is exact, not
        within-epsilon) and ``bytes_exclusive`` charges the full block
        for every distinct block the tenant references (the
        exclusive-if-forked cost)."""
        return self._tenant_rows(self._block_totals())

    def _tenant_rows(self, totals):
        per = {}
        for holder, refs in self._refs.items():
            tenant = self._meta[holder]["tenant"]
            d = per.setdefault(tenant, {"_amortized": Fraction(0),
                                        "_blocks": set(), "refs": 0,
                                        "holders": 0})
            d["holders"] += 1
            for bid, n in refs.items():
                d["_amortized"] += Fraction(n, totals[bid])
                d["_blocks"].add(bid)
                d["refs"] += n
        out = {}
        for tenant, d in per.items():
            out[tenant] = {
                "bytes_amortized": float(d["_amortized"]
                                         * self.block_bytes),
                "bytes_exclusive": len(d["_blocks"]) * self.block_bytes,
                "blocks": len(d["_blocks"]),
                "refs": d["refs"],
                "holders": d["holders"],
            }
        return out

    def _tenant_amortized_exact(self):
        """{tenant: Fraction(amortized blocks)} — the audit's exact arm."""
        totals = self._block_totals()
        per = {}
        for holder, refs in self._refs.items():
            tenant = self._meta[holder]["tenant"]
            acc = per.setdefault(tenant, Fraction(0))
            for bid, n in refs.items():
                acc += Fraction(n, totals[bid])
            per[tenant] = acc
        return per

    def audit(self, refcounts):
        """Verify the accounting identity against the allocator's own
        refcounts (``{block_id: refcount}``) and return the audit
        report.  Raises :class:`LedgerError` naming every violation:

        1. per block: sum of attributed holder refs == the refcount;
        2. per tenant: amortized byte shares sum EXACTLY (Fraction
           arithmetic) to ``used_blocks × block_bytes``.
        """
        totals = self._block_totals()
        problems = []
        for bid, rc in refcounts.items():
            got = totals.get(bid, 0)
            if got != rc:
                problems.append(f"block {bid}: ledger attributes {got} "
                                f"ref(s) but the allocator counts {rc}")
        for bid, got in totals.items():
            if bid not in refcounts:
                problems.append(f"block {bid}: ledger attributes {got} "
                                "ref(s) to a block the allocator does "
                                "not hold")
        exact = self._tenant_amortized_exact()
        total_amortized = sum(exact.values(), Fraction(0))
        used = len(totals)
        if total_amortized != used:
            problems.append(
                f"amortized attribution sums to {float(total_amortized)} "
                f"blocks but {used} are held — per-tenant bytes would "
                "not sum to pool-used bytes")
        if problems:
            raise LedgerError("capacity accounting identity violated:\n  "
                              + "\n  ".join(problems))
        return {
            "used_blocks": used,
            "used_bytes": used * self.block_bytes,
            "total_refs": sum(totals.values()),
            "high_watermark_blocks": self.high_watermark,
            "block_bytes": self.block_bytes,
            "holders": self.holders(),
            "tenants": self.tenants(),
        }


# ---------------------------------------------------------------------------
# the forensic record (built by PagedKVCache, validated here + offline)
# ---------------------------------------------------------------------------
def dump_forensics(path, records):
    """Persist the rolling forensic record set as strict JSON through
    ``checkpoint.atomic_write`` (a crash mid-dump leaves the previous
    complete file, never a torn one) and return the path."""
    from ..checkpoint import atomic_write
    doc = {"format": FORENSIC_FORMAT, "wall_time": time.time(),
           "records": list(records)}
    payload = json.dumps(doc, sort_keys=True, allow_nan=False)
    with atomic_write(path, "w") as f:
        f.write(payload)
    return path


def _num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_forensic_record(rec):
    """Raise ValueError unless ``rec`` is a schema-valid capacity
    forensic record: a known ``kind``, numeric ``ts``/``need``/``free``/
    ``released``, a complete ``pool`` object, a ``holders`` list naming
    every live holder (their refs must sum to ``total_refs`` — the
    "100% of holders" gate), and a ``tenants`` attribution whose
    amortized bytes sum to pool-used bytes within float-rendering
    tolerance (the live identity is exact; the JSON rounds once)."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is {type(rec).__name__}, not an object")
    kind = rec.get("kind")
    if kind not in FORENSIC_KINDS:
        raise ValueError(f"unknown forensic kind {kind!r} "
                         f"(want one of {FORENSIC_KINDS})")
    for field in ("ts", "need", "free", "released"):
        if not _num(rec.get(field)):
            raise ValueError(f"{kind}: missing numeric {field!r}")
    pool = rec.get("pool")
    if not isinstance(pool, dict):
        raise ValueError(f"{kind}: missing 'pool' object")
    for field in ("num_blocks", "block_bytes", "used_blocks",
                  "total_refs", "high_watermark_blocks", "fragmentation"):
        if not _num(pool.get(field)):
            raise ValueError(f"{kind}: pool missing numeric {field!r}")
    if not 0.0 <= pool["fragmentation"] <= 1.0:
        raise ValueError(f"{kind}: fragmentation "
                         f"{pool['fragmentation']} outside [0, 1]")
    holders = rec.get("holders")
    if not isinstance(holders, list):
        raise ValueError(f"{kind}: missing 'holders' list")
    refs = 0
    for i, h in enumerate(holders):
        if not isinstance(h, dict):
            raise ValueError(f"{kind}: holders[{i}] is not an object")
        for field in ("kind", "id", "tenant"):
            if not isinstance(h.get(field), str) or not h.get(field):
                raise ValueError(f"{kind}: holders[{i}] missing str "
                                 f"{field!r}")
        for field in ("blocks", "exclusive_blocks", "shared_blocks",
                      "age_seconds"):
            if not _num(h.get(field)) or h[field] < 0:
                raise ValueError(f"{kind}: holders[{i}] missing "
                                 f"non-negative {field!r}")
        if not isinstance(h.get("pinned"), bool):
            raise ValueError(f"{kind}: holders[{i}] missing bool 'pinned'")
        refs += h["blocks"]
    if refs != pool["total_refs"]:
        raise ValueError(
            f"{kind}: holders name {refs} block reference(s) but the "
            f"pool counts {pool['total_refs']} — the record does not "
            "name 100% of live holders")
    tenants = rec.get("tenants")
    if not isinstance(tenants, dict):
        raise ValueError(f"{kind}: missing 'tenants' attribution object")
    amortized = 0.0
    for tenant, d in tenants.items():
        if not isinstance(d, dict):
            raise ValueError(f"{kind}: tenants[{tenant!r}] is not an "
                             "object")
        for field in ("bytes_amortized", "bytes_exclusive", "blocks",
                      "refs", "holders"):
            if not _num(d.get(field)) or d[field] < 0:
                raise ValueError(f"{kind}: tenants[{tenant!r}] missing "
                                 f"non-negative {field!r}")
        amortized += d["bytes_amortized"]
    used_bytes = pool["used_blocks"] * pool["block_bytes"]
    if abs(amortized - used_bytes) > max(
            FORENSIC_BYTES_RTOL * used_bytes, 1e-6):
        raise ValueError(
            f"{kind}: per-tenant amortized bytes sum to {amortized} but "
            f"the pool holds {used_bytes} — the accounting identity is "
            "broken in this record")
    return rec


def validate_forensic_doc(doc):
    """Raise ValueError unless ``doc`` is a schema-valid forensic dump:
    the known format tag, numeric ``wall_time``, and a ``records`` list
    whose every entry passes :func:`validate_forensic_record`."""
    if not isinstance(doc, dict):
        raise ValueError(f"forensic doc is {type(doc).__name__}, "
                         "not an object")
    if doc.get("format") != FORENSIC_FORMAT:
        raise ValueError(f"unknown forensic format {doc.get('format')!r} "
                         f"(this build reads {FORENSIC_FORMAT})")
    if not _num(doc.get("wall_time")):
        raise ValueError("forensic doc missing numeric 'wall_time'")
    records = doc.get("records")
    if not isinstance(records, list):
        raise ValueError("forensic doc missing the 'records' list")
    for i, rec in enumerate(records):
        try:
            validate_forensic_record(rec)
        except ValueError as e:
            raise ValueError(f"records[{i}]: {e}") from e
    return doc
