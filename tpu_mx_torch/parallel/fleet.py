"""Elastic fleet membership, from ``tpu_mx/parallel/fleet.py``: the
preemption → reshard → rejoin loop.

- The fleet has a monotone **generation** (the membership epoch), stored
  in ``<root>/gen.json`` with the member list it admits.  Every
  world-size transition is a generation bump.
- Workers **join** by writing ``<root>/members/<rank>.json`` and renew it
  with **heartbeats**; a member whose heartbeat is older than the lease
  is *lost* (a partitioned process is evicted exactly like a dead one).
- The **controller** (one per fleet: ``python -m
  tpu_mx_torch.tools.launch --supervise``, or a test harness) reconciles:
  lost members are evicted, pending joiners admitted, each change
  advancing the generation.
- Workers poll the generation at **step boundaries**
  (:meth:`Fleet.on_step`) and quiesce by raising
  :class:`MembershipChange` — a
  :class:`~tpu_mx_torch.elastic.WorkerFailure`, so the supervisor's
  classification catches it mid-collective too — then reshard onto the
  new world: ``CompiledTrainStep.load_state_dict`` and the data stream
  re-partitioned from its global cursor (``io.NDArrayIter.set_shard``,
  capsule v2 in :mod:`tpu_mx_torch.resume`).

The store is plain files under one directory, byte-compatible with the
reference's (``tpu_mx-fleet-v1``): either package reads a fleet directory
the other wrote.  A zombie worker still holding an old generation tags
its barriers ``tag@gen`` and is refused loudly
(``elastic.barrier(..., fleet=)``).  The ``torch.distributed`` group of
the ``dist_*`` kvstores is the static launch-time world, as the
reference's ``jax.distributed`` world is: no collective group is
re-formed across a membership change.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

from .. import checkpoint as _ckpt
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..elastic import WorkerFailure

__all__ = ["FLEET_FORMAT", "Fleet", "MembershipChange", "generation_token",
           "live_world_size", "note_reshard", "reshard_live"]

log = logging.getLogger(__name__)

FLEET_FORMAT = "tpu_mx-fleet-v1"

#: env protocol (set by the launcher's --supervise for every worker)
ENV_DIR = "TPUMX_FLEET_DIR"
ENV_MEMBER = "TPUMX_FLEET_MEMBER"
ENV_LEASE = "TPUMX_FLEET_LEASE"


class MembershipChange(WorkerFailure):
    """The fleet's membership epoch moved: quiesce and reshard.

    Raised at a step boundary by :meth:`Fleet.check` (and therefore by
    :meth:`Fleet.on_step` inside a supervised step) when the fleet
    generation no longer matches the one this worker adopted.  It IS a
    :class:`~tpu_mx_torch.elastic.WorkerFailure`, so a membership change that
    first surfaces as a failed collective (barrier timeout because the
    peer died) lands in the same supervisor except-path — which then
    classifies it as ``membership``, not a fault: restore from the last
    verified manifest onto the new mesh without burning the restart
    budget (:mod:`tpu_mx_torch.supervisor`)."""

    def __init__(self, message, generation=0, world_size=0):
        super().__init__(message)
        self.generation = int(generation)
        self.world_size = int(world_size)


# ---------------------------------------------------------------------------
# process-global generation token (kvstore cache invalidation)
# ---------------------------------------------------------------------------
# kvstore.py caches rank/world-size at init (process-group constants in
# a static world).  In an elastic world they are membership facts: every
# generation this process observes bumps the token, and the kvstore
# re-reads its cached world on the next access (a resharded run must
# never aggregate with the stale count).
_note_lock = threading.Lock()
_generation_token = 0
_live_world = None


def generation_token():
    """Monotone count of membership-epoch observations in this process."""
    return _generation_token


def live_world_size():
    """World size of the most recently observed membership epoch, or None
    when no fleet epoch has been observed (static-world processes)."""
    return _live_world


def _note_generation(generation, world_size):
    global _generation_token, _live_world
    with _note_lock:
        _generation_token += 1
        _live_world = int(world_size)
    _telemetry.gauge("fleet.membership_epoch").set(int(generation))


def note_reshard(from_world, to_world, source, generation=0):
    """Record a world-size transition driven through the reshard seam.

    ``source`` is ``"manifest"`` (fault recovery: state reloaded from the
    last verified checkpoint + capsule) or ``"live"`` (planned change: the
    in-memory state was valid, no disk round-trip).  Both the supervisor's
    membership branch and :func:`reshard_live` funnel through here so the
    ``fleet.reshards`` counter and the ``fleet.reshard`` event mean one
    thing."""
    _telemetry.counter("fleet.reshards").inc()
    _tracing.emit("fleet.reshard", generation=int(generation),
                  from_world=int(from_world), to_world=int(to_world),
                  source=str(source))


def reshard_live(old_step, step_factory, *, from_world, to_world, fleet=None):
    """Planned scale-up/down: rebuild the train step at the new world size
    from IN-MEMORY state.  No fault happened, so no manifest round-trip —
    ``state_dict()`` off the old step, a fresh step on the new mesh, and
    ``load_state_dict`` re-places every leaf on it (the reshard seam).
    Returns the new step; records the transition with ``source="live"``."""
    sd = old_step.state_dict()
    new_step = step_factory()
    new_step.load_state_dict(sd)
    note_reshard(from_world, to_world, source="live",
                 generation=0 if fleet is None else fleet.acked_generation)
    return new_step


# ---------------------------------------------------------------------------
# the membership store
# ---------------------------------------------------------------------------
class Fleet:
    """One worker's (or the controller's) handle on the membership store.

    ``member`` is this process's rank slot (None for a pure controller);
    ``controller=True`` additionally grants the reconcile/advance side —
    exactly ONE controller per fleet (the launcher, or the worker that
    doubles as one in single-process tests): ``advance`` is a
    read-modify-write of ``gen.json``, serialized only by that
    convention.

    Worker lifecycle::

        f = Fleet.from_env()          # or Fleet(root, member=rank)
        f.join()
        f.await_admission()           # blocks until an epoch admits us
        rank, world = f.shard()       # position for iterator/mesh setup
        ...
        sup = Supervisor(..., fleet=f)   # on_step() at every boundary
    """

    def __init__(self, root, member=None, controller=False, lease=10.0):
        self.root = os.fspath(root)
        self.member = None if member is None else int(member)
        self.controller = bool(controller)
        self.lease = float(lease)
        self._beat = 0
        self._acked_gen = None      # generation this process adopted
        self._acked_world = None    # member list of that generation
        self._shipper = None        # lazy fleet_obs.ObsShipper (workers)
        os.makedirs(os.path.join(self.root, "members"), exist_ok=True)

    @classmethod
    def from_env(cls, env=None):
        """Build from the ``TPUMX_FLEET_*`` env protocol, or None when no
        fleet directory is advertised (static-world processes)."""
        env = os.environ if env is None else env
        root = env.get(ENV_DIR)
        if not root:
            return None
        member = env.get(ENV_MEMBER)
        return cls(root, member=None if member is None else int(member),
                   lease=float(env.get(ENV_LEASE, "10.0")))

    # -- files ------------------------------------------------------------
    def _epoch_path(self):
        return os.path.join(self.root, "gen.json")

    def _member_path(self, member):
        return os.path.join(self.root, "members", f"{int(member)}.json")

    def _quarantine_path(self, member):
        return os.path.join(self.root, "quarantine", f"{int(member)}.json")

    @staticmethod
    def _read_json(path):
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def read_epoch(self):
        """The current membership record, or None before the first
        :meth:`advance`."""
        ep = self._read_json(self._epoch_path())
        if not isinstance(ep, dict) or ep.get("format") != FLEET_FORMAT:
            return None
        return ep

    # -- views ------------------------------------------------------------
    @property
    def generation(self):
        """The CURRENT membership epoch on disk (0 before the first)."""
        ep = self.read_epoch()
        return 0 if ep is None else int(ep.get("generation", 0))

    @property
    def acked_generation(self):
        """The membership epoch this process has ADOPTED (0 if none)."""
        return 0 if self._acked_gen is None else self._acked_gen

    @property
    def acked_world_size(self):
        return 0 if not self._acked_world else len(self._acked_world)

    def world(self):
        """Member list of the current on-disk epoch."""
        ep = self.read_epoch()
        return [] if ep is None else [int(m) for m in ep.get("world", [])]

    def members(self):
        """All member records on disk: {rank: record} (stale ones too)."""
        out = {}
        mdir = os.path.join(self.root, "members")
        try:
            names = os.listdir(mdir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue  # *.tmp.* debris from a beat that died mid-write
            rec = self._read_json(os.path.join(mdir, name))
            if isinstance(rec, dict) and "member" in rec:
                out[int(rec["member"])] = rec
        return out

    def _fresh(self, rec, now):
        return rec is not None and (now - float(rec.get("wall_time", 0.0))
                                    <= self.lease)

    def live(self):
        """Members with a fresh heartbeat (within the lease)."""
        now = time.time()
        return sorted(m for m, rec in self.members().items()
                      if self._fresh(rec, now))

    def lost(self):
        """In-world members whose heartbeat lease has expired.

        A member with NO record at all is *pending*, not lost: admission
        at launch is optimistic (the controller opens the epoch before
        the workers finish booting), so liveness judgment starts at the
        first join.  A worker that dies before ever joining is the
        launcher's exit-code path to catch, not the lease's."""
        now = time.time()
        recs = self.members()
        return sorted(m for m in self.world()
                      if recs.get(m) is not None
                      and not self._fresh(recs[m], now))

    def joiners(self):
        """Live members NOT in the current world (pending admission)."""
        in_world = set(self.world())
        return [m for m in self.live() if m not in in_world]

    # -- worker side ------------------------------------------------------
    def _write_member(self, fsync=False):
        self._beat += 1
        body = {"member": self.member, "pid": os.getpid(),
                "beat": self._beat, "generation": self.acked_generation,
                "wall_time": time.time()}
        with _ckpt.atomic_write(self._member_path(self.member), mode="w",
                                fsync=fsync) as f:
            f.write(json.dumps(body))

    def join(self):
        """Announce this member.  If the current epoch already admits it
        (the initial cohort), adopt that epoch immediately; otherwise the
        member is pending until the controller advances
        (:meth:`await_admission`).  Returns the current generation."""
        if self.member is None:
            raise ValueError("Fleet.join: this handle has no member slot")
        self._write_member(fsync=True)
        ep = self.read_epoch()
        _tracing.emit("fleet.join", member=self.member,
                      generation=0 if ep is None else int(ep["generation"]))
        if ep is not None and self.member in [int(m) for m in ep["world"]]:
            self._adopt(ep)
        return self.generation

    def await_admission(self, timeout=60.0, poll=0.05):
        """Block until a membership epoch admits this member (late joiners
        are admitted only at the NEXT epoch — that is the protocol), then
        adopt it and return the epoch record."""
        deadline = time.monotonic() + float(timeout)
        while True:
            ep = self.read_epoch()
            if ep is not None and self.member in [int(m)
                                                  for m in ep["world"]]:
                self._adopt(ep)
                return ep
            if time.monotonic() >= deadline:
                raise WorkerFailure(
                    f"fleet member {self.member}: no membership epoch "
                    f"admitted this worker within {timeout:.0f}s "
                    f"(current generation {self.generation})")
            self.heartbeat()
            time.sleep(poll)

    def heartbeat(self):
        """Renew this member's lease — unless the ``partition_worker``
        chaos fault says this member is network-partitioned, in which case
        the beat is silently dropped (its *absence* is the fault)."""
        if self.member is None:
            return
        from ..contrib import chaos
        if chaos.partitioned(self.member):
            return
        self._write_member(fsync=False)
        _telemetry.counter("fleet.heartbeats").inc()

    def leave(self, reason="completed"):
        """Clean departure: withdraw the member record.  Does NOT advance
        the generation — eviction/admission epochs are the controller's
        call; a clean leaver simply stops renewing its lease."""
        _tracing.emit("fleet.leave", member=self.member,
                      generation=self.generation, reason=str(reason))
        self._ship_obs(force=True)   # final snapshot before departure
        try:
            os.remove(self._member_path(self.member))
        except OSError:
            pass

    def _adopt(self, ep):
        self._acked_gen = int(ep["generation"])
        self._acked_world = [int(m) for m in ep["world"]]
        _note_generation(self._acked_gen, len(self._acked_world))
        # stamp the fleet identity onto every telemetry record and trace
        # event this process emits from here on: the cross-rank merge
        # (fleet_obs) keys stale-generation exclusion and step
        # correlation on these two fields
        _telemetry.set_fleet_identity(rank=self.member,
                                      generation=self._acked_gen)
        _tracing.set_context(rank=self.member,
                             fleet_generation=self._acked_gen)

    def ack(self):
        """Adopt the current on-disk epoch (after the reshard that a
        :class:`MembershipChange` demanded).  Returns the epoch record."""
        ep = self.read_epoch()
        if ep is None:
            raise WorkerFailure(
                f"fleet at {self.root}: no membership epoch to ack")
        self._adopt(ep)
        return ep

    def check(self):
        """Raise :class:`MembershipChange` if the membership epoch moved
        past the one this process adopted (the step-boundary quiesce)."""
        gen = self.generation
        if gen != self.acked_generation:
            ep = self.read_epoch() or {}
            world = len(ep.get("world", ()))
            raise MembershipChange(
                f"fleet membership epoch moved: generation "
                f"{self.acked_generation} -> {gen} (world size {world}, "
                f"reason {ep.get('reason', '?')!r}) — quiesce and reshard",
                generation=gen, world_size=world)

    def poll_changed(self):
        """True when the epoch moved (controller handles also reconcile
        first, so a WorkerFailure raised by a dying peer's collective is
        recognized as a membership event the moment the lease expires)."""
        if self.controller:
            self.reconcile()
        return self.generation != self.acked_generation

    def on_step(self):
        """The per-step fleet duty cycle, called by the supervisor at
        every step boundary: fire a pending chaos preemption, renew the
        lease, reconcile (controller only), and quiesce if the epoch
        moved."""
        if self.member is not None:
            from ..contrib import chaos
            chaos.maybe_preempt(self.member)
            self.heartbeat()
            self._ship_obs()
        if self.controller:
            self.reconcile()
        self.check()

    def _ship_obs(self, force=False):
        """Export this worker's observability snapshot into the fleet
        store (rate-limited inside the shipper).  Best-effort: a full
        disk or torn store must never fail a train step."""
        if self.member is None:
            return
        if self._shipper is None:
            try:
                from . import fleet_obs
            except ImportError:
                return
            self._shipper = fleet_obs.ObsShipper(self)
        try:
            self._shipper.ship(force=force)
        except OSError:
            pass

    def shard(self):
        """``(rank, num_workers)`` of this member in its ADOPTED epoch —
        the re-partition coordinates for ``NDArrayIter.set_shard`` and
        the mesh rebuild."""
        if not self._acked_world or self.member not in self._acked_world:
            raise WorkerFailure(
                f"fleet member {self.member} is not in the adopted "
                f"membership epoch {self.acked_generation} "
                f"(world {self._acked_world}) — join/await_admission first")
        return self._acked_world.index(self.member), len(self._acked_world)

    def barrier_tag(self, tag):
        """Generation-tagged rendezvous name (``tag@gen``): a zombie from
        a previous epoch can never pair with the current cohort.  Prefer
        passing ``fleet=`` to :func:`tpu_mx_torch.elastic.barrier`, which also
        raises loudly on a stale generation instead of waiting out the
        timeout."""
        return f"{tag}@{self.acked_generation}"

    # -- controller side --------------------------------------------------
    def advance(self, world=None, reason="advance"):
        """Open the next membership epoch admitting exactly ``world``
        (default: every member with a live lease).  The ONE write that
        changes membership — monotone generation, atomic commit."""
        prev = self.read_epoch()
        gen = (0 if prev is None else int(prev["generation"])) + 1
        if world is None:
            world = self.live()
        world = sorted({int(m) for m in world})
        body = {"format": FLEET_FORMAT, "generation": gen, "world": world,
                "world_size": len(world), "reason": str(reason),
                "wall_time": time.time()}
        with _ckpt.atomic_write(self._epoch_path(), mode="w") as f:
            f.write(json.dumps(body))
        _tracing.emit("fleet.epoch", generation=gen, world_size=len(world),
                      reason=str(reason))
        log.warning("fleet: membership epoch %d opened (world %s, %s)",
                    gen, world, reason)
        if self.member is None:
            # pure controller: observe the epoch it just opened (members
            # adopt via ack()/await_admission after their reshard)
            _note_generation(gen, len(world))
            self._acked_gen, self._acked_world = gen, world
        return body

    def reconcile(self, reason=None):
        """Evict lease-expired members, admit pending joiners; advance the
        generation if (and only if) membership changed.  Returns the new
        epoch record, or None when the world is unchanged."""
        lost, joiners = self.lost(), self.joiners()
        q = self.quarantined()
        if q:
            # quarantine is permanent: a quarantined rank still beating
            # (healed partition, zombie process) must neither stay in
            # the world nor rejoin it — distinct from lease eviction,
            # which a healed member survives
            barred = [m for m in joiners if m in q]
            if barred:
                log.warning("fleet: refusing re-admission of quarantined "
                            "member(s) %s", barred)
            joiners = [m for m in joiners if m not in q]
            lost = sorted(set(lost) | (set(self.world()) & set(q)))
        if not lost and not joiners:
            return None
        now = time.time()
        recs = self.members()
        for m in lost:
            rec = recs.get(m)
            age = now - float(rec.get("wall_time", 0.0)) if rec else self.lease
            _tracing.emit("fleet.lost", member=m, age_seconds=float(age))
            _telemetry.counter("fleet.lost_workers").inc()
            log.warning("fleet: member %d lost (lease expired %.2fs ago)",
                        m, age - self.lease)
        new_world = sorted((set(self.world()) - set(lost)) | set(joiners))
        if reason is None:
            reason = "lost" if lost and not joiners else (
                "rejoin" if joiners and not lost else "churn")
        ep = self.advance(world=new_world, reason=reason)
        for m in joiners:
            _tracing.emit("fleet.rejoin", member=m,
                          generation=int(ep["generation"]))
            _telemetry.counter("fleet.rejoins").inc()
        return ep

    def evict(self, member, reason="preempted"):
        """Launcher fast path: it SAW the worker die (exit code), no need
        to wait out the lease.  Advances the generation without it."""
        _tracing.emit("fleet.leave", member=int(member),
                      generation=self.generation, reason=str(reason))
        _telemetry.counter("fleet.lost_workers").inc()
        world = [m for m in self.world() if m != int(member)]
        # Drop the corpse's member record too: its last heartbeat may
        # still be inside the lease, and a fresh-looking record would
        # make the next reconcile() re-admit a worker the controller
        # KNOWS is dead.  (Lease-path eviction keeps the record — a
        # partitioned worker that heals resumes beating and rejoins.)
        try:
            os.remove(self._member_path(int(member)))
        except OSError:
            pass
        return self.advance(world=world, reason=reason)

    # -- quarantine (the corruption defense) ------------------------------
    def quarantine(self, member, reason="corruption", step=0):
        """Permanently bar ``member`` from the fleet: a corruption
        verdict (parallel/integrity.py) named this rank's hardware, and
        — unlike a lease eviction, where a healed partition resumes
        beating and rejoins — a flaky chip must NEVER be re-admitted.
        The record under ``<root>/quarantine/`` is the durable verdict:
        :meth:`reconcile`, :meth:`admit` and the launcher's restart path
        all refuse quarantined ranks against it.  Any member may write
        it (the corrupt worker self-reports before dying; the controller
        writes it when it holds the vote) — writing is idempotent."""
        body = {"member": int(member), "reason": str(reason)[:500],
                "step": int(step), "generation": self.generation,
                "wall_time": time.time()}
        os.makedirs(os.path.join(self.root, "quarantine"), exist_ok=True)
        with _ckpt.atomic_write(self._quarantine_path(member),
                                mode="w") as f:
            f.write(json.dumps(body))
        # drop the member record too: its last heartbeat may still be
        # fresh, and a fresh-looking lease would keep the rank "live"
        try:
            os.remove(self._member_path(int(member)))
        except OSError:
            pass
        _telemetry.counter("integrity.quarantined").inc()
        _tracing.emit("integrity.quarantine", rank=int(member),
                      reason=str(reason)[:300], step=int(step))
        log.error("fleet: member %d QUARANTINED (%s) — permanent, never "
                  "re-admitted", int(member), reason)
        if self.controller and int(member) in self.world():
            self.advance(world=[m for m in self.world()
                                if m != int(member)],
                         reason="quarantine")
        return body

    def quarantined(self):
        """All quarantine verdicts on disk: {rank: record}."""
        out = {}
        qdir = os.path.join(self.root, "quarantine")
        try:
            names = os.listdir(qdir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            rec = self._read_json(os.path.join(qdir, name))
            if isinstance(rec, dict) and "member" in rec:
                out[int(rec["member"])] = rec
        return out

    def is_quarantined(self, member):
        return self._read_json(self._quarantine_path(member)) is not None

    def admit(self, member, reason="rejoin"):
        """Launcher fast path: admit a (re)started worker at the next
        membership epoch.  Quarantined ranks are REFUSED — corruption
        verdicts are permanent (:meth:`quarantine`)."""
        if self.is_quarantined(member):
            raise WorkerFailure(
                f"fleet member {int(member)} is quarantined (data "
                f"corruption verdict) — re-admission refused; the "
                f"quarantine record under {self.root}/quarantine is "
                f"permanent")
        world = sorted(set(self.world()) | {int(member)})
        ep = self.advance(world=world, reason=reason)
        _tracing.emit("fleet.rejoin", member=int(member),
                      generation=int(ep["generation"]))
        _telemetry.counter("fleet.rejoins").inc()
        return ep

    def wait_member(self, member, timeout=30.0, poll=0.05):
        """Block until ``member`` has a live heartbeat (a restarted worker
        has come up and joined).  Returns True on success."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            if int(member) in self.live():
                return True
            time.sleep(poll)
        return False

    def __repr__(self):
        return (f"Fleet(root={self.root!r}, member={self.member}, "
                f"generation={self.generation}, "
                f"acked={self.acked_generation}, world={self.world()})")
