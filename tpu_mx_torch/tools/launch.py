"""Distributed job launcher of the port, from the reference's
``tools/launch.py`` (its local and ssh trackers).

Every worker runs the same program; ``import tpu_mx_torch`` joins them
into one ``torch.distributed`` group (``gloo``) from the env protocol
below, so the launcher's job is to start N identical processes with the
right bootstrap environment.

    # local: N processes on this machine
    python -m tpu_mx_torch.tools.launch -n 2 python train.py --kv-store dist_sync

    # ssh: one process per host listed in the hostfile (round-robin when
    # n > number of hosts), the env protocol inlined into the ssh command
    python -m tpu_mx_torch.tools.launch -n 4 --launcher ssh -H hosts.txt \
        python train.py --kv-store dist_sync

Env protocol handed to each worker:
    TPUMX_COORDINATOR   host:port of rank 0 (the group's TCP store)
    TPUMX_NUM_PROC      world size
    TPUMX_PROC_ID       this process's rank

Elastic fleets (``--supervise``): the launcher is the fleet's
controller.  It opens membership epoch 1 admitting ranks 0..N-1, hands
every worker the ``TPUMX_FLEET_{DIR,MEMBER,LEASE}`` protocol
(:mod:`tpu_mx_torch.parallel.fleet`), and then supervises:

- a worker that exits nonzero (preempted, crashed) is evicted at a fresh
  membership epoch at once — the survivors quiesce at their next step
  boundary and reshard down — and restarted with jittered exponential
  backoff while its restart budget (``--max-restarts``) lasts; the
  restarted process joins and is admitted at the next epoch;
- a worker whose heartbeats stop while the process lives (a partition,
  ``partition_worker`` chaos) is evicted by lease expiry
  (``Fleet.reconcile``);
- a worker whose budget is spent degrades the fleet to the largest
  healthy world (``fleet.degrade`` and the fleet black box); below
  ``--min-workers`` the job is torn down.

    python -m tpu_mx_torch.tools.launch --supervise -n 2 --max-restarts 3 \
        python train.py --kv-store dist_sync

The launcher imports the port's fleet modules (and so torch) but never
touches the card: it creates no CUDA context, and exits 1 if one was
created in its process.  Workers may share one card.
"""
import argparse
import os
import random
import shlex
import socket
import subprocess
import sys
import tempfile
import time


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(coord, num_proc, rank, extra=()):
    """The bootstrap env protocol for one worker (shared by both trackers)."""
    env = {
        "TPUMX_COORDINATOR": coord,
        "TPUMX_NUM_PROC": str(num_proc),
        "TPUMX_PROC_ID": str(rank),
    }
    for kv in extra:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def read_hostfile(path):
    """One host per line; '#' comments and blanks ignored (the dmlc ssh
    tracker's hostfile format)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line)
    if not hosts:
        raise ValueError(f"hostfile {path} has no hosts")
    return hosts


def build_ssh_commands(hosts, num_proc, coord, command, env_extra=(),
                       ssh_opts=()):
    """Construct the per-rank ssh argv list (pure — unit-testable without a
    cluster).  Rank r runs on hosts[r % len(hosts)]; the env protocol is
    inlined into the remote command since ssh does not forward arbitrary
    env vars."""
    cmds = []
    for rank in range(num_proc):
        host = hosts[rank % len(hosts)]
        env = worker_env(coord, num_proc, rank, env_extra)
        assigns = " ".join(f"{k}={shlex.quote(v)}"
                           for k, v in sorted(env.items()))
        remote = f"cd {shlex.quote(os.getcwd())} && env {assigns} " + \
            " ".join(shlex.quote(c) for c in command)
        cmds.append((host, ["ssh", "-o", "StrictHostKeyChecking=no",
                            *ssh_opts, host, remote]))
    return cmds


def launch_local(args, coord):
    procs = []
    for rank in range(args.num_workers):
        env = dict(os.environ)
        env.update(worker_env(coord, args.num_workers, rank, args.env))
        procs.append(subprocess.Popen(args.command, env=env))
    return procs


def _import_fleet():
    """The fleet runtime, in the launcher's process (no card is
    touched)."""
    from ..parallel import fleet as fleet_mod
    from ..parallel import fleet_obs as fleet_obs_mod
    from .. import telemetry, tracing
    return fleet_mod, fleet_obs_mod, telemetry, tracing


def cuda_context_created():
    """Whether this process created a CUDA context (it must not)."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def restart_backoff(base, attempt, rng=None):
    """Jittered exponential backoff for worker restart `attempt` (1-based):
    base * 2^(attempt-1), scaled by a uniform [0.5, 1.5) jitter so a batch
    of preempted workers doesn't stampede the coordinator (pure —
    unit-testable)."""
    rng = random if rng is None else rng
    return float(base) * (2 ** (max(1, int(attempt)) - 1)) * \
        (0.5 + rng.random())


def supervise(args, coord):
    """Fleet-supervising local tracker: spawn N workers under the
    membership-epoch protocol, evict/restart/admit on churn, degrade when
    a worker's restart budget runs out.  Returns the process exit code."""
    fleet_mod, fleet_obs, _telemetry, _tracing = _import_fleet()
    fleet_dir = args.fleet_dir or tempfile.mkdtemp(prefix="tpumx_fleet_")
    fleet = fleet_mod.Fleet(fleet_dir, member=None, controller=True,
                            lease=args.lease)
    fleet.advance(world=range(args.num_workers), reason="launch")
    # the controller-side observability plane: merges the workers'
    # shipped snapshots into fleet.* rollups and watches for persistent
    # stragglers (parallel/fleet_obs.py)
    agg = fleet_obs.FleetAggregator(fleet,
                                    interval=max(0.5, args.lease / 4.0))

    def spawn(rank, *, fresh=False):
        env = dict(os.environ)
        env.update(worker_env(coord, args.num_workers, rank, args.env))
        env[fleet_mod.ENV_DIR] = fleet_dir
        env[fleet_mod.ENV_MEMBER] = str(rank)
        env[fleet_mod.ENV_LEASE] = str(args.lease)
        if fresh and not args.keep_chaos:
            # a chaos knob describes a fault to inject once per JOB, not
            # once per incarnation: a restarted worker that re-read
            # preempt_worker_at_step would preempt itself forever
            env.pop("TPUMX_CHAOS", None)
        return subprocess.Popen(args.command, env=env)

    procs = {rank: spawn(rank) for rank in range(args.num_workers)}
    restarts = {rank: 0 for rank in procs}
    pending = {}       # rank -> monotonic time its backoff expires
    exit_codes = {}
    poll = max(0.05, args.lease / 4.0)

    def straggler_note():
        """One-line straggler context for evict/degrade decisions (empty
        when the detector is quiet)."""
        sig = (agg.last or {}).get("signal") or agg.detector.signal
        if not sig.get("straggling"):
            return ""
        return (f" [straggler: rank {sig['rank']} "
                f"+{sig['excess_seconds']:.3f}s/step in "
                f"{sig['dominant_phase'] or '?'} over {sig['steps']} steps]")

    def dump_fleet_box(why):
        """Collect every live worker's shipped events + telemetry into
        the cross-rank black box (best-effort: forensics must never take
        the controller down)."""
        try:
            return fleet_obs.dump_fleet_blackbox(fleet_dir, reason=why,
                                                 aggregator=agg)
        except OSError:
            return None

    def degrade(rank, why):
        world = fleet.world()
        why += straggler_note()
        _tracing.emit("fleet.degrade", world_size=len(world), reason=why)
        # the fleet black box (<fleet_dir>/fleet-blackbox.json): the
        # base document, with the cross-rank section on top
        dump_fleet_box(f"fleet degrade: {why} — continuing at world size "
                       f"{len(world)} {world}")
        print(f"launch: {why}; degrading to world size {len(world)}",
              file=sys.stderr)

    def on_failure(rank, rc):
        if rank in fleet.world():
            # snapshot the fleet BEFORE the eviction epoch: the dying
            # rank's last shipped state is still generation-current here
            # and would be excluded as stale one epoch later
            dump_fleet_box(f"worker {rank} exit={rc}{straggler_note()}"
                           f" — evicting")
            fleet.evict(rank, reason=f"exit={rc}")
        if fleet.is_quarantined(rank):
            # quarantine is permanent: a rank voted out for silent data
            # corruption must never be respawned, no matter how much
            # restart budget is left — its silicon (or its stack) lies.
            # This is a degraded-but-deliberate outcome, distinct from a
            # transient eviction (lease expiry / crash), which rejoins.
            exit_codes.setdefault(rank, rc if rc != 0 else 1)
            degrade(rank, f"worker {rank} quarantined for corruption "
                          f"after exit={rc}; refusing restart")
            return
        if restarts[rank] < args.max_restarts:
            restarts[rank] += 1
            backoff = restart_backoff(args.backoff, restarts[rank])
            _tracing.emit("fleet.restart_worker", member=rank,
                          n=restarts[rank], backoff_seconds=backoff)
            _telemetry.counter("fleet.worker_restarts").inc()
            pending[rank] = time.monotonic() + backoff
            print(f"launch: worker {rank} exited {rc}; restart "
                  f"{restarts[rank]}/{args.max_restarts} in "
                  f"{backoff:.2f}s", file=sys.stderr)
        else:
            exit_codes.setdefault(rank, rc)
            degrade(rank, f"worker {rank} restart budget exhausted "
                          f"({args.max_restarts}) after exit={rc}")

    try:
        while procs or pending:
            for rank, p in list(procs.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del procs[rank]
                if rc == 0:
                    exit_codes[rank] = 0
                else:
                    on_failure(rank, rc)
            # lease-expired members (partitioned but process still alive)
            # are evicted by the protocol path, not the exit-code path
            world_before = fleet.world()
            fleet.reconcile()
            if fleet.world() != world_before:
                dump_fleet_box(f"membership changed by reconcile: "
                               f"{world_before} -> {fleet.world()}"
                               f"{straggler_note()}")
            agg.poll()
            for rank, due in list(pending.items()):
                if time.monotonic() < due:
                    continue
                del pending[rank]
                if fleet.is_quarantined(rank):
                    # the quarantine record can land while the rank sits
                    # in restart backoff (e.g. the survivors' vote names
                    # it after its crash) — drop the respawn, same as the
                    # on_failure refusal
                    exit_codes.setdefault(rank, 1)
                    degrade(rank, f"worker {rank} quarantined during "
                                  f"restart backoff; refusing respawn")
                    continue
                procs[rank] = spawn(rank, fresh=True)
                if fleet.wait_member(rank, timeout=args.join_timeout):
                    # reconcile (not admit): the loop's periodic reconcile
                    # may already have admitted the joiner — reconcile is
                    # idempotent where a second admit would burn an epoch
                    fleet.reconcile(reason="rejoin")
                else:
                    p = procs.pop(rank)
                    rc = p.poll()
                    if rc is None:
                        p.terminate()
                        rc = -1
                    on_failure(rank, rc)
            if len(fleet.world()) < args.min_workers and procs:
                degrade(-1, f"healthy world {fleet.world()} below "
                            f"--min-workers {args.min_workers}; aborting")
                raise SystemExit(1)
            if procs or pending:
                time.sleep(poll)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        # final flight record: whatever the workers last shipped, plus
        # the skew timeline and straggler verdict of the whole run
        dump_fleet_box(f"supervise exit{straggler_note()}")
    # signal deaths report negative codes — any nonzero outcome (even a
    # degraded-but-completed run) must surface as a failed launch
    return 1 if any(rc != 0 for rc in exit_codes.values()) else 0


def launch_ssh(args, coord):
    import random
    hosts = read_hostfile(args.hostfile)
    # The group's TCP store runs INSIDE rank 0 — i.e. on hosts[0], not on
    # this launcher machine — so that's the address every rank must dial.  The port can't be probed remotely; pick one from the dynamic
    # range (collision odds are negligible and a clash fails fast).
    port = random.randint(49152, 65535)
    coord = f"{hosts[0]}:{port}"
    cmds = build_ssh_commands(hosts, args.num_workers, coord, args.command,
                              args.env)
    return [subprocess.Popen(argv) for _host, argv in cmds]


def main():
    ap = argparse.ArgumentParser(
        description="Launch a multi-process SPMD job (local or ssh)")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--launcher", default="local", choices=["local", "ssh"])
    ap.add_argument("-H", "--hostfile",
                    help="hosts file for --launcher ssh (one per line)")
    ap.add_argument("--env", action="append", default=[],
                    help="extra KEY=VAL for the workers")
    ap.add_argument("--supervise", action="store_true",
                    help="elastic-fleet mode: run as membership controller, "
                         "restart preempted workers, admit rejoins at the "
                         "next epoch (local launcher only)")
    ap.add_argument("--fleet-dir",
                    help="membership store directory (default: a tempdir)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="per-worker restart budget before degrading")
    ap.add_argument("--min-workers", type=int, default=1,
                    help="abort when the healthy world drops below this")
    ap.add_argument("--backoff", type=float, default=0.5,
                    help="base seconds for jittered exponential restart "
                         "backoff")
    ap.add_argument("--lease", type=float, default=10.0,
                    help="heartbeat lease seconds (liveness horizon)")
    ap.add_argument("--join-timeout", type=float, default=30.0,
                    help="seconds to wait for a restarted worker to join")
    ap.add_argument("--keep-chaos", action="store_true",
                    help="keep TPUMX_CHAOS in restarted workers' env "
                         "(default: injected faults fire once per job)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command line")
    args = ap.parse_args()
    if not args.command:
        ap.error("no command given")
    if args.launcher == "ssh" and not args.hostfile:
        ap.error("--launcher ssh requires -H/--hostfile")
    if args.supervise and args.launcher != "local":
        ap.error("--supervise requires --launcher local")

    coord = f"127.0.0.1:{free_port()}"
    if args.supervise:
        code = supervise(args, coord)
    else:
        procs = launch_local(args, coord) if args.launcher == "local" \
            else launch_ssh(args, coord)
        code = 0
        for p in procs:
            code = p.wait() or code
        if code:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
    if cuda_context_created():
        print("launch: the launcher created a CUDA context", file=sys.stderr)
        code = code or 1
    sys.exit(code)


if __name__ == "__main__":
    main()
