"""The port's cross-replica fingerprint vote against the JAX reference,
on the CPU.

``parallel/integrity.py``'s ``IntegrityMonitor``: the same publishes give
the same verdicts (all agree, a strict majority naming the minority, a
tie that names no one, an absent rank), the same ``DataCorruption`` at
the step boundary, the same history ring and ledger; each package's
files are the other's.  Then the port's train step under chaos
``bitflip_param_at_step``: three replicas of a tiny BERT with one seed,
one bit flipped on rank 2 after step 3, and the step-4 vote names rank
2 (``chip_smoke.py``'s replica vote, which the card runs at full width).
"""
import os
import sys
import threading

import pytest
import torch

from tpu_mx import telemetry as jtelemetry
from tpu_mx import tracing as jtracing
from tpu_mx.parallel import integrity as jint
from tpu_mx.supervisor import DataCorruption as JDataCorruption

from tpu_mx_torch import telemetry, tracing
from tpu_mx_torch.parallel import integrity as pint
from tpu_mx_torch.supervisor import DataCorruption

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("TPUMX_CHAOS", raising=False)
    monkeypatch.delenv("TPUMX_FLEET_MEMBER", raising=False)
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()
    yield
    for mod in (tracing, telemetry, jtracing, jtelemetry):
        mod.reset()


def _verdict(v):
    return None if v is None else {k: x for k, x in v.items()
                                   if k != "wall_time"}


# (world, {rank: fp}) published at step 4; the vote is rank 0's
VOTES = {
    "agree": ([0, 1, 2], {0: 7, 1: 7, 2: 7}),
    "minority": ([0, 1, 2], {0: 7, 1: 7, 2: 9}),
    "self_minority": ([0, 1, 2], {0: 9, 1: 7, 2: 7}),
    "tie_of_two": ([0, 1], {0: 7, 1: 8}),
    "tie_of_four": ([0, 1, 2, 3], {0: 7, 1: 7, 2: 8, 3: 8}),
    "absent": ([0, 1, 2], {0: 7, 1: 7}),
    "no_quorum": ([0, 1, 2], {0: 7}),
}


@pytest.mark.parametrize("case", sorted(VOTES))
def test_the_vote_is_the_references(tmp_path, case):
    world, fps = VOTES[case]
    got = {}
    for name, mod in (("port", pint), ("ref", jint)):
        root = tmp_path / name
        mons = {r: mod.IntegrityMonitor(root, rank=r, world=world,
                                        interval=2, vote_timeout=0.05,
                                        poll=0.01)
                for r in world}
        for r, fp in fps.items():
            mons[r].publish(4, fp)
        got[name] = (_verdict(mons[0].vote(4)), mons[0].verified_step,
                     mons[0].first_disagree_step)
    assert got["port"] == got["ref"]
    want_minority = {"minority": [2], "self_minority": [0]}.get(case, [])
    if got["port"][0] is not None:
        assert got["port"][0]["minority"] == want_minority
    for name in ("integrity.votes", "integrity.mismatches",
                 "integrity.fingerprints", "integrity.verified_step"):
        assert getattr(telemetry.get(name), "value", None) == \
            getattr(jtelemetry.get(name), "value", None)


def test_each_package_reads_the_others_files(tmp_path):
    """Ranks of both packages publish into one directory and vote
    together: the files are one format."""
    port = [pint.IntegrityMonitor(tmp_path, rank=r, world=[0, 1, 2],
                                  vote_timeout=0.05) for r in (0, 2)]
    ref = jint.IntegrityMonitor(tmp_path, rank=1, world=[0, 1, 2],
                                vote_timeout=0.05)
    port[0].publish(2, 11)
    ref.publish(2, 11)
    port[1].publish(2, 12)
    a, b = _verdict(port[0].vote(2)), _verdict(ref.vote(2))
    assert a == b and a["minority"] == [2]
    lines = (tmp_path / "integrity" / "votes-0.jsonl").read_text()
    assert '"minority": [2]' in lines


def _duty(mod, exc, root, ranks_fps, interval=2):
    """``on_committed_step`` of every rank for steps 1-4 (one thread each,
    as separate processes would), each rank's fingerprint from
    ``ranks_fps[step][rank]``.  Returns each rank's outcome per step and
    its ledger."""
    world = sorted(ranks_fps[1])
    mons = {r: mod.IntegrityMonitor(root, rank=r, world=world,
                                    interval=interval, vote_timeout=5.0,
                                    poll=0.01) for r in world}
    out = {r: [] for r in world}
    for step in sorted(ranks_fps):
        def run(r, step=step):
            try:
                v = mons[r].on_committed_step(step, fp=ranks_fps[step][r])
                out[r].append(None if v is None else v["agree"])
            except exc as e:
                out[r].append((e.step, e.minority, e.verified_step,
                               e.surface, e.self_corrupt))
        threads = [threading.Thread(target=run, args=(r,)) for r in world]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    ledgers = {r: m.state_dict() for r, m in mons.items()}
    return out, ledgers


def test_the_duty_cycle_raises_the_references_verdict(tmp_path):
    fps = {1: {0: 5, 1: 5, 2: 5}, 2: {0: 6, 1: 6, 2: 6},
           3: {0: 7, 1: 7, 2: 7}, 4: {0: 8, 1: 8, 2: 99}}
    port = _duty(pint, DataCorruption, tmp_path / "port", fps)
    ref = _duty(jint, JDataCorruption, tmp_path / "ref", fps)
    assert port == ref
    outcomes, ledgers = port
    assert outcomes[0] == [None, True, None, (4, (2,), 2, "train", False)]
    assert outcomes[2][3] == (4, (2,), 2, "train", True)
    assert ledgers[0]["verified_step"] == 2
    assert ledgers[0]["first_disagree_step"] == 4
    # the ledger the capsule carries round-trips
    mon = pint.IntegrityMonitor(tmp_path / "x", rank=0, interval=2)
    mon.load_state_dict(ledgers[0])
    assert mon.state_dict() == ledgers[0]
    jmon = jint.IntegrityMonitor(tmp_path / "y", rank=0, interval=2)
    jmon.load_state_dict(ledgers[0])
    assert jmon.state_dict() == mon.state_dict()


def test_the_history_ring_serves_a_slow_voter(tmp_path):
    """A fast rank has published steps 2, 4 and 6 before a slow one votes
    on step 2: the ring still holds step 2's fingerprint."""
    got = {}
    for name, mod in (("port", pint), ("ref", jint)):
        fast = mod.IntegrityMonitor(tmp_path / name, rank=1, world=[0, 1])
        slow = mod.IntegrityMonitor(tmp_path / name, rank=0, world=[0, 1],
                                    vote_timeout=0.05)
        for s in (2, 4, 6):
            fast.publish(s, 100 + s)
        slow.publish(2, 102)
        got[name] = _verdict(slow.vote(2))
        beats = []
        slow.heartbeat = lambda: beats.append(1)
        slow.vote(8)       # nobody published: waits, beating
        got[name + "_beat"] = bool(beats)
    assert got["port"] == got["ref"] and got["port"]["agree"]
    assert got["port_beat"] and got["ref_beat"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_flipped_bit_in_the_step_is_voted_out(tmp_path, dtype):
    """Three replicas of one seed (tiny BERT, LAMB; bf16 with float32
    masters): chaos flips one bit of rank 2's committed parameters after
    its step 3; the fingerprints of ranks 0 and 1 agree at every step,
    rank 2's from step 4, and the step-4 vote names rank 2 on every
    rank (``self_corrupt`` on rank 2 itself)."""
    cfg = dict(num_layers=2, units=32, hidden_size=64, num_heads=2,
               vocab_size=60, max_length=16, dropout=0.1)
    fps, verdicts, bitflips = chip_smoke.supervised_replicas(
        torch, cfg, str(tmp_path), 2, device="cpu",
        shape=(4, 16, 3, (8, 16)), dtype=dtype)
    assert bitflips == 1
    assert all(f[0] == f[1] is not None for f in fps)
    assert [f[2] == f[0] for f in fps] == [True, True, True, False]
    for r in range(3):
        assert verdicts[r] == [
            dict(step=1, agree=None), dict(step=2, agree=True),
            dict(step=3, agree=None),
            dict(step=4, agree=False, minority=[2], self_corrupt=r == 2)]
