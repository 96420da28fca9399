"""The port's fleet journal, lease and router recovery held to the JAX
package's: the same framed bytes, directories that replay to the same
state in both packages (written by either), the same lease fencing, and
the same recovered ledger from ``recover_from_journal`` and
``StandbyRouter.poll`` on the same directory.  The clocks are fake
wherever a decision reads one; both packages' telemetry and ndtimeline are
reset around every test.
"""

import json
import os
import shutil

import numpy as np
import pytest

from vescale_tpu.resilience import faultsim as ref_fs
from vescale_tpu.serve import journal as ref_journal

from vescale_tpu_torch.resilience import faultsim as port_fs
from vescale_tpu_torch.serve import journal as port_journal

import torch_fleet_fakes as F
from torch_reset import reset_all

JOURNALS = {"ref": ref_journal, "port": port_journal}
FAULTSIMS = {"ref": ref_fs, "port": port_fs}


@pytest.fixture(autouse=True)
def _dormant():
    reset_all()
    yield
    reset_all()
    ref_fs.disarm()
    port_fs.disarm()


def _canon(state):
    return json.loads(json.dumps(state, sort_keys=True))


def _records(n, seed):
    """Seeded journal records of every kind the router writes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = ["open", "submit", "dispatch", "drop", "terminal"][int(rng.integers(0, 5))]
        rid = int(rng.integers(0, 6))
        if k == "open":
            out.append(("open", {"e": int(rng.integers(1, 4))}))
        elif k == "submit":
            prompt = [int(x) for x in rng.integers(1, 60, int(rng.integers(1, 5)))]
            out.append(("submit", {"rid": rid, "req": {"rid": rid, "prompt": prompt,
                                                       "max_new_tokens": 3},
                                   "deadline_wall": None}))
        elif k == "dispatch":
            out.append(("dispatch", {"rid": rid, "replica": f"r{int(rng.integers(0, 3))}",
                                     "tag": port_journal.make_tag(1, i),
                                     "kind": ["dispatch", "failover", "hedge",
                                              "redispatch"][int(rng.integers(0, 4))]}))
        elif k == "drop":
            out.append(("drop", {"rid": rid, "replica": f"r{int(rng.integers(0, 3))}",
                                 "why": "failover"}))
        else:
            out.append(("terminal", {"rid": rid, "status": "completed", "replica": "r0",
                                     "outcome": {"status": "completed", "tokens": [i, i + 1],
                                                 "tag": i}}))
    return out


# ---------------------------------------------------------------- framing
def test_frames_are_byte_identical_and_corrupt_crcs_rejected():
    for kind, data in _records(60, seed=1) + [("snapshot", {"state": port_journal.empty_state()})]:
        rec = {"k": kind, **data}
        frame = port_journal.frame_record(rec)
        assert frame == ref_journal.frame_record(rec)
        assert port_journal.parse_frame(frame) == ref_journal.parse_frame(frame) == rec
        bad_crc = (b"%08x" % ((int(frame[:8], 16) + 1) & 0xFFFFFFFF)) + frame[8:]
        flipped = frame[:12] + bytes([frame[12] ^ 0x01]) + frame[13:]
        for defect in (bad_crc, flipped, frame[:5], frame[:8] + b"x" + frame[9:]):
            assert port_journal.parse_frame(defect) is None
            assert ref_journal.parse_frame(defect) is None
    assert port_journal.make_tag(3, 17) == ref_journal.make_tag(3, 17)
    assert port_journal.tag_epoch(port_journal.make_tag(3, 17)) == 3


def test_reduce_record_matches_the_reference():
    states = {pkg: mod.empty_state() for pkg, mod in JOURNALS.items()}
    for kind, data in _records(400, seed=2):
        for pkg, mod in JOURNALS.items():
            mod.reduce_record(states[pkg], {"k": kind, **data})
        assert _canon(states["port"]) == _canon(states["ref"])
    assert port_journal.slim_outcome({"status": "completed", "tokens": [1], "x": 2, "tag": 5}) == \
        ref_journal.slim_outcome({"status": "completed", "tokens": [1], "x": 2, "tag": 5})


# ------------------------------------------------------ cross-package replay
def _write_journaled_scenario(pkg, root):
    """The router scenario through ``pkg``'s journaled router, with
    snapshots and segment rotation, on a fake-clock lease."""
    t = [100.0]
    mod = JOURNALS[pkg]
    lease = mod.LeaderLease(os.path.join(root, "LEASE"), holder=f"leader-{pkg}", ttl_s=5.0,
                            now_fn=lambda: t[0])
    journal = mod.FleetJournal(root, fsync="flush", rotate_bytes=1500, snapshot_every=7)
    fr, _, _ = F.run_scenario(pkg, journal=journal, lease=lease)
    journal.close()
    return fr


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_journal_either_package_writes_replays_in_the_other(writer, tmp_path):
    root = str(tmp_path / "j")
    fr = _write_journaled_scenario(writer, root)
    segs = sorted(n for n in os.listdir(root) if n.startswith("wal-"))
    assert len(segs) >= 2  # rotated (older segments pruned to two)
    replays = {pkg: mod.replay_dir(root) for pkg, mod in JOURNALS.items()}
    assert _canon(replays["port"]) == _canon(replays["ref"])
    state, stats = replays["port"]
    assert stats["snapshots"] >= 1 and stats["quarantined"] == 0 and stats["torn"] == 0
    assert state["counts"] == fr.ledger.counts and not state["pending"]
    assert state["epoch"] == 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_torn_tail_and_quarantine_replay_the_same(writer, tmp_path):
    root = str(tmp_path / "j")
    mod = JOURNALS[writer]
    j = mod.FleetJournal(root, snapshot_every=0)
    j.begin_epoch(1)
    for kind, data in _records(40, seed=4):
        j.append(kind, data)
    j.flush()
    # a torn write: the last record stops half way
    FAULTSIMS[writer].arm(FAULTSIMS[writer].parse_schedule("journal_torn_write:call=0"))
    j.append("submit", {"rid": 99, "req": {"rid": 99, "prompt": [1], "max_new_tokens": 1},
                        "deadline_wall": None})
    j.flush()
    FAULTSIMS[writer].disarm()
    j.close()
    seg = os.path.join(root, "wal-000001.log")
    lines = open(seg, "rb").read().split(b"\n")
    lines[5] = lines[5][:20] + b"X" + lines[5][21:]  # one flipped byte mid-file
    open(seg, "wb").write(b"\n".join(lines))
    replays = {pkg: m.replay_dir(root) for pkg, m in JOURNALS.items()}
    assert _canon(replays["port"]) == _canon(replays["ref"])
    assert replays["port"][1]["torn"] == 1 and replays["port"][1]["quarantined"] == 1


# ------------------------------------------------------------------ lease
@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_lease_fences_a_stale_epoch(first, second, tmp_path):
    """Acquire, renew, refuse a live foreign lease, take over an expired
    one at epoch + 1, and fence the deposed writer, across packages."""
    t = [0.0]
    path = str(tmp_path / "LEASE")
    a = JOURNALS[first].LeaderLease(path, holder="a", ttl_s=2.0, now_fn=lambda: t[0])
    b = JOURNALS[second].LeaderLease(path, holder="b", ttl_s=2.0, now_fn=lambda: t[0])
    assert a.acquire() == 1
    with pytest.raises(JOURNALS[second].FencedEpochError):
        b.acquire()
    t[0] = 1.0
    a.renew()  # within ttl/3 of the last write: no rewrite, still ours
    t[0] = 5.0  # a stopped renewing: the lease expired
    assert b.expired() and b.acquire() == 2
    with pytest.raises(JOURNALS[first].FencedEpochError):
        a.check_fenced(1)
    with pytest.raises(JOURNALS[first].FencedEpochError):
        a.renew()
    # the deposed writer's journal refuses to write: nothing lands on disk
    jdir = str(tmp_path / "j")
    j = JOURNALS[first].FleetJournal(jdir, lease=a)
    j.writer_epoch = 1
    j.append("submit", {"rid": 1, "req": {"rid": 1, "prompt": [1], "max_new_tokens": 1},
                        "deadline_wall": None})
    with pytest.raises(JOURNALS[first].FencedEpochError):
        j.flush()
    assert j.buffered == 1 and os.path.getsize(os.path.join(jdir, "wal-000001.log")) == 0
    b.release()
    assert a.expired()


# ---------------------------------------------------------------- recovery
def _crashed_leader(writer, root):
    """A journaled leader that placed a wave and died before harvesting:
    the fakes keep what the replicas finished."""
    t = [100.0]
    log = []
    reps = [F.FakeReplica(writer, r, log) for r in ("a", "b", "c")]
    mod = JOURNALS[writer]
    lease = mod.LeaderLease(os.path.join(root, "LEASE"), holder="leader", ttl_s=2.0,
                            now_fn=lambda: t[0])
    journal = mod.FleetJournal(root, snapshot_every=5)
    fr = F.make_router(writer, reps, t, journal=journal, lease=lease)
    fr.poll(force=True)
    for i, r in enumerate(F.seeded_requests(writer, 9, seed=6)):
        fr.submit(r, session=f"s{i}" if i % 2 else None)
    reps[0].finish_all()  # a finished its work; b and c hold theirs
    reps[1].finish(next(iter(reps[1].inflight)))
    fr.pump()  # a's outcomes harvested and journaled
    for i, r in enumerate(F.seeded_requests(writer, 3, seed=7, base=50)):
        fr.submit(r)
    reps[2].finish_all()
    journal.flush()  # placements are flushed at their barrier; the crash loses nothing more
    return {r.id: (dict(r.inflight), dict(r.done)) for r in reps}


def _fleet_like(pkg, held):
    log = []
    reps = []
    for rid, (inflight, done) in held.items():
        r = F.FakeReplica(pkg, rid, log)
        r.inflight, r.done = dict(inflight), json.loads(json.dumps(done))
        reps.append(r)
    return reps, log


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("how", ["recover", "standby"])
def test_recovery_gives_the_reference_ledger(writer, how, tmp_path):
    src = str(tmp_path / "leader")
    held = _crashed_leader(writer, src)
    views = {}
    for pkg, mod in JOURNALS.items():
        root = str(tmp_path / f"copy-{pkg}")
        shutil.copytree(src, root)
        t = [500.0]  # the leader's lease (written at 100 + 2) expired long ago
        reps, log = _fleet_like(pkg, held)
        clients = {r.id: r for r in reps}
        lease = mod.LeaderLease(os.path.join(root, "LEASE"), holder="standby", ttl_s=2.0,
                                now_fn=lambda: t[0])
        kw = dict(poll_interval_s=0.0, breaker_failures=2, breaker_cooldown_s=1.0,
                  health_stale_s=0.0, dispatch_retries=3, backoff_s=0.01, backoff_max_s=0.1,
                  hedge_s=0.0, now_fn=lambda: t[0], sleep_fn=lambda s: t.__setitem__(0, t[0] + s))
        serve = F.PACKAGES[pkg]["serve"]
        if how == "recover":
            fr = serve.FleetRouter.recover_from_journal(root, clients, lease=lease, **kw)
        else:
            sb = serve.StandbyRouter(root, clients, lease=lease, router_kwargs=kw)
            tail = sb.tail()
            fr = sb.poll()
            assert sb.poll() is fr and sb.takeovers == 1
            views[pkg + "_tail"] = {k: v for k, v in tail.items() if k != "lease"}
        rec = dict(fr.recovery)
        for r in reps:
            r.finish_all()
        t[0] += 0.1
        for _ in range(3):
            if fr.pump() == 0:
                break
        fr.fleet_ledger_check()
        views[pkg] = dict(recovery=rec, ledger=F.ledger_view(fr), log=log,
                          summary=fr.summary(), epoch=fr.epoch)
    for key in ("recovery", "ledger", "log", "summary", "epoch"):
        assert views["port"][key] == views["ref"][key], key
    if how == "standby":
        assert views["port_tail"] == views["ref_tail"]
    rec = views["port"]["recovery"]
    assert rec["epoch"] == 2 and rec["takeover"] == (how == "standby")
    assert rec["pending_at_recovery"] >= 3 and rec["harvested"] >= 1 and rec["redriven"] == 0
