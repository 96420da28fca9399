"""The port's fleet replica, driven over HTTP by the JAX package's router and
by the port's own.

``vescale_tpu_torch.serve.serve_replica`` speaks the reference wire
protocol (``/submit``, ``/outcomes``, the frozen ``/router`` v5 feed), so
the reference ``FleetRouter``, ``HttpReplicaClient`` and ``FleetSupervisor``
drive port replicas unchanged.  The inbox-fed loop mirrors the reference's
own inbox tests, one replica serves in-process behind the router, and
three replica processes go through a ``replica_kill`` and rejoin as in
``scripts/fleet_smoke.py``: the fleet ledger balances with a failover, the
breaker walks closed, open, half-open, closed, and every completed stream
is bitwise the port's own fault-free run.  The same battery then runs
through the port's own ``FleetRouter`` and ``FleetSupervisor``, followed
by a journaled port router in a child process that ``router_kill`` ends
mid-load and a ``StandbyRouter`` here that takes over.  Every wait has
its own timeout.
"""

import functools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from vescale_tpu.serve import FleetRouter, FleetSupervisor, HttpReplicaClient, ReplicaSpec
from vescale_tpu.serve import Request as JaxRequest
from vescale_tpu.serve.obs import ROUTER_FIELDS, ROUTER_SCHEMA_VERSION
from vescale_tpu.serve.router import request_from_payload as jax_request_from_payload
from vescale_tpu.serve.router import request_payload
from vescale_tpu.testing import reserve_port

from vescale_tpu_torch import serve as tserve
from vescale_tpu_torch.resilience import faultsim as tfs
from vescale_tpu_torch.serve.fleet import RequestInbox, _outcomes_snapshot, request_from_payload
from vescale_tpu_torch.telemetry import ops_server as tops

import torch_serve_child as child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KILL_SCHEDULE = "replica_kill:call=2"


@pytest.fixture(autouse=True)
def clean_envelope():
    yield
    tfs.disarm()
    assert tops.active_server() is None


def _req(rid, max_new=2):
    return tserve.Request(rid=rid, prompt=(1 + rid % 50, 2), max_new_tokens=max_new)


def _prompts(n, base_rid=0):
    """The fleet smoke's load: seeded prompts of 3-5 tokens, 4-6 new tokens."""
    import numpy as np

    rng = np.random.default_rng(23)
    return [(base_rid + i, tuple(int(x) for x in rng.integers(1, 60, 3 + i % 3)), 4 + i % 3)
            for i in range(n)]


# ----------------------------------------------------------------- wire
@pytest.mark.parametrize("kw", [dict(), dict(eos_id=3, deadline_steps=9, tag=77, tenant="paid")])
def test_request_from_payload_equals_the_reference(kw):
    jreq = JaxRequest(rid=4, prompt=(5, 6, 7), max_new_tokens=3, **kw)
    payload = json.loads(json.dumps(request_payload(jreq, session="s1")))
    treq = request_from_payload(payload)
    assert treq == tserve.Request(rid=4, prompt=(5, 6, 7), max_new_tokens=3, **kw)
    assert jax_request_from_payload(payload) == jreq


def test_request_inbox_push_drain_close():
    box = RequestInbox()
    assert box.push(_req(1)) and box.push(_req(2))
    assert [r.rid for r in box.drain()] == [1, 2]
    assert box.drain() == []
    box.close()
    assert box.closed and not box.push(_req(3))
    assert box.drain() == [] and box.pushed_total == 2


# ------------------------------------------------------- inbox + loop
def _loop(sched, eng, box, **kw):
    return tserve.run_serve_resilient(engine=eng, scheduler=sched, arrivals=(), inbox=box,
                                      install_signal_handlers=False, coordinate=False,
                                      max_steps=10_000, **kw)


def test_inbox_fed_loop_serves_and_exits_on_close():
    eng, sched = child.build(max_queue=8)
    box = RequestInbox()
    box.push(_req(0, max_new=3))
    box.push(_req(1, max_new=2))
    closed = []

    def on_step(step, active):
        if not closed and len(sched.outcomes) == 2 and sched.all_terminal():
            box.close()
            closed.append(step)

    res = _loop(sched, eng, box, on_step=on_step)
    assert res.status == "completed" and closed
    assert {o["status"] for o in res.outcomes.values()} == {"completed"}
    sched.ledger_check()
    rows = _outcomes_snapshot(sched)
    assert set(rows) == {"0", "1"} and rows["0"]["tokens"] == res.outcomes[0]["tokens"]


def test_inbox_duplicate_rid_rejected_without_killing_the_loop():
    eng, sched = child.build(max_queue=8)
    box = RequestInbox()
    box.push(_req(5, max_new=10))
    box.push(_req(5, max_new=10))  # a duplicate while pending: rejected

    def on_step(step, active):
        if len(sched.outcomes) == 1 and sched.all_terminal():
            box.close()

    res = _loop(sched, eng, box, on_step=on_step)
    assert res.status == "completed"
    assert len(res.outcomes) == 1 and res.outcomes[5]["status"] == "completed"
    assert sched.telemetry.counter("serve_inbox_rejected_total") == 1


def test_inbox_closed_with_pending_items_still_served():
    eng, sched = child.build(max_queue=8)
    box = RequestInbox()
    assert box.push(_req(0)) and box.push(_req(1))
    box.close()  # closed while items are still pending
    res = _loop(sched, eng, box)
    assert res.status == "completed" and sorted(res.outcomes) == [0, 1]
    assert {o["status"] for o in res.outcomes.values()} == {"completed"}


def test_idle_replica_sleeps_and_keeps_its_step_advancing(monkeypatch):
    monkeypatch.setenv("VESCALE_SERVE_IDLE_S", "0.001")
    eng, sched = child.build(max_queue=8)
    box = RequestInbox()
    steps = []

    def on_step(step, active):
        steps.append(step)
        if step == 20:
            box.close()

    t0 = time.perf_counter()
    res = _loop(sched, eng, box, on_step=on_step)
    assert res.status == "completed" and steps == list(range(21))
    assert time.perf_counter() - t0 >= 0.02  # one idle slice per boundary


# ------------------------------------------------------- one replica
def test_serve_replica_over_http_with_the_reference_router():
    """One port replica in this process behind the reference router:
    dispatch, harvest, the v5 feed, ledger balance, and a clean exit when
    the inbox closes."""
    eng, sched = child.build(max_queue=8)
    port = reserve_port()
    box = RequestInbox()
    result = {}

    def run():
        result["res"] = tserve.serve_replica(engine=eng, scheduler=sched, replica_id="t0",
                                             port=port, inbox=box, linger_s=0.1,
                                             install_signal_handlers=False, coordinate=False)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        fr = FleetRouter(poll_interval_s=0.02, breaker_failures=5, breaker_cooldown_s=0.2,
                         dispatch_retries=8, backoff_s=0.05, backoff_max_s=0.5, hedge_s=0.0)
        fr.add_replica("t0", HttpReplicaClient(f"http://127.0.0.1:{port}"))
        for i in range(3):
            fr.submit(JaxRequest(rid=i, prompt=(3 + i, 5), max_new_tokens=2), session="s0")
        fr.drain(timeout_s=60.0)
        fr.fleet_ledger_check()
        assert fr.ledger.counts["completed"] == 3
        feed = fr.replicas["t0"].feed
        assert set(feed) == ROUTER_FIELDS and feed["schema_version"] == ROUTER_SCHEMA_VERSION
        assert feed["replica_id"] == "t0" and feed["accepting"] is True
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
            assert "serve_requests_completed_total 3" in resp.read().decode()
    finally:
        box.close()
        th.join(timeout=60)
    assert not th.is_alive() and result["res"].status == "completed"
    golden = {i: sched.outcomes[i]["tokens"] for i in range(3)}
    for i in range(3):
        assert fr.ledger.records[i].outcome["tokens"] == golden[i]


# ----------------------------------------------------- three replicas
def _specs(workdir, kill_replica, make=ReplicaSpec):
    """Three replica specs (``make``: either package's ``ReplicaSpec``)."""
    specs = []
    for i in range(3):
        rid = f"r{i}"
        env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
        env.update(PYTHONPATH=REPO, VESCALE_SERVE_MAX_QUEUE="16")
        if rid == kill_replica:
            env["VESCALE_FAULTSIM"] = KILL_SCHEDULE
        specs.append(make(rid, [sys.executable, os.path.join(REPO, "tests", "torch_serve_child.py"),
                                       "replica"], reserve_port(), env=env,
                                 log_path=os.path.join(workdir, f"{rid}.log"),
                                 restart_env_drop=("VESCALE_FAULTSIM",)))
    return specs


@functools.lru_cache(maxsize=None)
def _golden():
    """The port's fault-free run of both waves of the kill tests."""
    eng, sched = child.build(max_queue=32)
    load = _prompts(12) + _prompts(6, base_rid=100)
    return tserve.run_serve(eng, sched, [(0, tserve.Request(rid=r, prompt=p, max_new_tokens=m))
                                         for r, p, m in load])


def _until(what, cond, sup, fr, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.poll()
        fr.poll(force=True)
        if cond():
            return
        time.sleep(0.1)
    raise TimeoutError(f"{what} within {timeout_s}s: "
                       + str({r: (h.breaker.state, h.feed is not None) for r, h in fr.replicas.items()}))


def _drain(fr, sup, timeout_s):
    deadline = time.monotonic() + timeout_s
    while True:
        sup.poll()
        if fr.pump() == 0:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"fleet drain stuck: pending {[r.req.rid for r in fr.ledger.pending()]}")
        time.sleep(0.05)


def test_reference_router_fails_over_a_killed_port_replica(tmp_path):
    """Three port replica processes behind the reference router; r1 dies
    abruptly (``replica_kill``) on its third loaded decode step, the
    supervisor restarts it, and its breaker readmits it."""
    specs = _specs(str(tmp_path), kill_replica="r1")
    fr = FleetRouter(poll_interval_s=0.05, breaker_failures=2, breaker_cooldown_s=0.5,
                     dispatch_retries=4, backoff_s=0.05, backoff_max_s=0.5, hedge_s=0.0)
    sup = FleetSupervisor(specs, max_restarts=2, restart_backoff_s=0.3)
    sup.start()
    try:
        for s in specs:
            fr.add_replica(s.replica_id, HttpReplicaClient(s.url))
        _until("fleet up", lambda: all(h.feed is not None and h.breaker.state == "closed"
                                       for h in fr.replicas.values()), sup, fr, 60.0)
        for rid, prompt, max_new in _prompts(12):
            # half pinned to a session, half least-loaded: every replica
            # holds work, the victim included
            fr.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=max_new),
                      session=f"sess{rid % 5}" if rid % 2 == 0 else None)
        _drain(fr, sup, 60.0)
        _until("r1 readmitted", lambda: fr.replicas["r1"].breaker.state == "closed", sup, fr, 60.0)
        # fresh traffic after the rejoin: least-loaded picks the empty r1
        for rid, prompt, max_new in _prompts(6, base_rid=100):
            fr.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=max_new))
        _drain(fr, sup, 60.0)
        fr.fleet_ledger_check()
        summary = fr.summary()
        records = dict(fr.ledger.records)
        transitions = [(t["from"], t["to"]) for t in fr.breaker_transitions if t["replica"] == "r1"]
    finally:
        rcs = sup.stop_all(grace_s=30.0)
    counts = summary["counts"]
    assert counts["completed"] == 18 and counts["failovers"] >= 1, counts
    assert counts["redispatched"] >= counts["failovers"]
    assert sup.managed["r1"].exit_history[0] == 29  # VESCALE_FAULTSIM_KILL_EXIT_CODE
    assert rcs == {"r0": 0, "r1": 0, "r2": 0}  # every drain on SIGTERM exits clean
    # closed -> open -> half-open -> closed; a probe that lands before the
    # restart is up re-opens the breaker on the way
    assert transitions[0] == ("closed", "open") and transitions[-1] == ("half_open", "closed")
    assert ("open", "half_open") in transitions
    assert set(transitions) <= {("closed", "open"), ("open", "half_open"),
                                ("half_open", "open"), ("half_open", "closed")}
    assert any(rec.replica == "r1" for rid, rec in records.items() if rid >= 100)

    # every completed stream is bitwise the port's own fault-free run
    golden = _golden()
    for rid, rec in records.items():
        assert rec.status == "completed"
        assert rec.outcome["tokens"] == golden.outcomes[rid]["tokens"], rid


# -------------------------------------------- the port's own fleet tier
PORT_ROUTER = dict(poll_interval_s=0.05, breaker_failures=2, breaker_cooldown_s=0.3,
                   dispatch_retries=4, backoff_s=0.05, backoff_max_s=0.5, hedge_s=0.0)
HA_BASE = 200


def _treq(rid, prompt, max_new):
    return tserve.Request(rid=rid, prompt=prompt, max_new_tokens=max_new)


def test_port_router_supervisor_failover_and_standby_takeover(tmp_path):
    """Three port replicas behind the port's router and supervisor: r1 dies
    on its third loaded decode step, its work fails over, the breaker
    walks closed, open, half-open, closed and the rejoined r1 serves fresh
    rids.  Then a journaled port router in a child process takes the
    lease, places a wave on the same replicas and is ended by
    ``router_kill`` at its first pump; a ``StandbyRouter`` takes over at
    epoch 2 and finishes the wave, every stream bitwise golden."""
    specs = _specs(str(tmp_path), kill_replica="r1", make=tserve.ReplicaSpec)
    fr = tserve.FleetRouter(**PORT_ROUTER)
    sup = tserve.FleetSupervisor(specs, max_restarts=2, restart_backoff_s=0.1)
    # the doomed leader starts now and waits for its spec file
    spec_path = str(tmp_path / "router.json")
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    env.update(PYTHONPATH=REPO, VESCALE_FAULTSIM="router_kill:call=0")
    leader = subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_serve_child.py"),
                               "router", spec_path], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    sup.start()
    try:
        for s in specs:
            fr.add_replica(s.replica_id, tserve.HttpReplicaClient(s.url))
        _until("fleet up", lambda: all(h.feed is not None and h.breaker.state == "closed"
                                       for h in fr.replicas.values()), sup, fr, 60.0)
        for rid, prompt, max_new in _prompts(12):
            fr.submit(_treq(rid, prompt, max_new), session=f"sess{rid % 5}" if rid % 2 == 0 else None)
        _drain(fr, sup, 60.0)
        _until("r1 readmitted", lambda: fr.replicas["r1"].breaker.state == "closed", sup, fr, 60.0)
        for rid, prompt, max_new in _prompts(6, base_rid=100):
            fr.submit(_treq(rid, prompt, max_new))
        _drain(fr, sup, 60.0)
        fr.fleet_ledger_check()
        counts = fr.summary()["counts"]
        records = dict(fr.ledger.records)
        transitions = [(t["from"], t["to"]) for t in fr.breaker_transitions if t["replica"] == "r1"]

        # ---- router HA over the same (router-agnostic) replicas
        jdir = str(tmp_path / "journal")
        wave = _prompts(6, base_rid=HA_BASE)
        with open(spec_path + ".tmp", "w") as f:
            json.dump(dict(replicas={s.replica_id: s.url for s in specs}, journal_dir=jdir,
                           lease_path=os.path.join(jdir, "LEASE"), ttl_s=0.5, router=PORT_ROUTER,
                           wave=[[r, list(p), m] for r, p, m in wave]), f)
        os.replace(spec_path + ".tmp", spec_path)
        out, _ = leader.communicate(timeout=60)
        assert leader.returncode == 29, out
        standby = tserve.StandbyRouter(jdir, {s.replica_id: tserve.HttpReplicaClient(s.url)
                                              for s in specs}, router_kwargs=PORT_ROUTER)
        tail = standby.tail()
        assert tail["epoch"] == 1 and tail["pending"] == len(wave), tail
        deadline = time.monotonic() + 30.0
        fr2 = None
        while fr2 is None:
            assert time.monotonic() < deadline, "the standby never took over"
            sup.poll()
            fr2 = standby.poll()
            time.sleep(0.05)
        rec = fr2.recovery
        assert rec["takeover"] and rec["epoch"] == 2 and rec["pending_at_recovery"] == len(wave)
        assert rec["quarantined"] == 0 and rec["torn"] == 0
        _drain(fr2, sup, 60.0)
        fr2.fleet_ledger_check()
        ha_counts = fr2.summary()["counts"]
        ha_records = dict(fr2.ledger.records)
        srv = fr2.start_ops(0)
        try:
            with urllib.request.urlopen(f"{srv.url}/fleet", timeout=10) as resp:
                fleet = json.loads(resp.read())
        finally:
            fr2.stop_ops()
    finally:
        if leader.poll() is None:
            leader.kill()
            leader.wait()
        rcs = sup.stop_all(grace_s=30.0)
    assert counts["completed"] == 18 and counts["failovers"] >= 1, counts
    assert sup.managed["r1"].exit_history[0] == 29
    assert rcs == {"r0": 0, "r1": 0, "r2": 0}
    assert transitions[0] == ("closed", "open") and transitions[-1] == ("half_open", "closed")
    assert ("open", "half_open") in transitions
    assert any(r.replica == "r1" for rid, r in records.items() if rid >= 100)
    assert ha_counts["completed"] == len(wave) and ha_counts["submitted"] == len(wave)
    assert fleet["schema_version"] == 5 and fleet["ha"]["role"] == "leader"
    assert fleet["ha"]["epoch"] == 2 and fleet["ha"]["recovery"]["takeover"] is True

    golden = _golden()
    for rid, r in records.items():
        assert r.status == "completed" and r.outcome["tokens"] == golden.outcomes[rid]["tokens"], rid
    for rid, r in ha_records.items():
        assert r.status == "completed"
        # the HA wave reuses the first wave's prompts: rid 200 + i is rid i
        assert r.outcome["tokens"] == golden.outcomes[rid - HA_BASE]["tokens"], rid
