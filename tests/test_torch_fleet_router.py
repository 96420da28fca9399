"""The port's fleet router held to the JAX package's on the same inputs.

One scripted scenario (``torch_fleet_fakes.run_scenario``: polls, a
replica whose polls fail, submit rejections with ``retry_after_s``, a
replica-level shed, session affinity, hedging, an expiring deadline, a
fleet-level shed, a breaker that heals and a replica that dies with work
on it) runs through the port's and the reference ``FleetRouter`` over
in-memory fakes on a fake clock; the dispatches, breaker history, ledger,
``summary()`` and ``fleet_*`` counters must be equal.  The hash ring, the
breaker, the payloads and the HTTP client are held the same way.  No
assertion reads wall time; both packages' telemetry and ndtimeline are
reset around every test.
"""

import json

import numpy as np
import pytest

from vescale_tpu import telemetry as ref_tel
from vescale_tpu.serve import router as ref_router

from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.serve import router as port_router
from vescale_tpu_torch.telemetry import ops_server as tops

import torch_fleet_fakes as F
from test_torch_ndtimeline import reset_all

ROUTERS = {"ref": ref_router, "port": port_router}


@pytest.fixture(autouse=True)
def _dormant():
    reset_all()
    yield
    reset_all()


def _quiet_telemetry():
    for mod in (ref_tel, tel):
        mod.init(out_dir=None, jsonl=False, memtrack=False, timeseries=False, alerts=False,
                 costaudit=False)


def test_router_scenario_matches_the_reference():
    _quiet_telemetry()
    views = {}
    for pkg, mod in (("ref", ref_tel), ("port", tel)):
        fr, _, log = F.run_scenario(pkg)
        fr.fleet_ledger_check()
        views[pkg] = dict(log=log, ledger=F.ledger_view(fr), transitions=F.transitions_view(fr),
                          summary=fr.summary(), counters=F.fleet_counters(mod.get_registry()))
    port, ref = views["port"], views["ref"]
    assert port["log"] == ref["log"]
    assert port["transitions"] == ref["transitions"]
    assert port["ledger"] == ref["ledger"]
    assert port["summary"] == ref["summary"]
    assert port["counters"] == ref["counters"]
    # the scenario reaches every path it names
    c = port["summary"]["counts"]
    assert c["hedges"] >= 1 and c["failovers"] >= 1 and c["timed_out"] == 1 and c["shed"] == 1
    assert c["redispatched"] > c["hedges"] + c["failovers"]  # the replica-level shed spilled
    assert ("b", "half_open", "closed", "probe success") in port["transitions"]
    assert port["counters"]["fleet_dispatch_total"] == c["dispatched"]


@pytest.mark.parametrize("pending_rid", [None, 3])
def test_fleet_ledger_check_matches_the_reference(pending_rid):
    """A balanced ledger passes in both; one with a pending rid fails with
    the same message."""
    errs = {}
    for pkg in ("ref", "port"):
        serve = F.PACKAGES[pkg]["serve"]
        led = serve.FleetLedger()
        for req in F.seeded_requests(pkg, 5, seed=9):
            rec = ROUTERS[pkg].FleetRecord(req=req)
            led.submitted(rec)
            led.dispatched(rec, "r0", 0.0)
            if req.rid != pending_rid:
                led.resolve(rec, "completed", {"tokens": [1]}, "r0", 1.0)
        try:
            ROUTERS[pkg].fleet_ledger_check(led)
            errs[pkg] = None
        except AssertionError as e:
            errs[pkg] = str(e)
        errs[pkg + "_counts"] = dict(led.counts)
    assert errs["port"] == errs["ref"] and errs["port_counts"] == errs["ref_counts"]
    assert (errs["port"] is None) == (pending_rid is None)


@pytest.mark.parametrize("vnodes", [64, 7])
def test_consistent_hash_ring_agrees_under_churn(vnodes):
    rng = np.random.default_rng(vnodes)
    keys = [f"sess-{int(x)}" for x in rng.integers(0, 1 << 30, 1000)]
    rings = {pkg: mod.ConsistentHashRing(vnodes=vnodes) for pkg, mod in ROUTERS.items()}
    nodes = [f"r{i}" for i in range(5)]
    plan = [("add", n) for n in nodes] + [("remove", "r2"), ("add", "r5"), ("remove", "r0")]
    for op, node in plan:
        for ring in rings.values():
            getattr(ring, op)(node)
        assert rings["port"].nodes() == rings["ref"].nodes()
        live = list(rings["ref"].nodes())
        eligible = live[::2]  # a filter that leaves the ring alone
        for k in keys:
            assert rings["port"].lookup(k, live) == rings["ref"].lookup(k, live)
            assert rings["port"].lookup(k, eligible) == rings["ref"].lookup(k, eligible)
    assert rings["port"].lookup("x", []) is None and rings["ref"].lookup("x", []) is None


def test_breaker_walks_as_the_reference_on_a_seeded_sequence():
    rng = np.random.default_rng(5)
    # 0 success, 1 failure, 2 advance the clock and poll
    events = rng.choice(3, 400, p=[0.2, 0.5, 0.3])
    seen = {}
    for pkg, mod in ROUTERS.items():
        t = [0.0]
        b = mod.CircuitBreaker(failures=3, cooldown_s=0.5, now_fn=lambda: t[0])
        trace = []
        for e in events:
            if e == 0:
                b.record_success()
            elif e == 1:
                b.record_failure()
            else:
                t[0] += 0.2
                trace.append(b.poll_disposition())
            trace.append((b.state, b.dispatchable, b.consecutive_failures))
        seen[pkg] = (trace, b.opens, b.reopens, b.closes)
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] > 0 and seen["port"][2] > 0 and seen["port"][3] > 0


@pytest.mark.parametrize("kw", [dict(), dict(eos_id=3, deadline_steps=9, tag=77, tenant="paid")])
@pytest.mark.parametrize("session", [None, "s1"])
def test_request_payload_round_trips_across_the_packages(kw, session):
    reqs = {pkg: F.PACKAGES[pkg]["serve"].Request(rid=4, prompt=(5, 6, 7), max_new_tokens=3, **kw)
            for pkg in ROUTERS}
    wire = {pkg: json.dumps(ROUTERS[pkg].request_payload(reqs[pkg], session=session),
                            sort_keys=True) for pkg in ROUTERS}
    assert wire["port"] == wire["ref"]
    for src in ROUTERS:
        for dst in ROUTERS:
            assert ROUTERS[dst].request_from_payload(json.loads(wire[src])) == reqs[dst]


def test_score_matches_the_reference():
    rng = np.random.default_rng(11)
    for _ in range(50):
        kw = dict(queue=int(rng.integers(0, 9)), inflight=int(rng.integers(0, 5)),
                  slots=int(rng.integers(1, 9)),
                  p99=None if rng.random() < 0.3 else float(rng.random()))
        f = F.feed("x", **kw)
        local = int(rng.integers(0, 4))
        assert port_router.FleetRouter.score(f, local) == ref_router.FleetRouter.score(f, local)


def test_http_client_against_a_port_ops_server():
    """The port's client speaks to a live port ops server: GET and POST
    round trips, the Retry-After capture, and every transport failure as
    ``ReplicaUnreachable``."""
    srv = tops.OpsServer(port=0).start()
    try:
        srv.register("router", lambda: dict(F.feed("h0", accepting=False, retry_after=2.5)))
        srv.register("submit", lambda p: {"accepted": True, "echo": p["rid"]})
        srv.register("outcomes", lambda: {"outcomes": {"1": {"status": "completed"}}})
        client = port_router.HttpReplicaClient(srv.url, timeout_s=5.0)
        feed = client.poll_router()
        assert feed["replica_id"] == "h0" and client.last_retry_after_header == 3.0
        assert client.submit({"rid": 9})["echo"] == 9
        assert client.last_retry_after_header is None
        assert client.outcomes()["outcomes"]["1"]["status"] == "completed"
        with pytest.raises(port_router.ReplicaUnreachable):
            client.control({"op": "status"})  # no provider: a 404
    finally:
        srv.stop()
    with pytest.raises(port_router.ReplicaUnreachable):
        port_router.HttpReplicaClient(srv.url, timeout_s=1.0).poll_health()
