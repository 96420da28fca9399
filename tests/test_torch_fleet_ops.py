"""The port's fleet operations held to the JAX package's on the same inputs:
the autoscaler's decisions over one fed signal trace, the rolling
rollout's ``/control`` calls and outcome (the diverging canary included),
``FleetObservability``'s ``/fleet`` and ``/healthz`` feeds and gauges,
the fleet rule pack, the HTTP clock offsets, fleet-journey verification
over both packages' span streams, and the fleet and autoscaler knobs.
Every clock a decision reads is fake (``time.time`` is replaced where the
code reads it directly); both packages' telemetry and ndtimeline are reset
around every test.
"""

import copy
import json

import numpy as np
import pytest

from vescale_tpu import ndtimeline as ref_nd
from vescale_tpu import telemetry as ref_tel
from vescale_tpu.analysis import envreg
from vescale_tpu.ndtimeline.timer import Span as RefSpan
from vescale_tpu.serve import autoscale as ref_autoscale
from vescale_tpu.serve import fleettrace as ref_ft
from vescale_tpu.serve import obs as ref_obs
from vescale_tpu.telemetry import alerts as ref_alerts

from vescale_tpu_torch import config
from vescale_tpu_torch import ndtimeline as nd
from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.ndtimeline.timer import Span
from vescale_tpu_torch.serve import autoscale as port_autoscale
from vescale_tpu_torch.serve import fleettrace as port_ft
from vescale_tpu_torch.serve import obs as port_obs
from vescale_tpu_torch.telemetry import alerts

import torch_fleet_fakes as F
from test_torch_ndtimeline import reset_all

PKG = {
    "ref": dict(autoscale=ref_autoscale, ft=ref_ft, obs=ref_obs, tel=ref_tel, nd=ref_nd,
                alerts=ref_alerts, Span=RefSpan),
    "port": dict(autoscale=port_autoscale, ft=port_ft, obs=port_obs, tel=tel, nd=nd,
                 alerts=alerts, Span=Span),
}

FLEET_KNOBS = (
    "VESCALE_FLEET_POLL_S", "VESCALE_FLEET_POLL_TIMEOUT_S", "VESCALE_FLEET_HEALTH_STALE_S",
    "VESCALE_FLEET_RETRIES", "VESCALE_FLEET_BACKOFF_S", "VESCALE_FLEET_BACKOFF_MAX_S",
    "VESCALE_FLEET_HEDGE_S", "VESCALE_FLEET_BREAKER_FAILURES", "VESCALE_FLEET_BREAKER_COOLDOWN_S",
    "VESCALE_FLEET_OPS_PORT", "VESCALE_FLEET_JOURNAL_DIR", "VESCALE_FLEET_JOURNAL_FSYNC",
    "VESCALE_FLEET_JOURNAL_ROTATE_BYTES", "VESCALE_FLEET_JOURNAL_SNAPSHOT_EVERY",
    "VESCALE_FLEET_LEASE_PATH", "VESCALE_FLEET_LEASE_TTL_S",
    "VESCALE_AUTOSCALE_MIN", "VESCALE_AUTOSCALE_MAX", "VESCALE_AUTOSCALE_TICK_S",
    "VESCALE_AUTOSCALE_WINDOW_S", "VESCALE_AUTOSCALE_UP_QUEUE", "VESCALE_AUTOSCALE_UP_BURN",
    "VESCALE_AUTOSCALE_UP_HOLD_S", "VESCALE_AUTOSCALE_DOWN_BURN",
    "VESCALE_AUTOSCALE_DOWN_HOLD_S", "VESCALE_AUTOSCALE_COOLDOWN_S",
)


@pytest.fixture(autouse=True)
def _dormant():
    reset_all()
    yield
    reset_all()


class _Clock:
    """A wall clock that ticks 1 ms a read: ``time.time`` for code that
    reads it directly."""

    def __init__(self, t0=1000.0):
        self.t = t0

    def time(self):
        self.t += 0.001
        return self.t

    def perf_counter(self):
        return self.time()

    def monotonic(self):
        return self.time()


# ------------------------------------------------------------------ knobs
@pytest.mark.parametrize("name", FLEET_KNOBS)
def test_fleet_and_autoscale_knobs_have_the_reference_defaults(name):
    assert config.DEFAULTS[name] == envreg.lookup(name).default


# ------------------------------------------------------------- autoscaler
class _Spec:
    def __init__(self, rid, port):
        self.replica_id, self.port, self.url = rid, port, f"http://127.0.0.1:{port}"


class _FakeSupervisor:
    """spawn_like / drain / alive: a drained replica's process is gone two
    ``alive`` calls later."""

    def __init__(self, template):
        self.managed = {template: object()}
        self.drained = []
        self._gone_in = {}
        self.calls = []

    def spawn_like(self, template_id):
        rid = f"{template_id}-s{len(self.managed) - 1}"
        self.managed[rid] = object()
        self.calls.append(("spawn_like", template_id, rid))
        return _Spec(rid, 20000 + len(self.managed))

    def drain(self, rid):
        self.drained.append(rid)
        self._gone_in[rid] = 2
        self.calls.append(("drain", rid))

    def alive(self, rid):
        if rid in self._gone_in:
            self._gone_in[rid] -= 1
            return self._gone_in[rid] > 0
        return rid in self.managed


def _signal_trace(seed=0, n=80):
    """Per tick (0.25 s apart): every replica's queue depth and p99 TTFT:
    quiet, a spike, then quiet again."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        spike = 12 <= i < 30
        out.append((int(rng.integers(5, 12)) if spike else int(rng.integers(0, 2) * (i < 40)),
                    float(rng.uniform(0.6, 1.2)) if spike else float(rng.uniform(0.02, 0.2))))
    return out


def _run_autoscaler(pkg, trace):
    t = [0.0]
    log = []
    reps = {"r0": F.FakeReplica(pkg, "r0", log)}
    fr = F.make_router(pkg, list(reps.values()), t)
    fr.obs.slo_ttft_s = 0.5
    sup = _FakeSupervisor("r0")

    def client_factory(spec):
        reps[spec.replica_id] = F.FakeReplica(pkg, spec.replica_id, log)
        return reps[spec.replica_id]

    a = PKG[pkg]["autoscale"].Autoscaler(
        fr, sup, "r0", client_factory=client_factory, min_replicas=1, max_replicas=3,
        up_burn=1.0, down_burn=0.5, up_queue=4, up_hold_s=0.5, down_hold_s=1.5,
        cooldown_s=1.0, window_s=3.0, tick_s=0.25, now_fn=lambda: t[0])
    decisions, states = [], []
    for i, (queue, p99) in enumerate(trace):
        t[0] = 0.25 * i
        for r in reps.values():
            r.feed_kw.update(queue=queue, p99=p99)
        fr.poll(force=True)
        decisions.append(a.tick())
        if i % 10 == 0:
            states.append(fr.obs.fleet()["autoscale"])
    snap = a.snapshot_state()
    b = PKG[pkg]["autoscale"].Autoscaler(fr, _FakeSupervisor("r0"), "r0", now_fn=lambda: t[0] + 1)
    b.restore_state(snap)
    return dict(decisions=decisions, states=states, calls=sup.calls, snap=snap,
                restored=b.snapshot_state(), replicas=sorted(fr.replicas))


def test_autoscaler_decides_as_the_reference_on_a_fed_signal_trace():
    """The store is dormant, so both read the instantaneous rollup: the
    worst replica's p99 over the SLO, and the summed queue depth."""
    trace = _signal_trace()
    port, ref = _run_autoscaler("port", trace), _run_autoscaler("ref", trace)
    assert port == ref
    d = port["decisions"]
    assert any(x.startswith("scale_up") for x in d) and any(x.startswith("scale_down") for x in d)
    assert {"holding_up", "holding_down", "cooldown"} <= set(d)


# --------------------------------------------------------------- rollout
class _ControlReplica(F.FakeReplica):
    """A replica's ``/control`` reload machine, scripted: busy once, then
    committed with canary streams, or rolled back while a divergence is
    armed."""

    def __init__(self, pkg, rid, log, diverge=0, busy=1):
        super().__init__(pkg, rid, log)
        self.diverge, self.busy, self.state = diverge, busy, None

    def control(self, payload):
        self.controls.append(copy.deepcopy(payload))
        op = payload.get("op")
        if op == "status":
            return {"ok": True, "rollout": self.state}
        if self.busy:
            self.busy -= 1
            return {"ok": False, "error": "busy"}
        if op == "reload":
            streams = [[(sum(p) + k) % 50 for k in range(payload["max_new_tokens"])]
                       for p in payload["prompts"]]
            if self.diverge:
                self.diverge -= 1
                self.state = {"state": "rolled_back", "checkpoint": payload["checkpoint"],
                              "detail": {"reason": "canary replay not deterministic"}}
            else:
                self.state = {"state": "committed", "checkpoint": payload["checkpoint"],
                              "detail": {"streams": streams, "finalized": False}}
        elif op == "commit":
            self.state = {"state": "committed", "checkpoint": None, "detail": {"finalized": True}}
        elif op == "revert":
            self.state = {"state": "rolled_back", "checkpoint": None, "detail": {"reverted": True}}
        return {"ok": True, "accepted": op}


def _run_rollout(pkg, diverge_on):
    t = [0.0]
    log = []
    reps = [_ControlReplica(pkg, r, log, diverge=int(r == diverge_on)) for r in ("r0", "r1", "r2")]
    fr = F.make_router(pkg, reps, t)
    ctl = PKG[pkg]["autoscale"].RolloutController(
        fr, "/ckpt/step7", [[1, 2, 3], [4, 5]], max_new_tokens=3, canary=True, baseline=True,
        stage_timeout_s=5.0, poll_slice_s=0.05, now_fn=lambda: t[0],
        sleep_fn=lambda s: t.__setitem__(0, t[0] + s))
    res = ctl.run()
    calls = [(r.id, c) for r in reps for c in r.controls]
    fr.rollout_state = {"checkpoint": "/ckpt/step8", "committed": ["r0", "r2"],
                        "in_progress": "r1"}
    for r in reps:
        r.controls.clear()
    resumed = PKG[pkg]["autoscale"].RolloutController.resume_revert(
        fr, now_fn=lambda: t[0], sleep_fn=lambda s: t.__setitem__(0, t[0] + s),
        poll_slice_s=0.05)
    return dict(result=res, calls=calls, resumed=resumed,
                resume_calls=[(r.id, c) for r in reps for c in r.controls])


@pytest.mark.parametrize("diverge_on", [None, "r0", "r1"])
def test_rollout_controller_matches_the_reference(diverge_on):
    port, ref = _run_rollout("port", diverge_on), _run_rollout("ref", diverge_on)
    assert port == ref
    res = port["result"]
    assert res["ok"] is (diverge_on is None)
    if diverge_on is None:
        assert res["committed"] == ["r0", "r1", "r2"]
    else:
        assert res["diverged"] == diverge_on and res["committed"] == []
        assert "deterministic" in res["reason"]
    assert port["resumed"]["rolled_back"] == ["r1", "r2", "r0"]


# -------------------------------------------------------- observability
def _masked_fleet(feed):
    out = json.loads(json.dumps(feed, sort_keys=True))
    out["uptime_s"] = None
    for t in out["breaker_transitions"]:
        t["ts"] = None
    return out


def test_fleet_feed_health_and_gauges_match_the_reference(monkeypatch):
    monkeypatch.setenv("VESCALE_SERVE_SLO_TTFT_S", "0.25")
    for mod in (ref_tel, tel):
        mod.init(out_dir=None, jsonl=False, memtrack=False, timeseries=False, alerts=True,
                 costaudit=False)
    feeds, healths, gauges = {}, {}, {}
    for pkg in ("ref", "port"):
        fr, reps, _ = F.run_scenario(pkg)
        rng = np.random.default_rng(2)
        for r in reps.values():
            r.alive = True
            r.feed_kw.update(queue=int(rng.integers(0, 5)), p99=float(rng.uniform(0.1, 0.5)),
                             tput=float(rng.uniform(10, 100)), mfu=float(rng.uniform(0, 0.5)))
        fr.poll(force=True)
        feed = fr.obs.fleet()
        feeds[pkg] = _masked_fleet(feed)
        assert set(feed) == ref_obs.FLEET_FIELDS and feed["schema_version"] == 5
        assert all(set(row) == ref_obs.FLEET_REPLICA_FIELDS for row in feed["replicas"].values())
        h = fr.obs.health()
        h["uptime_s"] = h["wall_time_us"] = None
        healths[pkg] = h
        fr.obs.publish()
        reg = PKG[pkg]["tel"].get_registry()
        gauges[pkg] = {k: v for k, v in reg.snapshot()["gauges"].items()
                       if k.startswith("fleet_")}
    assert feeds["port"] == feeds["ref"]
    assert healths["port"] == healths["ref"]
    assert gauges["port"] == gauges["ref"]
    assert feeds["port"]["slo_burn_rate"] is not None and gauges["port"]["fleet_timeline_mfu"] > 0
    for name in ("FLEET_FIELDS", "FLEET_FIELDS_V2", "FLEET_FIELDS_V3", "FLEET_FIELDS_V4",
                 "FLEET_REPLICA_FIELDS", "FLEET_REPLICA_FIELDS_V1", "FLEET_REPLICA_FIELDS_V2",
                 "FLEET_SCHEMA_VERSION"):
        assert getattr(port_obs, name) == getattr(ref_obs, name), name


def _rules(pack):
    return [(type(r).__name__, {k: v for k, v in sorted(vars(r).items()) if not callable(v)})
            for r in pack]


@pytest.mark.parametrize("slo", [None, 0.0, 0.4])
@pytest.mark.parametrize("windows", [None, ((60.0, 5.0, 14.4),)])
def test_fleet_rule_pack_matches_the_reference(slo, windows):
    assert _rules(alerts.fleet_rule_pack(slo_ttft_s=slo, burn_windows=windows)) == \
        _rules(ref_alerts.fleet_rule_pack(slo_ttft_s=slo, burn_windows=windows))


# ---------------------------------------------------------- clock offsets
class _HealthClient:
    def __init__(self, walls, fail=False):
        self.walls, self.fail, self.i = walls, fail, 0

    def poll_health(self):
        if self.fail:
            raise OSError("down")
        self.i += 1
        return {"ok": True} if self.walls is None else {"wall_time_us": self.walls[self.i - 1]}


@pytest.mark.parametrize("rounds", [1, 8])
def test_fleet_clock_offsets_match_the_reference(rounds, monkeypatch):
    rng = np.random.default_rng(rounds)
    walls = {f"r{i}": [float(x) for x in 1e9 + rng.normal(i * 5e3, 40.0, rounds)]
             for i in range(3)}
    got = {}
    for pkg in ("ref", "port"):
        monkeypatch.setattr(PKG[pkg]["ft"], "time", _Clock())
        clients = {rid: _HealthClient(w) for rid, w in walls.items()}
        clients["dead"] = _HealthClient(None, fail=True)
        clients["old"] = _HealthClient(None)
        got[pkg] = PKG[pkg]["ft"].estimate_fleet_clock_offsets(clients, rounds=rounds).as_dict()
    assert got["port"] == got["ref"]
    assert set(got["port"]["offsets_us"]) == set(walls)
    assert got["port"]["residual_us"]["dead"] == -1.0
    sync = port_ft.FleetClockSync.from_dict(got["port"])
    assert sync.offset_s("r1") == got["port"]["offsets_us"]["r1"] / 1e6 and sync.offset_s("x") == 0


# ------------------------------------------------------ journey verification
def _traced_scenario(pkg):
    PKG[pkg]["nd"].api.init_ndtimers(rank=0)
    fr, reps, log = F.run_scenario(pkg)
    spans = PKG[pkg]["nd"].api.flush()
    return fr, spans, log


def _tampered(spans, Span_):
    """Drop one rid's terminal, duplicate another's, drop a dispatch of a
    third and add an orphan journey."""
    out = list(spans)
    term = [s for s in out if s.metric == "fleet-terminal"]
    out.remove(term[0])
    out.append(term[1])
    disp = [s for s in out if s.metric == "fleet-dispatch-attempt" and s.tags.get("ok", True)]
    out.remove(disp[-1])
    out.append(Span_("fleet-submit", term[2].start, 0.0, 0, 0, {"rid": 777}))
    return out


def test_fleet_journeys_verify_as_the_reference():
    got = {}
    for pkg in ("ref", "port"):
        fr, spans, log = _traced_scenario(pkg)
        ft = PKG[pkg]["ft"]
        Span_ = PKG[pkg]["Span"]
        stream = [s for s in spans if s.metric.startswith("fleet-")]
        # the replicas' serve-submit spans echo the placed tags
        replica = [Span_("serve-submit", s.start + 1e-6, 0.0, 0, 0, {"rid": s.tags["rid"],
                                                                     "tag": s.tags["tag"]})
                   for s in stream if s.metric == "fleet-dispatch-attempt" and s.tags["ok"]]
        merged = ft.assemble_fleet_timeline({"router": stream, "a": replica})
        got[pkg] = dict(
            clean=ft.verify_fleet_journeys(merged, fr.ledger, require_stitch=True),
            tampered=ft.verify_fleet_journeys(_tampered(stream, Span_), fr.ledger),
            unstitched=ft.verify_fleet_journeys(stream, fr.ledger, require_stitch=True),
            superseded={r: sorted(ft.superseded_rids(fr.ledger, r)) for r in ("a", "b", "c")},
            metrics=sorted({s.metric for s in stream}),
            flows=sorted(str(s.tags.get("flow_id")) for s in merged if s.tags
                         and "flow_id" in s.tags),
            names=ft.fleet_process_names({"router": stream, "a": replica}))
    assert got["port"] == got["ref"]
    assert got["port"]["clean"] == [] and len(got["port"]["tampered"]) >= 4
    assert got["port"]["unstitched"] and any(got["port"]["superseded"].values())
    assert any(f.startswith("['fleet") or f.startswith("disp") for f in got["port"]["flows"])


def test_fleet_span_emitters_match_the_reference(monkeypatch):
    tags = {}
    for pkg in ("ref", "port"):
        ft = PKG[pkg]["ft"]
        monkeypatch.setattr(ft, "time", _Clock())
        PKG[pkg]["nd"].api.init_ndtimers(rank=0)
        ft.scale_event("up", "r0-s0", "burn=2", 0.5)
        ft.rollout_stage("r0", "swap", 0.25, ok=False, reason="x", checkpoint="/c")
        ft.recover_event(0.1, epoch=2, records=9, quarantined=1, pending=3, harvested=2,
                         redriven=1)
        ft.takeover_event(0.2, epoch=2, reason="lease_expired")
        ft.backoff(5, 0.05, "no eligible replica")
        spans = PKG[pkg]["nd"].api.flush()
        PKG[pkg]["nd"].api.deinit_ndtimers()
        tags[pkg] = [(s.metric, round(s.duration, 9), s.tags) for s in spans]
    assert tags["port"] == tags["ref"]
    assert [m for m, _, _ in tags["port"]] == ["fleet-scale", "fleet-rollout-stage",
                                               "fleet-recover", "fleet-takeover", "fleet-backoff"]
