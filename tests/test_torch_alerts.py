"""The port's time-series store and alert engine against the JAX package's,
on the CPU, with the clock injected.

The same registry values, sampled at the same injected times into both
packages' stores, give the same windows and reductions (every reducer, at
spans that each tier answers).  Both engines evaluate the same rules over
those stores at the same injected times: every lifecycle transition (ok ->
pending -> firing -> ok, burn-rate windows, trends, z-scores, manual
raise/resolve), the history ring, the counters, ``payload`` (but for its
wall-clock ages) and ``digest`` are exactly equal, and so are the spans an
active ndtimeline records for them.  The serve and train rule packs are the
reference's.
"""

import warnings

import pytest

from vescale_tpu import ndtimeline as ref_nd
from vescale_tpu.telemetry import alerts as ref_alerts
from vescale_tpu.telemetry import timeseries as ref_ts
from vescale_tpu.telemetry.registry import MetricsRegistry as RefRegistry

from vescale_tpu_torch import ndtimeline as nd
from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.telemetry import alerts, memtrack, timeseries
from vescale_tpu_torch.telemetry.registry import MetricsRegistry

from test_torch_ndtimeline import all_dormant, reset_all

T0 = 1_000_000.0
PKGS = ((ref_alerts, ref_ts, RefRegistry, ref_nd), (alerts, timeseries, MetricsRegistry, nd))


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()
    assert all_dormant()


def _drive_registry(reg, i):
    """Sample i's values: a counter, a sawtooth gauge, a spike and a
    histogram whose tail grows."""
    reg.counter("req_total").inc(3 + i % 4)
    reg.gauge("queue_depth").set(float(i % 7) + (0.5 * i if i > 40 else 0.0))
    reg.gauge("loss").set(2.0 - 0.001 * i + (9.0 if i == 60 else 0.0))
    reg.gauge("ttft_p99").set(0.2 if i < 30 or i > 70 else 2.5)
    for j in range(3):
        reg.histogram("lat").observe(0.01 * (j + 1) + 0.0001 * i)


def _store_pair(n=90, cadence=1.0, dt=0.5):
    stores = []
    for _, ts, Reg, _ in PKGS:
        reg = Reg(default_window=64)
        store = ts.TimeSeriesStore(reg, cadence_s=cadence, base_len=16, tier_factor=4, tiers=3)
        taken = []
        for i in range(n):
            _drive_registry(reg, i)
            taken.append(store.sample(now=T0 + i * dt))
        stores.append((store, taken))
    return stores


def test_store_windows_and_every_reducer_equal_the_reference():
    (ref, ref_taken), (got, taken) = _store_pair()
    assert taken == ref_taken and sum(taken) == 45
    assert got.names() == ref.names()
    assert got.stats() == ref.stats()
    now = T0 + 90 * 0.5
    reducers = list(timeseries.REDUCERS) + ["p50", "p90", "p99"]
    assert reducers[:len(ref_ts.REDUCERS)] == list(ref_ts.REDUCERS)
    for name in ref.names():
        for span in (2.0, 9.0, 30.0, 200.0, 5000.0):
            assert got.window(name, span, now=now) == ref.window(name, span, now=now)
            for r in reducers:
                assert got.reduce(name, span, r, now=now) == ref.reduce(name, span, r, now=now), \
                    (name, span, r)
        for k in range(3):
            assert got.series(name).tiers[k].items() == ref.series(name).tiers[k].items()
    with pytest.raises(ValueError):
        timeseries.TimeSeriesStore(MetricsRegistry(), base_len=1)


def _rules(mod):
    return [
        mod.ThresholdRule("depth-high", "queue_depth", ">", 5.0, window_s=4.0, reducer="avg",
                          for_s=2.0, resolve_for_s=1.0, severity="warning", message="deep"),
        mod.BurnRateRule("ttft-burn", "ttft_p99", 1.0, windows=((20.0, 4.0, 1.5),), for_s=0.0),
        mod.TrendRule("depth-trend", "queue_depth", slope_per_s=0.3, window_s=10.0,
                      direction="up", min_samples=4),
        mod.ZScoreRule("loss-spike", "loss", z=4.0, window_s=30.0, min_samples=8,
                       direction="up", severity="critical"),
        mod.ThresholdRule("req-rate", "req_total", ">", 8.0, window_s=4.0, reducer="rate"),
    ]


def _drop_clock(payload):
    """``payload`` without its wall-clock ages (``since_s``, ``uptime_s``,
    manual transitions' ``ts``)."""
    out = dict(payload, uptime_s=None)
    out["rules"] = {k: dict(v, since_s=None) for k, v in payload["rules"].items()}
    out["history"] = [dict(h, ts=h["ts"] if h["kind"] != "manual" else None)
                      for h in payload["history"]]
    return out


def _state(name, st):
    """A rule's lifecycle state without wall-clock stamps (manual rules
    transition at ``time.time()``, evaluated ones at the injected now)."""
    clock = ("fired_at",) if name.startswith("manual-") else ()
    return {k: v for k, v in st.items() if "since" not in k and k not in clock}


def test_every_transition_payload_digest_and_spans_equal_the_reference():
    results = []
    for al, ts, Reg, ndpkg in PKGS:
        reg = Reg(default_window=64)
        store = ts.TimeSeriesStore(reg, cadence_s=0.0, base_len=64, tier_factor=4, tiers=2)
        eng = al.AlertEngine(store=store, history=32)
        for r in _rules(al):
            eng.add_rule(r)
        assert eng.arm_pack("extra", [al.ManualRule("manual-x", severity="info")])
        assert not eng.arm_pack("extra", [])
        mgr = ndpkg.init_ndtimers(rank=2)
        transitions = []
        for i in range(90):
            _drive_registry(reg, i)
            now = T0 + i * 0.5
            store.sample(now=now)
            mgr.record("train-step", now, 0.1)
            mgr.inc_step()
            transitions.append(eng.evaluate(now=now))
            if i == 20:
                eng.raise_alert("manual-x", message="by hand", value=3.0)
                eng.raise_alert("manual-y", message="new rule", severity="critical")
            if i == 50:
                eng.resolve("manual-x")
                eng.resolve("unknown")
        snap = eng.snapshot()
        spans = [(s.metric, s.duration if s.tags["transition"] != "firing->ok" else None, s.step,
                  s.rank, {k: v for k, v in s.tags.items()})
                 for s in mgr.tail(1000) if s.metric == "alert"]
        results.append((transitions, _drop_clock(snap), eng.firing(), eng.pending(),
                        dict(eng.counts), spans, {n: _state(n, eng.state_of(n)) for n in eng.rules}))
        ndpkg.api.deinit_ndtimers()
    ref, got = results
    for a, b in zip(got, ref):
        assert a == b
    fired = {h["rule"] for h in got[1]["history"] if h["to"] == "firing"}
    assert fired >= {"depth-high", "ttft-burn", "depth-trend", "loss-spike", "manual-x",
                     "manual-y"}, fired
    kinds = {(h["from"], h["to"]) for h in got[1]["history"]}
    assert {("ok", "pending"), ("pending", "firing"), ("firing", "ok"), ("ok", "firing")} <= kinds
    assert any(s[0] == "alert" and s[4]["transition"] == "firing->ok" for s in got[5])


def test_module_payload_digest_and_dormant_fallback():
    assert alerts.evaluate is alerts._noop_evaluate
    assert alerts.raise_alert is alerts._fallback_raise_alert
    assert alerts.resolve is alerts._noop_resolve
    assert _drop_clock(alerts.payload()) == _drop_clock(ref_alerts.payload())
    assert alerts.digest() == ref_alerts.digest() == {"active": False, "firing": [], "pending": []}
    with pytest.warns(UserWarning, match=r"\[alert:w1\] once"):
        alerts.raise_alert("w1", message="once")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        alerts.raise_alert("w1", message="once")  # latched: no second warning
    tel.init(out_dir=None, memtrack=False, costaudit=False)
    assert alerts.evaluate == alerts.get_engine().evaluate
    alerts.raise_alert("w1", message="live")
    assert alerts.digest() == {"active": True, "firing": ["w1"], "pending": []}
    assert tel.get_registry().counter("alerts_fired_total").value == 1
    alerts.resolve("w1")
    assert alerts.payload()["counts"]["resolved"] == 1
    tel.shutdown()
    assert not alerts.is_active() and timeseries.sample is timeseries._noop_sample


def test_rule_packs_equal_the_reference(monkeypatch):
    def rows(rules):
        return [(type(r).__name__, {k: v for k, v in vars(r).items()}) for r in rules]

    assert rows(alerts.train_rule_pack()) == rows(ref_alerts.train_rule_pack())
    assert rows(alerts.serve_rule_pack()) == rows(ref_alerts.serve_rule_pack())
    monkeypatch.setenv("VESCALE_ALERTS_BURN_WINDOWS", "600:60:10,3600:300:5")
    monkeypatch.setenv("VESCALE_ALERTS_BURN_FOR_S", "2.5")
    assert alerts.burn_windows_from_env() == ref_alerts.burn_windows_from_env()
    assert rows(alerts.serve_rule_pack(slo_ttft_s=0.5)) == \
        rows(ref_alerts.serve_rule_pack(slo_ttft_s=0.5))
    monkeypatch.setenv("VESCALE_ALERTS_BURN_WINDOWS", "bad")
    with pytest.raises(ValueError):
        alerts.burn_windows_from_env()
    # the fleet pack is ported with the fleet router; the bench pack's gauge
    # is one only the JAX package's bench sets
    monkeypatch.delenv("VESCALE_ALERTS_BURN_WINDOWS")
    assert rows(alerts.fleet_rule_pack()) == rows(ref_alerts.fleet_rule_pack())
    assert rows(alerts.fleet_rule_pack(slo_ttft_s=0.5)) == \
        rows(ref_alerts.fleet_rule_pack(slo_ttft_s=0.5))
    assert not hasattr(alerts, "bench_rule_pack")


def test_leak_watcher_fires_the_mem_leak_alert_on_a_live_engine():
    import gc

    import torch

    gc.collect()
    tel.init(out_dir=None, memtrack_leak_steps=3, timeseries=False, costaudit=False)
    hoard = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the live engine takes it: no warning
        for i in range(1, 6):
            hoard.append(torch.ones(65536 * i) + i)
            tel.record_step({"step": i, "step_time_s": 0.01})
    assert "mem-leak" in alerts.digest()["firing"]
    assert memtrack.get_tracker() is not None
    hoard.clear()
    gc.collect()
    tel.record_step({"step": 9, "step_time_s": 0.01})
    assert "mem-leak" not in alerts.digest()["firing"]


def test_train_step_arms_the_train_pack():
    import torch

    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import make_train_step

    tel.init(out_dir=None, memtrack=False, costaudit=False)
    lin = torch.nn.Linear(4, 2)
    step = make_train_step(lin, AdamWLowmem(lin.parameters(), 1e-3),
                           lambda out, b: out.pow(2).mean())
    step({"input": torch.ones(3, 4)})
    names = set(alerts.get_engine().rules)
    assert {r.name for r in alerts.train_rule_pack()} <= names
    assert tel.get_registry().gauge("train_grad_norm").value > 0
