"""The port's request traces against the JAX package's, on the CPU.

The same flax-initialised tiny Llama serves the same arrivals through both
packages' ``run_serve_resilient`` (the reference's XLA decode at
``VESCALE_KERNELS=off``, the port's plain versions on the CPU), with
ndtimeline active in both and the fault kinds of
``tests/test_torch_serve_resilient.py`` armed, and with speculation.  Every
request's span chain (metric, rid, slot, tags and order; not the
durations), the ndtimeline step of each span and the per-step spans
(decode step, draft, verify) are exactly the reference's, and
``verify_request_chains`` passes on both.  Then the loop's other
observability: the ``/router`` and ``/healthz`` feeds' live alert digest,
the ``/alerts`` endpoint, the fleet trace stream, the calibrated step
estimate and the speculative depth a calibration table suggests.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vescale_tpu import ndtimeline as ref_nd
from vescale_tpu import serve as jserve
from vescale_tpu.mesh import DeviceMesh
from vescale_tpu.models.llama import Llama
from vescale_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from vescale_tpu.resilience import faultsim as jfs
from vescale_tpu.serve import reqtrace as ref_rt

from vescale_tpu_torch import ndtimeline as nd
from vescale_tpu_torch import serve as tserve
from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.models import LlamaConfig, params_from_jax
from vescale_tpu_torch.ndtimeline.parser_handler import parse_raw_spans
from vescale_tpu_torch.resilience import faultsim as tfs
from vescale_tpu_torch.serve import reqtrace as rt
from vescale_tpu_torch.serve.speculative import slice_drafter_params
from vescale_tpu_torch.telemetry import alerts, calibrate, ops_server

from test_torch_ndtimeline import all_dormant, reset_all

SHAPE = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64)
CACHE = dict(num_slots=2, page_size=4, pages_per_slot=4)
SCHEDULES = {
    "quiet": None,
    "battery": "request_timeout:step=6;slow_decode:step=3,count=2;oom:step=4;preempt:step=9",
    "oom_twice": "oom:step=3;oom:step=7",
    "timeouts": "request_timeout:step=4;request_timeout:step=8",
}


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    jfs.disarm()
    tfs.disarm()
    srv = ops_server.active_server()
    if srv is not None:
        srv.stop()
    reset_all()
    assert all_dormant()


@pytest.fixture(scope="module")
def rigs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VESCALE_KERNELS", "off")
        jcfg = JaxLlamaConfig(dtype=jnp.float32, **SHAPE)
        params = Llama(jcfg).init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        mesh = DeviceMesh(("tp",), (1,), devices=jax.devices()[:1])
        jkc = jserve.KVCacheConfig(layers=jcfg.num_hidden_layers, kv_heads=jcfg.num_key_value_heads,
                                   head_dim=jcfg.head_dim, **CACHE)
        jcache = jserve.PagedKVCache(jkc, mesh)
        jeng = jserve.ServeEngine(jcfg, mesh, params, jcache)
        tcfg = LlamaConfig(dtype=torch.float32, **SHAPE)
        tkc = tserve.KVCacheConfig(layers=tcfg.num_hidden_layers, kv_heads=tcfg.num_key_value_heads,
                                   head_dim=tcfg.head_dim, **CACHE)
        tcache = tserve.PagedKVCache(tkc, device="cpu")
        teng = tserve.ServeEngine(tcfg, params_from_jax(params, device="cpu"), tcache, device="cpu")
        yield params, jeng, jcache, teng, tcache


def _arrivals(ns, n=5):
    rng = np.random.default_rng(3)
    return [(2 * i, ns.Request(rid=i, prompt=tuple(int(x) for x in rng.integers(1, 60, 3 + i % 2)),
                               max_new_tokens=4, deadline_steps=50)) for i in range(n)]


def _traced_run(rigs, schedule, k=None):
    params, jeng, jcache, teng, tcache = rigs
    out = []
    for pkg, fs, ndpkg, eng, cache in ((jserve, jfs, ref_nd, jeng, jcache),
                                       (tserve, tfs, nd, teng, tcache)):
        cache.reset()
        sched = pkg.ContinuousBatchingScheduler(cache, max_queue=8)
        spec = None
        if k is not None:
            dparams = (jserve.slice_drafter_params(params, 1) if pkg is jserve
                       else slice_drafter_params(eng.params, 1))
            spec = pkg.SpeculativeDecoder(eng, dparams, drafter_layers=1, k=k)
        mgr = ndpkg.init_ndtimers()
        if schedule:
            fs.arm(fs.parse_schedule(schedule))
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("VESCALE_KERNELS", "off")
                res = pkg.run_serve_resilient(engine=eng, scheduler=sched, arrivals=_arrivals(pkg),
                                              install_signal_handlers=False, coordinate=False,
                                              speculative=spec)
        finally:
            fs.disarm()
        spans = mgr.tail(100_000)
        ndpkg.api.deinit_ndtimers()
        out.append((res, spans))
    return out


def _chains(mod, spans):
    """Each rid's spans in emission order, and the module's own grouping."""
    out = {}
    for s in spans:
        if (s.tags or {}).get("rid") is not None:
            out.setdefault(int(s.tags["rid"]), []).append((s.metric, s.step, s.tags))
    grouped = {rid: {m: len(v) for m, v in chain.items()}
               for rid, chain in mod.request_spans(spans).items()}
    return out, grouped


def _step_spans(spans):
    return [(s.metric, s.step, s.tags) for s in spans if (s.tags or {}).get("rid") is None]


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_span_chains_under_faults_equal_the_reference(rigs, schedule):
    (jres, jspans), (tres, tspans) = _traced_run(rigs, SCHEDULES[schedule])
    assert {r: o["status"] for r, o in tres.outcomes.items()} == \
        {r: o["status"] for r, o in jres.outcomes.items()}
    assert _chains(rt, tspans) == _chains(ref_rt, jspans)
    assert _step_spans(tspans) == _step_spans(jspans)
    assert rt.verify_request_chains(tspans, tres.outcomes) == []
    assert ref_rt.verify_request_chains(jspans, jres.outcomes) == []
    assert rt.classify_chains(tspans, tres.outcomes) == ref_rt.classify_chains(jspans, jres.outcomes)
    assert {s.metric for s in tspans} <= rt.SERVE_SPAN_METRICS


def test_span_chains_with_speculation_equal_the_reference(rigs):
    (jres, jspans), (tres, tspans) = _traced_run(rigs, None, k=2)
    assert _chains(rt, tspans) == _chains(ref_rt, jspans)
    assert _step_spans(tspans) == _step_spans(jspans)
    metrics = {s.metric for s in tspans}
    assert {"serve-draft", "serve-verify"} <= metrics
    assert rt.verify_request_chains(tspans, tres.outcomes) == []


def test_dormant_tracing_records_nothing(rigs):
    _, _, _, teng, tcache = rigs
    tcache.reset()
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    tserve.run_serve(teng, sched, _arrivals(tserve))
    assert not nd.api.is_active() and nd.api.get_manager().tail() == []
    rt.submit(1, 0)
    assert nd.api.get_manager().tail() == []


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def test_router_healthz_and_alerts_endpoints_carry_the_live_engine(rigs, monkeypatch, tmp_path):
    _, _, _, teng, tcache = rigs
    tel.init(out_dir=None, memtrack=False)
    tcache.reset()
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    obs = tserve.ServeObservability(sched, engine=teng)
    assert obs.router()["alerts"] == {"active": True, "firing": [], "pending": []}
    alerts.raise_alert("by-hand", message="x")
    assert obs.health()["alerts"]["firing"] == ["by-hand"]
    monkeypatch.setenv("VESCALE_SERVE_OPS_PORT", "0")
    monkeypatch.setenv("VESCALE_FLEET_TRACE_DIR", str(tmp_path / "fleet"))
    monkeypatch.setenv("VESCALE_SERVE_REPLICA_ID", "r7")
    seen = {}

    def on_step(step, active):
        srv = ops_server.active_server()
        if step == 3 and srv is not None:
            seen["alerts"] = _get(srv.url + "/alerts")
            seen["router"] = _get(srv.url + "/router")

    res = tserve.run_serve_resilient(engine=teng, scheduler=sched, arrivals=_arrivals(tserve),
                                     install_signal_handlers=False, coordinate=False,
                                     on_step=on_step)
    assert res.status == "completed"
    assert seen["alerts"]["active"] and "by-hand" in seen["alerts"]["firing"]
    # (the cost auditor's drift rule may fire too: the first prefill seeds
    # the decode-step estimate it ledgers)
    assert seen["router"]["alerts"]["active"] and "by-hand" in seen["router"]["alerts"]["firing"]
    assert {r.name for r in alerts.serve_rule_pack()} <= set(alerts.get_engine().rules)
    lines = (tmp_path / "fleet" / "r7.spans.jsonl").read_text().splitlines()
    spans = parse_raw_spans(str(tmp_path / "fleet" / "r7.spans.jsonl"))
    assert len(spans) == len(lines) > 0
    assert rt.verify_request_chains(spans, res.outcomes) == []
    assert not nd.api.is_active()  # the loop owned it and put it back


def test_calibrated_step_estimate_and_suggested_depth(rigs):
    _, _, _, teng, tcache = rigs
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    obs = tserve.ServeObservability(sched, engine=teng)
    assert obs.calibrated_step_estimate() is None
    t = calibrate.CalibrationTable(meta={"platform": "cpu", "matmul_gflops": 2.0})
    calibrate.set_active(t)
    flops = teng.decode_flops_per_step()
    assert obs.calibrated_step_estimate() == flops / 2e9
    t.add_sample("serve_decode", 2, 2, 0.0012)
    t.add_sample("serve_draft", 2, 2, 0.0006)  # k = 2: 0.2 ms a drafter launch
    assert obs.calibrated_step_estimate() == pytest.approx(0.0012)
    assert tserve.suggested_k() == 2
    spec = tserve.SpeculativeDecoder(teng, slice_drafter_params(teng.params, 1), drafter_layers=1,
                                     k=0)
    assert spec.k == 2
