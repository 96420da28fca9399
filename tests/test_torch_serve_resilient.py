"""The port's resilient serve loop against the JAX package's, on the CPU.

The same flax-initialised tiny Llama goes through
``vescale_tpu.serve.run_serve_resilient`` (the reference, its XLA decode at
``VESCALE_KERNELS=off``) and ``vescale_tpu_torch.serve.run_serve_resilient``
(plain PyTorch on the CPU), with the same faultsim schedule armed in both
packages.  Held to the reference's contract: the outcomes ledgers (status,
tokens, replays, reason), the counts, the steps and the scheduler
fingerprints exactly equal, case by case as in the reference's own loop
tests.  Then the legs the reference checks on its own: the watchdog's hang
dump, the coordination plane on faked rows, a two-rank gloo run, the
faultsim grammar and the ops endpoints.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vescale_tpu import serve as jserve
from vescale_tpu.mesh import DeviceMesh
from vescale_tpu.models.llama import Llama
from vescale_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from vescale_tpu.resilience import faultsim as jfs
from vescale_tpu.serve import obs as jobs
from vescale_tpu.testing import reserve_port

import vescale_tpu_torch.distributed as tdist
from vescale_tpu_torch import serve as tserve
from vescale_tpu_torch.models import LlamaConfig, params_from_jax
from vescale_tpu_torch.resilience import DesyncError, Watchdog
from vescale_tpu_torch.resilience import faultsim as tfs
from vescale_tpu_torch.serve import loop as tloop
from vescale_tpu_torch.serve import obs as tobs
from vescale_tpu_torch.telemetry import ops_server as tops

import torch_serve_child as child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64)
CACHE = dict(num_slots=2, page_size=4, pages_per_slot=4)
# the reference's single-process battery (scripts/serve_smoke.py) and its
# two-rank schedule; the union of the latter fires every fault on one rank
BATTERY = "request_timeout:step=6;slow_decode:step=3,count=2;oom:step=4;preempt:step=9"
TWO_RANK = "oom:step=4,rank=0;request_timeout:step=5,rank=1;preempt:step=7,rank=0"
TWO_RANK_UNION = "oom:step=4;request_timeout:step=5;preempt:step=7"


@pytest.fixture(autouse=True)
def clean_envelope():
    """Every test leaves both faultsims disarmed and no ops server up."""
    yield
    jfs.disarm()
    tfs.disarm()
    srv = tops.active_server()
    if srv is not None:
        srv.stop()
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def rigs():
    """One engine per package on the same weights (caches reset per run)."""
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
        yield jeng, jcache, teng, tcache


def _arrivals(n=5, **kw):
    """The reference loop tests' load: request i at step 2*i."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        kw.setdefault("deadline_steps", 50)
        out.append((2 * i, dict(rid=i, prompt=tuple(int(x) for x in rng.integers(1, 60, 3 + i % 2)),
                                max_new_tokens=4, **kw)))
    return out


def _ledger(res):
    return {rid: (o["status"], list(o["tokens"]), o.get("replays"), o.get("reason"))
            for rid, o in res.outcomes.items()}


def _run_both(rigs, arrivals, schedule=None, max_queue=8, **kw):
    """The same arrivals and schedule through both loops; returns
    ((result, scheduler, fired) of the reference, the same of the port)."""
    jeng, jcache, teng, tcache = rigs
    out = []
    for pkg, fs, eng, cache in ((jserve, jfs, jeng, jcache), (tserve, tfs, teng, tcache)):
        cache.reset()
        sched = pkg.ContinuousBatchingScheduler(cache, max_queue=max_queue)
        inj = fs.arm(fs.parse_schedule(schedule)) if schedule else None
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("VESCALE_KERNELS", "off")
                res = pkg.run_serve_resilient(
                    engine=eng, scheduler=sched,
                    arrivals=[(s, pkg.Request(**r)) for s, r in arrivals],
                    install_signal_handlers=False, coordinate=False, **kw)
        finally:
            fired = {k: v for k, v in inj.fired_total.items() if v} if inj else {}
            fs.disarm()
        sched.ledger_check()
        out.append((res, sched, fired))
    return out


def _assert_same(ref, port):
    (jres, jsched, jfired), (tres, tsched, tfired) = ref, port
    assert _ledger(tres) == _ledger(jres)
    assert tres.counts == jres.counts
    assert (tres.status, tres.steps, tres.drained, tres.rejected_on_drain) == (
        jres.status, jres.steps, jres.drained, jres.rejected_on_drain)
    assert tfired == jfired
    assert tsched.fingerprint() == tuple(int(x) for x in jsched.fingerprint())


def _golden(rigs):
    return _run_both(rigs, _arrivals())[1][0]


def _check_complete(res, fired, golden):
    assert res.status == "completed"
    assert all(o["status"] == "completed" and len(o["tokens"]) == 4 for o in res.outcomes.values())


def _check_oom(res, fired, golden):
    assert res.status == "completed" and fired == {"oom": 1}
    assert res.counts["evicted"] == 1 and res.counts["requeued"] == 1
    # the evicted request replayed from its prompt and regenerated the SAME
    # tokens, on another slot and other pages
    for rid, o in res.outcomes.items():
        assert o["status"] == "completed" and o["tokens"] == golden.outcomes[rid]["tokens"], rid
    assert sum(o["replays"] == 1 for o in res.outcomes.values()) == 1


def _check_request_timeout(res, fired, golden):
    statuses = [o["status"] for o in res.outcomes.values()]
    assert statuses.count("timed_out") == 1 and res.counts["timed_out"] == 1
    timed = next(o for o in res.outcomes.values() if o["status"] == "timed_out")
    assert "request_timeout" in timed["reason"]


def _check_slow_decode(res, fired, golden):
    assert res.status == "completed" and fired == {"slow_decode": 2}
    for rid, o in res.outcomes.items():
        assert o["status"] == "completed" and o["tokens"] == golden.outcomes[rid]["tokens"]


def _check_step_deadline(res, fired, golden):
    assert res.outcomes[0]["status"] == "timed_out"
    assert 0 < len(res.outcomes[0]["tokens"]) < 4  # partial tokens kept


def _check_preempt(res, fired, golden):
    assert res.status == "preempted" and fired == {"preempt": 1}
    assert {o["status"] for o in res.outcomes.values()} <= {"completed", "preempted_requeue"}
    done = [o for o in res.outcomes.values() if o["status"] == "completed"]
    assert done and all(len(o["tokens"]) == 4 for o in done)
    assert res.drained >= 1  # the in-flight request decoded to completion


def _check_shed(res, fired, golden):
    shed = [o for o in res.outcomes.values() if o["status"] == "shed"]
    assert shed and all(o["retry_after_s"] > 0 for o in shed)
    assert sum(o["status"] == "completed" for o in res.outcomes.values()) == len(res.outcomes) - len(shed)


def _check_battery(res, fired, golden):
    assert res.status == "preempted"
    assert fired == {"request_timeout": 1, "slow_decode": 2, "oom": 1, "preempt": 1}
    assert res.counts["timed_out"] >= 1 and res.counts["evicted"] >= 1


def _check_union(res, fired, golden):
    assert res.status == "preempted" and fired == {"oom": 1, "request_timeout": 1, "preempt": 1}


# name -> (arrivals, schedule, max_queue, extra check); each mirrors a
# reference loop test (tests/test_serve.py) or its smoke's battery
CASES = {
    "complete": (_arrivals(), None, 8, _check_complete),
    "oom": (_arrivals(), "oom:step=3", 8, _check_oom),
    "request_timeout": (_arrivals(), "request_timeout:step=2", 8, _check_request_timeout),
    "slow_decode": (_arrivals(n=2), "slow_decode:step=1,count=2", 8, _check_slow_decode),
    "step_deadline": ([(0, dict(rid=0, prompt=(5, 9), max_new_tokens=4, deadline_steps=1))],
                      None, 8, _check_step_deadline),
    "preempt": (_arrivals(n=6), "preempt:step=3", 8, _check_preempt),
    "shed": ([(0, r) for _, r in _arrivals(n=6)], None, 2, _check_shed),
    "battery": (_arrivals(n=8), BATTERY, 8, _check_battery),
    "two_rank_union": (_arrivals(n=8), TWO_RANK_UNION, 8, _check_union),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_equals_the_reference_under_faults(rigs, case, monkeypatch):
    arrivals, schedule, max_queue, check = CASES[case]
    # slow_decode sleeps are recorded, not slept
    slept = []
    monkeypatch.setattr(tloop.time, "sleep", slept.append)
    ref, port = _run_both(rigs, arrivals, schedule, max_queue=max_queue)
    _assert_same(ref, port)
    check(port[0], port[2], _golden(rigs))
    assert slept == [0.05] * port[2].get("slow_decode", 0) * 2  # both packages slept


def test_single_token_and_eos_budgets(rigs):
    """max_new_tokens=1 completes on the prefill-sampled token, and an eos_id
    equal to the first token stops generation at one token."""
    ref, port = _run_both(rigs, [(0, dict(rid=0, prompt=(5, 9, 17), max_new_tokens=1))])
    _assert_same(ref, port)
    first = port[0].outcomes[0]["tokens"]
    assert len(first) == 1
    ref, port = _run_both(rigs, [(0, dict(rid=1, prompt=(5, 9, 17), max_new_tokens=8,
                                          eos_id=first[0]))])
    _assert_same(ref, port)
    assert port[0].outcomes[1]["tokens"] == first


def test_wall_deadline_on_a_monkeypatched_clock(rigs, monkeypatch):
    """The clock jumps two hours at the end of step 2: at the next boundary
    both loops cancel the in-flight request with ``wall deadline``."""
    now = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])

    def on_step(step, active):
        if step == 2:
            now[0] += 7200.0

    ref, port = _run_both(rigs, [(0, dict(rid=0, prompt=(5, 9), max_new_tokens=8))],
                          wall_deadline_s=3600.0, on_step=on_step)
    _assert_same(ref, port)
    assert port[0].outcomes[0]["status"] == "timed_out"
    assert port[0].outcomes[0]["reason"] == "wall deadline"
    assert 0 < len(port[0].outcomes[0]["tokens"]) < 8


def test_wall_deadline_verdict_is_or_agreed(rigs, monkeypatch):
    """Coordinated: a peer's clock-local verdict (the slot bitmask) cancels
    the request here too, with no desync."""
    def fake_allgather(values, tag="", timeout_s=None):
        row = np.asarray(list(values), np.int64)
        peer = row.copy()
        if row[1] >= 2:  # from step 2 the peer's clock says slot 0 expired
            peer[5] |= 1
        return np.stack([row, peer])

    monkeypatch.setattr(tdist, "allgather_ints", fake_allgather)
    _, _, teng, tcache = rigs
    tcache.reset()
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    res = tserve.run_serve_resilient(
        engine=teng, scheduler=sched, arrivals=[(0, tserve.Request(rid=0, prompt=(5, 9), max_new_tokens=8))],
        install_signal_handlers=False, coordinate=True, wall_deadline_s=3600.0)
    sched.ledger_check()
    assert res.outcomes[0]["status"] == "timed_out" and "wall deadline" in res.outcomes[0]["reason"]


def test_coordination_desync_raises_before_the_batch_decodes(rigs, monkeypatch):
    calls = []

    def fake_allgather(values, tag="", timeout_s=None):
        row = np.asarray(list(values), np.int64)
        calls.append(tag)
        other = row.copy()
        other[7] += 1  # the peer's scheduler decision digest diverged
        return np.stack([row, other])

    monkeypatch.setattr(tdist, "allgather_ints", fake_allgather)
    _, _, teng, tcache = rigs
    tcache.reset()
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    with pytest.raises(DesyncError, match="sched_hash") as e:
        tserve.run_serve_resilient(
            engine=teng, scheduler=sched,
            arrivals=[(s, tserve.Request(**r)) for s, r in _arrivals(n=2)],
            install_signal_handlers=False, coordinate=True)
    width = len(tloop._COORD_FIELDS) + len(sched.fingerprint()) + 1
    assert calls == ["serve_coord"] and e.value.rows.shape == (2, width)
    assert sched.telemetry.counter("serve_decode_steps_total") == 0
    assert sched.telemetry.counter("consistency_mismatches_total") == 1


def test_coordinate_width_and_fields_equal_the_reference():
    from vescale_tpu.serve import loop as jloop

    assert (tloop._COORD_MAGIC, tloop._COORD_FIELDS, tloop._FP_FIELDS, tloop._OR_FIELDS) == (
        jloop._COORD_MAGIC, jloop._COORD_FIELDS, jloop._FP_FIELDS, jloop._OR_FIELDS)


def test_hung_decode_trips_the_watchdog(rigs, monkeypatch, tmp_path):
    """A wedged step (faultsim ``hang``) trips the watchdog: one dump, with
    the main thread's stack in it, and the stall ends with golden tokens."""
    monkeypatch.setenv("VESCALE_FAULTSIM_HANG_S", "0.8")
    _, _, teng, tcache = rigs
    tcache.reset()
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    wd = Watchdog(timeout_s=0.2, poll_s=0.05, abort=False, dump_dir=str(tmp_path),
                  telemetry=sched.telemetry).start()
    tfs.arm(tfs.parse_schedule("hang:step=2"))
    try:
        res = tserve.run_serve_resilient(
            engine=teng, scheduler=sched,
            arrivals=[(s, tserve.Request(**r)) for s, r in _arrivals()],
            install_signal_handlers=False, coordinate=False, watchdog=wd)
    finally:
        tfs.disarm()
        wd.stop()
    assert wd._thread is None
    assert wd.fired == 1 and sched.telemetry.counter("resilience_hang_detected_total") == 1
    bundle = wd.last_bundle
    assert bundle["reason"] == "hang" and bundle["step"] == 2 and bundle["phase"] == "boundary"
    assert bundle["path"] == str(tmp_path / "watchdog_hang_rank0_step2_1.json")
    dumped = json.loads(open(bundle["path"]).read())
    main = [v for k, v in dumped["threads"].items() if k.startswith("MainThread")]
    assert main and "run_serve_resilient" in "".join(main[0])
    assert res.status == "completed"
    assert _ledger(res) == _ledger(_golden(rigs))


def test_watchdog_dump_keys_equal_the_reference(tmp_path):
    from vescale_tpu.resilience import Watchdog as JaxWatchdog

    bundles = []
    for cls in (JaxWatchdog, Watchdog):
        wd = cls(timeout_s=0.1, poll_s=0.02, abort=False, dump_dir=str(tmp_path / cls.__module__),
                 on_hang=bundles.append).start()
        wd.beat(7, phase="decode")
        t0 = time.monotonic()
        while not wd.fired and time.monotonic() - t0 < 10:
            time.sleep(0.02)
        wd.stop()
    jb, tb = bundles
    # the port's dump adds the memory flight recorder's answer while off
    assert set(tb) == set(jb) | {"flight_record"} and tb["flight_record"] is None
    assert os.path.basename(tb["path"]) == os.path.basename(jb["path"])


def test_watchdog_knobs_equal_the_registrations(monkeypatch):
    from vescale_tpu.resilience import Watchdog as JaxWatchdog

    for k in ("VESCALE_WATCHDOG_TIMEOUT", "VESCALE_WATCHDOG_ABORT", "VESCALE_WATCHDOG_EXIT_CODE"):
        monkeypatch.delenv(k, raising=False)
    assert Watchdog.from_env() is None and JaxWatchdog.from_env() is None
    monkeypatch.setenv("VESCALE_WATCHDOG_TIMEOUT", "5")
    monkeypatch.setenv("VESCALE_WATCHDOG_ABORT", "0")
    t, j = Watchdog.from_env(), JaxWatchdog.from_env()
    assert (t.timeout_s, t.abort, t.exit_code) == (j.timeout_s, j.abort, j.exit_code) == (5.0, False, 17)
    assert Watchdog.from_env(timeout_s=0) is None


def test_run_serve_is_the_resilient_loop_with_the_envelope_off(rigs, monkeypatch):
    seen = []
    real = tloop.run_serve_resilient
    monkeypatch.setattr(tloop, "run_serve_resilient", lambda **kw: seen.append(kw) or real(**kw))
    _, _, teng, tcache = rigs
    tcache.reset()
    res = tserve.run_serve(teng, tserve.ContinuousBatchingScheduler(tcache, max_queue=8),
                           [(s, tserve.Request(**r)) for s, r in _arrivals()])
    assert len(seen) == 1
    assert {k: seen[0][k] for k in ("install_signal_handlers", "watchdog_timeout_s",
                                    "wall_deadline_s", "coordinate")} == dict(
        install_signal_handlers=False, watchdog_timeout_s=0, wall_deadline_s=0, coordinate=False)
    assert _ledger(res) == _ledger(_golden(rigs))


def test_control_is_refused_until_the_rollout_is_ported(rigs):
    _, _, teng, tcache = rigs
    with pytest.raises(NotImplementedError, match="A12"):
        tserve.run_serve_resilient(engine=teng, scheduler=tserve.ContinuousBatchingScheduler(tcache),
                                   arrivals=(), control=object())


def test_preemption_signal_drains_and_uninstalls(rigs):
    """A real SIGTERM lands on the handler the loop installs; the loop
    drains and puts the previous handler back."""
    import signal

    # the handler is wired only from the main thread; elsewhere the signal
    # would take the test process down
    assert threading.current_thread() is threading.main_thread()
    _, _, teng, tcache = rigs
    tcache.reset()
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    before = signal.getsignal(signal.SIGTERM)

    def on_step(step, active):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    res = tserve.run_serve_resilient(
        engine=teng, scheduler=sched, arrivals=[(s, tserve.Request(**r)) for s, r in _arrivals(n=6)],
        coordinate=False, on_step=on_step)
    sched.ledger_check()
    assert res.status == "preempted" and res.rejected_on_drain >= 1
    assert signal.getsignal(signal.SIGTERM) is before


# ------------------------------------------------------------ two ranks
def test_two_ranks_over_gloo_agree_and_match_golden(rigs):
    """Two processes, each a rank of a gloo group, serve the same arrivals
    under the reference's two-rank schedule: every fault fires on one rank
    only, its flag is ORed, and both ranks' ledgers come out byte-identical,
    equal to one process firing every fault, with golden tokens."""
    port = reserve_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_serve_child.py"),
                               "rank", str(r), "2", str(port), TWO_RANK],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out[-3000:]
            outs.append(json.loads(next(ln for ln in out.splitlines()
                                        if ln.startswith("RESULT "))[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    r0, r1 = outs
    assert r0["ledger"] == r1["ledger"]  # byte-identical
    assert r0["counts"] == r1["counts"] and r0["steps"] == r1["steps"]
    assert r0["status"] == r1["status"] == "preempted"
    assert r0["fired"] == {"oom": 1, "preempt": 1} and r1["fired"] == {"request_timeout": 1}
    assert r0["counts"]["evicted"] == 1 and r0["counts"]["timed_out"] == 1

    # one process firing every fault gives the same ledger ...
    eng, sched = child.build(max_queue=8)
    tfs.arm(tfs.parse_schedule(TWO_RANK_UNION))
    try:
        union = tserve.run_serve_resilient(engine=eng, scheduler=sched, arrivals=child.arrivals(),
                                           install_signal_handlers=False, coordinate=False)
    finally:
        tfs.disarm()
    assert child.ledger(union) == r0["ledger"]
    # ... and every completed request's tokens are the fault-free run's
    eng, sched = child.build(max_queue=8)
    golden = tserve.run_serve(eng, sched, child.arrivals())
    done = {rid: o for rid, o in json.loads(r0["ledger"]).items() if o["status"] == "completed"}
    assert done
    for rid, o in done.items():
        assert o["tokens"] == golden.outcomes[int(rid)]["tokens"], rid


def test_allgather_and_barrier_alone_return_the_own_row():
    assert not torch.distributed.is_initialized()
    rows = tdist.allgather_ints([3, -1, 2**40])
    assert rows.shape == (1, 3) and rows.dtype == np.int64 and rows.tolist() == [[3, -1, 2**40]]
    tdist.barrier(timeout_s=1.0)
    assert tdist.process_count() == 1 and tdist.process_index() == 0


def test_timed_collective_raises_barrier_timeout(monkeypatch):
    """The helper-thread deadline: a collective that never returns raises
    ``BarrierTimeout`` naming its tag; the next call gets a fresh worker."""
    gate = threading.Event()
    with pytest.raises(tdist.BarrierTimeout, match="serve_coord"):
        tdist._sync_with_timeout(gate.wait, "serve_coord", 0.2)
    assert tdist._SYNC_WORKER.busy
    assert tdist._sync_with_timeout(lambda: 5, "next", 1.0) == 5
    gate.set()
    monkeypatch.setenv("VESCALE_BARRIER_TIMEOUT", "0")
    assert tdist._resolve_timeout(None) is None and tdist._resolve_timeout(2.0) == 2.0


# ------------------------------------------------------------- faultsim
def test_faultsim_serve_kinds_parse_and_fire():
    faults = tfs.parse_schedule("request_timeout:step=3;slow_decode:call=1,count=2")
    assert [f.kind for f in faults] == ["request_timeout", "slow_decode"]
    inj = tfs.arm(faults)
    try:
        inj.set_step(3)
        assert inj.fires("request_timeout")
        assert not inj.fires("request_timeout")  # count=1 consumed
        assert not inj.fires("slow_decode")  # call 0
        assert inj.fires("slow_decode")  # call 1
        assert inj.fires("slow_decode")  # call 2 (count=2)
        assert not inj.fires("slow_decode")
    finally:
        tfs.disarm()


def test_faultsim_disarmed_hooks_are_the_noop_functions():
    assert not tfs.is_armed() and tfs.get_injector() is None
    assert tfs.fires is tfs._noop_fires and tfs.check is tfs._noop_check
    assert tfs.set_step is tfs._noop_set_step
    assert tfs.fires("request_timeout") is False and tfs.fires("slow_decode") is False
    tfs.arm([])
    assert tfs.fires is not tfs._noop_fires
    tfs.disarm()
    assert tfs.fires is tfs._noop_fires and tfs.check is tfs._noop_check


SCHEDULES = [
    BATTERY,
    TWO_RANK,
    "storage_write:call=3;preempt:step=10;nonfinite_loss:step=6,count=4",
    "oom:p=0.3,seed=7;hang:call=0,count=2",
    " replica_kill:call=2 ; ; poll_blackhole:call=0,count=2,rank=1",
    "canary_diverge:p=0.05;router_kill:call=1;journal_torn_write:step=2;resize:step=1",
]


@pytest.mark.parametrize("text", SCHEDULES)
def test_faultsim_grammar_and_firing_equal_the_reference(text, monkeypatch):
    fields = ("kind", "at_call", "at_step", "p", "seed", "count", "rank")
    parse = lambda fs: [tuple(getattr(f, k) for k in fields) for f in fs.parse_schedule(text)]
    assert parse(tfs) == parse(jfs)
    assert tfs.KINDS == jfs.KINDS
    for rank in (0, 1):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("VESCALE_PROCESS_ID", str(rank))
        trace = []
        for fs in (jfs, tfs):
            inj = fs.arm(fs.parse_schedule(text))
            seq = []
            for step in range(12):
                inj.set_step(step)
                for kind in fs.KINDS:
                    seq.append(inj.fires(kind))
            trace.append((seq, dict(inj.fired_total), dict(inj.calls)))
            fs.disarm()
        assert trace[0] == trace[1]


@pytest.mark.parametrize("bad", ["nope:call=1", "oom:when=3", "oom", "oom:call=1,step=2"])
def test_faultsim_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jfs.parse_schedule(bad)
    with pytest.raises(ValueError):
        tfs.parse_schedule(bad)


def test_check_raises_the_reference_errors():
    for fs in (jfs, tfs):
        fs.arm(fs.parse_schedule("oom:call=0;storage_write:call=0;preempt:call=0"))
        try:
            with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
                fs.check("oom", "train_step")
            with pytest.raises(OSError, match="storage write"):
                fs.check("storage_write")
            assert fs.check("preempt") is None  # observation kinds never raise
        finally:
            fs.disarm()


def test_arm_from_env_and_knob_defaults(monkeypatch):
    from vescale_tpu.analysis import envreg
    from vescale_tpu_torch.serve import config as tconfig

    names = [n for n in tconfig.DEFAULTS if n.startswith(("VESCALE_FAULTSIM", "VESCALE_WATCHDOG",
                                                           "VESCALE_BARRIER", "VESCALE_SERVE_"))]
    assert len(names) >= 17
    for n in names:
        assert tconfig.DEFAULTS[n] == envreg.lookup(n).default, n
    monkeypatch.delenv("VESCALE_FAULTSIM", raising=False)
    assert tfs.arm_from_env() is None and not tfs.is_armed()
    monkeypatch.setenv("VESCALE_FAULTSIM", "oom:step=4")
    inj = tfs.arm_from_env()
    assert inj is tfs.get_injector() and [f.kind for f in inj.faults] == ["oom"]
    tfs.disarm()


# ------------------------------------------------------------------ ops
def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp, resp.read().decode()


def test_ops_endpoints_off_create_no_socket_and_no_thread(rigs, monkeypatch):
    monkeypatch.delenv("VESCALE_SERVE_OPS_PORT", raising=False)
    assert tops.maybe_start() is None and tops.active_server() is None
    _, _, teng, tcache = rigs
    tcache.reset()
    names = []
    res = tserve.run_serve_resilient(
        engine=teng, scheduler=tserve.ContinuousBatchingScheduler(tcache, max_queue=8),
        arrivals=[(s, tserve.Request(**r)) for s, r in _arrivals(n=2)],
        install_signal_handlers=False, coordinate=False,
        on_step=lambda step, active: names.extend(t.name for t in threading.enumerate()))
    assert res.status == "completed" and names
    assert not [n for n in names if n.startswith(("vescale-ops", "vescale-watchdog"))]


def test_live_router_feed_keys_equal_the_reference(rigs, monkeypatch):
    """``VESCALE_SERVE_OPS_PORT=0``: during the run ``/router`` carries
    exactly the reference's frozen v5 fields, ``/healthz`` the reference's
    keys and ``/metrics`` the scheduler's registry; the server stops with
    the loop."""
    assert tobs.ROUTER_FIELDS == jobs.ROUTER_FIELDS
    assert tobs.ROUTER_SCHEMA_VERSION == jobs.ROUTER_SCHEMA_VERSION == 5
    monkeypatch.setenv("VESCALE_SERVE_OPS_PORT", "0")
    _, jcache, teng, tcache = rigs
    tcache.reset()
    sched = tserve.ContinuousBatchingScheduler(tcache, max_queue=8)
    seen = {}

    def on_step(step, active):
        if step == 3:
            url = tops.active_server().url
            seen["router"] = json.loads(_get(f"{url}/router")[1])
            seen["healthz"] = json.loads(_get(f"{url}/healthz")[1])
            seen["metrics"] = _get(f"{url}/metrics")[1]

    tserve.run_serve_resilient(
        engine=teng, scheduler=sched, arrivals=[(s, tserve.Request(**r)) for s, r in _arrivals()],
        install_signal_handlers=False, coordinate=False, replica_id="t0", on_step=on_step)
    assert tops.active_server() is None
    feed = seen["router"]
    assert set(feed) == jobs.ROUTER_FIELDS
    assert feed["replica_id"] == "t0" and feed["accepting"] is True and feed["decode_steps"] >= 1
    assert feed["alerts"] == {"active": False, "firing": [], "pending": []} and feed["rollout"] is None
    jsched = jserve.ContinuousBatchingScheduler(jcache, max_queue=8)
    assert set(seen["healthz"]) == set(jobs.ServeObservability(jsched).health())
    assert "serve_decode_steps_total" in seen["metrics"]
    assert 'serve_ttft_seconds{quantile="0.99"}' in seen["metrics"]


def test_retry_after_header_and_poll_blackhole():
    srv = tops.OpsServer(port=reserve_port()).start()
    state = {"draining": False, "shedding": None, "retry_after_s": 2.4}
    try:
        srv.register("healthz", lambda: dict(state))
        srv.register("router", lambda: {"accepting": False, "retry_after_s": 0.2})
        resp, _ = _get(f"{srv.url}/healthz")
        assert resp.headers.get("Retry-After") is None
        state["draining"] = True
        resp, body = _get(f"{srv.url}/healthz")
        assert resp.headers.get("Retry-After") == "3" and json.loads(body)["draining"] is True
        resp, _ = _get(f"{srv.url}/router")
        assert resp.headers.get("Retry-After") == "1"
        tfs.arm(tfs.parse_schedule("poll_blackhole:call=0,count=2"))
        for _ in range(2):
            with pytest.raises(Exception):
                _get(f"{srv.url}/router", timeout=2.0)
        assert json.loads(_get(f"{srv.url}/router")[1])["accepting"] is False
        tfs.disarm()
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{srv.url}/metrics")
        assert e.value.code == 503  # no registry attached
    finally:
        srv.stop()


def test_metrics_text_equals_the_reference_exporter():
    """``/metrics`` renders the port's registry as the JAX package's
    ``prometheus_text`` renders the same numbers."""
    from vescale_tpu.telemetry.exporters import prometheus_text as jax_text
    from vescale_tpu.telemetry.registry import MetricsRegistry
    from vescale_tpu_torch.telemetry import Registry, prometheus_text

    treg, jreg = Registry(), MetricsRegistry()
    for name, n in (("serve_decode_steps_total", 3), ("serve_tenant_a-b_shed_total", 1)):
        treg.count(name, n)
        jreg.counter(name).inc(n)
    for name, v in (("serve_mfu", 0.25), ("serve_free_pages", 12.0), ("odd", float("nan"))):
        treg.set_gauge(name, v)
        jreg.gauge(name).set(v)
    for v in np.random.default_rng(0).random(50):
        treg.observe("serve_itl_seconds", v)
        jreg.histogram("serve_itl_seconds").observe(v)
    treg.observe("9lives", 1.5)
    jreg.histogram("9lives").observe(1.5)
    assert prometheus_text(treg) == jax_text(jreg)
