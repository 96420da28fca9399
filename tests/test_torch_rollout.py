"""The serve-side restore and the ``/control`` weight rollout of the port,
against the JAX package's, on the CPU.

``serve.load_params`` restores only a checkpoint's params (no optimizer
chunk is read) and ``load_drafter_params`` only the drafter's first
blocks.  The reload machine of ``run_serve_resilient`` (``ControlChannel``)
runs the reference's three in-process rollouts (a checkpoint-equivalence
commit, a ``canary_diverge`` rollback, a revert) on the port's tiny engine
and on the JAX engine over the same weights and the same checkpoint,
written by the reference: the rollout states and the served tokens are
equal.  Then the reference ``RolloutController`` drives two port replica
processes (``tests/torch_serve_child.py replica``) through ``/control``:
a ``canary_diverge`` on one replica rolls the fleet back, and a clean
sweep commits both.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

import vescale_tpu.checkpoint as jck
from vescale_tpu import serve as jserve
from vescale_tpu.mesh import DeviceMesh as JaxDeviceMesh
from vescale_tpu.models.llama import Llama as JaxLlama
from vescale_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from vescale_tpu.resilience import faultsim as jfs
from vescale_tpu.serve import FleetRouter, FleetSupervisor, HttpReplicaClient, ReplicaSpec
from vescale_tpu.serve import Request as JaxRequest
from vescale_tpu.serve import RolloutController

from vescale_tpu_torch import checkpoint as tck
from vescale_tpu_torch import placements as pl
from vescale_tpu_torch import serve as tserve
from vescale_tpu_torch.checkpoint.storage import FileSystemStorage
from vescale_tpu_torch.darray import distribute_tensor
from vescale_tpu_torch.mesh import DeviceMesh
from vescale_tpu_torch.models import LlamaConfig, init_params, params_from_jax
from vescale_tpu_torch.resilience import faultsim as tfs
from vescale_tpu_torch.telemetry import ops_server as tops
from vescale_tpu_torch.testing import reserve_port

import torch_serve_child as child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64)
CACHE = dict(num_slots=2, page_size=4, pages_per_slot=4)
DIVERGE = "canary_diverge:call=1,count=1"


@pytest.fixture(autouse=True)
def clean():
    yield
    jfs.disarm()
    tfs.disarm()
    assert tops.active_server() is None


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    """The JAX engine and the port's over the same flax weights, and one
    checkpoint of those weights written by the reference."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VESCALE_KERNELS", "off")
        jcfg = JaxLlamaConfig(dtype=jnp.float32, **SHAPE)
        params = JaxLlama(jcfg).init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        mesh = JaxDeviceMesh(("tp",), (1,), devices=jax.devices()[:1])
        jkc = jserve.KVCacheConfig(layers=jcfg.num_hidden_layers, kv_heads=jcfg.num_key_value_heads,
                                   head_dim=jcfg.head_dim, **CACHE)
        jeng = jserve.ServeEngine(jcfg, mesh, params, jserve.PagedKVCache(jkc, mesh))
        tcfg = LlamaConfig(dtype=torch.float32, **SHAPE)
        tkc = tserve.KVCacheConfig(layers=tcfg.num_hidden_layers, kv_heads=tcfg.num_key_value_heads,
                                   head_dim=tcfg.head_dim, **CACHE)
        teng = tserve.ServeEngine(tcfg, params_from_jax(params, device="cpu"),
                                  tserve.PagedKVCache(tkc, device="cpu"), device="cpu")
        root = str(tmp_path_factory.mktemp("rollout") / "ckpt")
        jck.save(root, {"model": jeng.params})
        yield jeng, teng, root


def _recording(monkeypatch):
    reads = []
    orig = FileSystemStorage.read_bytes

    def recording(self, name):
        reads.append(name)
        return orig(self, name)

    monkeypatch.setattr(FileSystemStorage, "read_bytes", recording)
    return reads


# ------------------------------------------------------- load_params
def test_load_params_reads_no_optimizer_chunk_and_reshards(tmp_path, monkeypatch):
    """A training checkpoint (params and optax state on the reference's
    (2, 4) mesh) restored params-only as Replicate pieces of a layout-only
    mesh of 4: elastic, only ``data/model/`` chunks read, and the restored
    weights serve the same logits as the flax tree they came from."""
    jcfg = JaxLlamaConfig(dtype=jnp.float32, **SHAPE)
    params = JaxLlama(jcfg).init(jax.random.key(1), jnp.ones((1, 8), jnp.int32))["params"]
    mesh24 = JaxDeviceMesh(("dp", "tp"), (2, 4))
    placed = jax.tree_util.tree_map(
        lambda x: jax.device_put(np.asarray(x), NamedSharding(mesh24.jax_mesh, P())), params)
    root = str(tmp_path / "ckpt")
    jck.save(root, {"model": placed, "optimizer": optax.adam(1e-3).init(placed)})
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    m4 = DeviceMesh(("tp",), (4,), device_type="cpu")
    template = jax.tree_util.tree_map(
        lambda t: distribute_tensor(torch.zeros_like(t), m4, [pl.Replicate()], rank=2), want,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    reads = _recording(monkeypatch)
    restored = tserve.load_params(root, template)
    assert tck.LAST_LOAD_STATS["elastic"] == 1
    chunks = [n for n in reads if n.startswith("data/")]
    assert chunks and all(n.startswith("data/model/") for n in chunks)
    assert not any("optimizer" in n for n in reads)
    tree = jax.tree_util.tree_map(lambda d: d.to_local(), restored,
                                  is_leaf=lambda x: not isinstance(x, dict))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(tree),
                                                 jax.tree_util.tree_leaves(want)))
    tcfg = LlamaConfig(dtype=torch.float32, **SHAPE)
    kc = tserve.KVCacheConfig(layers=2, kv_heads=2, head_dim=tcfg.head_dim, num_slots=1, page_size=4,
                              pages_per_slot=4)
    logits = []
    for p in (tree, want):
        eng = tserve.ServeEngine(tcfg, p, tserve.PagedKVCache(kc, device="cpu"), device="cpu")
        logits.append(eng.prefill((9, 4, 31), eng.cache.alloc(3, 1)))
    assert logits[0].tobytes() == logits[1].tobytes()


def test_load_params_of_meta_templates_and_bytes_read(tmp_path, monkeypatch):
    """A port checkpoint of params and a small optimizer subtree: a
    template of ``meta`` tensors restores every param bitwise on the
    requested device, and ``bytes_read`` is exactly the model's chunk
    files."""
    cfg = LlamaConfig(dtype=torch.float32, **SHAPE)
    params = init_params(cfg, seed=3, device="cpu")
    root = tmp_path / "ckpt"
    tck.save(str(root), {"model": params, "optimizer": {"mu": params["norm"]["weight"] * 0.5}})
    template = init_params(cfg, device="meta")
    reads = _recording(monkeypatch)
    got = tserve.load_params(str(root), template, device="cpu")
    assert not any("optimizer" in n for n in reads)
    model_bytes = sum(f.stat().st_size for f in (root / "data" / "model").rglob("*.npy"))
    assert tck.LAST_LOAD_STATS["bytes_read"] == model_bytes
    flat = tck.planner.flatten_state
    assert [k for k, _ in flat(got)] == [k for k, _ in flat(params)]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flat(got), flat(params)))


def test_load_drafter_params_reads_only_its_blocks(tmp_path, monkeypatch):
    cfg = LlamaConfig(dtype=torch.float32, **SHAPE)
    params = init_params(cfg, seed=4, device="cpu")
    tck.save(str(tmp_path / "ckpt"), {"model": params, "optimizer": {"x": torch.ones(3)}})
    reads = _recording(monkeypatch)
    got = tserve.load_drafter_params(str(tmp_path / "ckpt"), cfg, 1, device="cpu")
    chunks = [n for n in reads if n.startswith("data/")]
    assert any("layers_0" in n for n in chunks)
    assert not any("layers_1" in n or "optimizer" in n for n in chunks)
    want = tserve.slice_drafter_params(params, 1)
    flat = tck.planner.flatten_state
    assert [k for k, _ in flat(got)] == [k for k, _ in flat(want)]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flat(got), flat(want)))
    tmpl = tserve.drafter_template(cfg, 1)
    assert all(t.device.type == "meta" for _, t in flat(tmpl)) and "layers_1" not in tmpl


# ------------------------------------------ swap_params / replay_greedy
def test_swap_params_roundtrip_is_bitwise(rigs):
    _, eng, _ = rigs
    eng.cache.reset()
    golden = eng.replay_greedy([3, 7, 11], 4)
    assert len(golden) == 4 and eng.replay_greedy([3, 7, 11], 4) == golden
    assert eng.cache.free_slot_count() == eng.cache.num_slots
    perturbed = jax.tree_util.tree_map(lambda x: -x, eng.params)
    old = eng.swap_params(perturbed)
    assert len(eng.replay_greedy([3, 7, 11], 4)) == 4
    eng.swap_params(old)
    assert eng.replay_greedy([3, 7, 11], 4) == golden


def test_swap_params_validates_tree_and_shapes(rigs):
    _, eng, _ = rigs
    with pytest.raises(ValueError):
        eng.swap_params({"not": "the same tree"})
    bad = jax.tree_util.tree_map(lambda x: torch.zeros(tuple(x.shape) + (1,)), eng.params)
    with pytest.raises(ValueError):
        eng.swap_params(bad)


def test_canary_diverge_flips_exactly_one_replay(rigs):
    """As in the reference: the armed hook flips one logit in the first
    canary replay only; disarmed, the hook does nothing."""
    jeng, eng, _ = rigs
    for fs, e in ((jfs, jeng), (tfs, eng)):
        e.cache.reset()
        golden = e.replay_greedy([5, 9, 2], 3, canary=True)
        fs.arm(fs.parse_schedule(DIVERGE))
        try:
            s1 = e.replay_greedy([5, 9, 2], 3, canary=True)
            s2 = e.replay_greedy([5, 9, 2], 3, canary=True)
        finally:
            fs.disarm()
        assert s1 != s2 and s2 == golden
        assert e.replay_greedy([5, 9, 2], 3, canary=True) == golden


# ------------------------------------------------------ control channel
def test_control_channel_protocol():
    ch = tserve.ControlChannel()
    assert ch.provider({"op": "status"}) == {"ok": True, "rollout": None}
    assert ch.provider({"op": "nope"})["ok"] is False
    assert ch.provider({"op": "reload"})["ok"] is False  # no checkpoint
    assert ch.provider({"op": "reload", "checkpoint": "/x"}) == {"ok": True, "accepted": "reload"}
    busy = ch.provider({"op": "commit"})
    assert busy["ok"] is False and busy["error"] == "busy"
    job = ch.take()
    assert job["op"] == "reload" and job["checkpoint"] == "/x" and ch.take() is None
    assert ch.provider({"op": "commit"})["ok"] is True


def test_control_refuses_a_coordinated_loop(rigs):
    _, eng, _ = rigs
    sched = tserve.ContinuousBatchingScheduler(eng.cache)
    with pytest.raises(ValueError, match="single-process"):
        tserve.run_serve_resilient(engine=eng, scheduler=sched, arrivals=(), coordinate=True,
                                   control=tserve.ControlChannel(), install_signal_handlers=False)


# --------------------------------------------- in-process reload machine
def _serve_with_control(pkg, eng, *, schedule, reqs=3):
    """The reference test's inbox-fed loop: ``schedule`` maps a step to the
    control payloads posted at that boundary."""
    eng.cache.reset()
    sched = pkg.ContinuousBatchingScheduler(eng.cache, max_queue=8)
    inbox = pkg.RequestInbox()
    control = pkg.ControlChannel()
    rng = np.random.default_rng(7)
    for i in range(reqs):
        inbox.push(pkg.Request(rid=i, prompt=tuple(int(x) for x in rng.integers(1, 60, 3)),
                               max_new_tokens=4, deadline_steps=200))
    last = max(schedule, default=0)

    def on_step(step, active):
        for payload in schedule.get(step, ()):
            r = control.provider(payload)
            assert r.get("ok"), r
        if len(sched.outcomes) >= reqs and step > last + 10:
            inbox.close()

    res = pkg.run_serve_resilient(engine=eng, scheduler=sched, arrivals=(), inbox=inbox,
                                  control=control, on_step=on_step, install_signal_handlers=False,
                                  coordinate=False, max_steps=2000, idle_sleep_s=0.0)
    sched.ledger_check()
    return res, sched, control


def _reload(root, prompts, mnt):
    return {"op": "reload", "checkpoint": root, "prompts": prompts, "max_new_tokens": mnt,
            "canary": True, "baseline": True}


ROLLOUTS = {
    "commit": ({2: [_reload(None, [[1, 2, 3]], 3)], 40: [{"op": "commit"}]}, False),
    "canary_diverge": ({2: [_reload(None, [[1, 2, 3]], 3)]}, True),
    "revert": ({2: [_reload(None, [[4, 5]], 2)], 40: [{"op": "revert"}]}, False),
}


def _with_root(schedule, root):
    return {s: [dict(p, checkpoint=root) if p["op"] == "reload" else p for p in ps]
            for s, ps in schedule.items()}


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_rollout_matches_the_reference_loop(rigs, name, monkeypatch):
    """The same rollout through both loops, both reloading the checkpoint
    the reference wrote: the final rollout state, its detail and every
    served stream equal; the streams equal a run with no rollout; the
    port's stage events cover drain, swap and canary."""
    jeng, teng, root = rigs
    monkeypatch.setenv("VESCALE_KERNELS", "off")
    schedule, diverge = ROLLOUTS[name]
    schedule = _with_root(schedule, root)
    golden, _, _ = _serve_with_control(tserve, teng, schedule={})
    out = {}
    for pkg, fs, eng in ((jserve, jfs, jeng), (tserve, tfs, teng)):
        if diverge:
            fs.arm(fs.parse_schedule(DIVERGE))
        try:
            out[pkg.__name__] = _serve_with_control(pkg, eng, schedule=schedule)
        finally:
            fs.disarm()
    (jres, _, jctl), (tres, tsched, tctl) = out["vescale_tpu.serve"], out["vescale_tpu_torch.serve"]
    assert tres.status == jres.status == "completed"
    assert tctl.state == jctl.state
    want_state = {"commit": "committed", "canary_diverge": "rolled_back", "revert": "rolled_back"}
    assert tctl.state["state"] == want_state[name]
    if name == "canary_diverge":
        assert "deterministic" in tctl.state["detail"]["reason"]
    toks = {r: o["tokens"] for r, o in tres.outcomes.items()}
    assert toks == {r: o["tokens"] for r, o in jres.outcomes.items()}
    assert toks == {r: o["tokens"] for r, o in golden.outcomes.items()}
    stages = [e["stage"] for e in tsched.telemetry.events if e["kind"] == "serve_rollout_stage"]
    assert stages[:4] == ["drain", "baseline", "swap", "canary"]
    assert tsched.telemetry.counter("serve_rollouts_total") == 1
    assert tsched.telemetry.counter("serve_rollbacks_total") == (0 if name == "commit" else 1)


def test_router_feed_carries_the_rollout(rigs):
    """While the rollout drains, the v5 feed is not accepting and names the
    stage; after it, the feed accepts again and carries ``committed``."""
    _, teng, root = rigs
    teng.cache.reset()
    sched = tserve.ContinuousBatchingScheduler(teng.cache, max_queue=8)
    control = tserve.ControlChannel()
    srv = tops.OpsServer(port=0, registry=sched.telemetry)
    seen = []

    def on_step(step, active):
        if step == 0:
            assert control.provider(_reload(root, [[1, 2, 3]], 3))["ok"]
        feed = srv.providers["router"]()
        seen.append((feed["accepting"], (feed["rollout"] or {}).get("state")))

    try:
        res = tserve.run_serve_resilient(
            engine=teng, scheduler=sched, install_signal_handlers=False, coordinate=False,
            arrivals=[(0, tserve.Request(rid=0, prompt=(1, 2), max_new_tokens=5))],
            control=control, ops=srv, on_step=on_step)
        final = srv.providers["router"]()
    finally:
        srv.stop()
    assert res.status == "completed" and res.outcomes[0]["status"] == "completed"
    assert seen[0] == (True, None) and (False, "draining") in seen[1:]
    assert final["accepting"] is True and final["rollout"] == control.state
    assert final["rollout"]["state"] == "committed"


# -------------------------------------- the reference controller, HTTP
def _specs(workdir, diverge_replica):
    specs = []
    for i in range(2):
        rid = f"r{i}"
        env = {k: v for k, v in os.environ.items() if not k.startswith("VESCALE_")}
        env.update(PYTHONPATH=REPO)
        if rid == diverge_replica:
            env["VESCALE_FAULTSIM"] = DIVERGE
        specs.append(ReplicaSpec(rid, [sys.executable, os.path.join(REPO, "tests", "torch_serve_child.py"),
                                       "replica"], reserve_port(), env=env,
                                 log_path=os.path.join(workdir, f"{rid}.log")))
    return specs


def test_reference_rollout_controller_drives_port_replicas(tmp_path):
    """Two port replicas behind the reference router.  Rollout 1: r1's
    canary diverges, so r1 rolls itself back and the controller reverts
    the already-committed r0.  Rollout 2 (the fault spent): a clean sweep
    commits both.  Served streams stay the port's own golden ones."""
    eng, _ = child.build()
    root = str(tmp_path / "ckpt")
    tck.save(root, {"model": eng.params})
    specs = _specs(str(tmp_path), diverge_replica="r1")
    fr = FleetRouter(poll_interval_s=0.05, breaker_failures=5, breaker_cooldown_s=0.5,
                     dispatch_retries=4, backoff_s=0.05, backoff_max_s=0.5, hedge_s=0.0)
    sup = FleetSupervisor(specs, max_restarts=0, restart_backoff_s=0.3)
    sup.start()
    try:
        for s in specs:
            fr.add_replica(s.replica_id, HttpReplicaClient(s.url))
        deadline = time.monotonic() + 90.0
        while not all(h.feed is not None for h in fr.replicas.values()):
            assert time.monotonic() < deadline, "fleet never came up"
            sup.poll()
            fr.poll(force=True)
            time.sleep(0.1)
        prompts = [[1, 2, 3], [7, 8]]
        diverge = RolloutController(fr, root, prompts, max_new_tokens=4, canary=True, baseline=True,
                                    stage_timeout_s=60.0).run()
        clean = RolloutController(fr, root, prompts, max_new_tokens=4, canary=True, baseline=True,
                                  stage_timeout_s=60.0).run()
        fr.poll(force=True)
        feeds = {rid: h.feed for rid, h in fr.replicas.items()}
        for i in range(4):
            fr.submit(JaxRequest(rid=i, prompt=(3 + i, 5), max_new_tokens=3))
        deadline = time.monotonic() + 60.0
        while fr.pump() != 0:
            assert time.monotonic() < deadline, "fleet drain stuck"
            time.sleep(0.05)
        fr.fleet_ledger_check()
        records = dict(fr.ledger.records)
    finally:
        rcs = sup.stop_all(grace_s=30.0)
    assert diverge["ok"] is False and diverge["diverged"] == "r1", diverge
    assert diverge["rolled_back"] == ["r1", "r0"] and diverge["committed"] == []
    assert "deterministic" in diverge["reason"]
    assert clean["ok"] is True and clean["committed"] == ["r0", "r1"], clean
    golden = [eng.replay_greedy(p, 4) for p in prompts]
    assert clean["streams"] == golden
    for rid in ("r0", "r1"):
        assert feeds[rid]["rollout"]["state"] == "committed"
        assert feeds[rid]["rollout"]["detail"]["finalized"] is True
    for rid, rec in records.items():
        assert rec.status == "completed"
        assert rec.outcome["tokens"] == eng.replay_greedy((3 + rid, 5), 3), rid
    assert rcs == {"r0": 0, "r1": 0}
