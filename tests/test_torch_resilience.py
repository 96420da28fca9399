"""The port's resilient train loop (``vescale_tpu_torch.resilience.
run_resilient``) against the JAX package's, on the CPU.

  * The reference's own toy step (pure numpy, ``tests/test_resilience.py``'s
    ``_step_fn`` / ``_batch_fn``) runs through both loops under every fault
    schedule of ``tests/test_resilience.py``: the ``RunResult`` fields, the
    raised error, the committed steps on disk, the ``resilience_*``,
    ``consistency_*`` and ``checkpoint_*`` counters and the event lines of
    ``steps.jsonl`` must be EXACTLY equal.
  * The tiny Llama (2 layers, width 32, fp32) through the port's
    ``make_train_step`` and ``FunctionalStep`` against the reference's
    ``make_train_step`` with ``adamw_lowmem``: losses within the 1e-5
    relative bound of ``tests/test_torch_train.py``; a faulted port run
    bitwise its own golden run; a reference-written checkpoint resumed by
    the port; the ``"optimizer"`` chunk files byte-identical.
  * ``TokenDataLoader``: the retry absorbs an injected ``loader_next``, an
    exhausted retry re-raises, and the stream after a retry is the
    reference loader's, bit for bit.
  * An async save followed by an in-place step restores the pre-step
    values.
"""

import glob
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vescale_tpu.resilience as ref_res
from vescale_tpu import telemetry as ref_tel
from vescale_tpu.checkpoint import CheckpointManager as RefManager
from vescale_tpu.data import TokenDataLoader as RefLoader

import vescale_tpu_torch.resilience as port_res
from vescale_tpu_torch import telemetry as port_tel
from vescale_tpu_torch.checkpoint import CheckpointManager as PortManager
from vescale_tpu_torch.data import TokenDataLoader as PortLoader

from torch_reset import dormant_module, dormant_test  # noqa: F401 (autouse: both packages dormant)

REF = types.SimpleNamespace(res=ref_res, tel=ref_tel, Manager=RefManager, name="ref",
                            Loader=RefLoader, loader_kw={})
PORT = types.SimpleNamespace(res=port_res, tel=port_tel, Manager=PortManager, name="port",
                             Loader=PortLoader, loader_kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Python-pool storage I/O (the fault hooks sit on that path), fast
    backoff, fresh policies and disarmed faultsims around each test."""
    monkeypatch.setenv("VESCALE_NATIVE_CKPT_IO", "0")
    monkeypatch.setenv("VESCALE_IO_BACKOFF_BASE", "0.001")
    monkeypatch.delenv("VESCALE_FAULTSIM", raising=False)
    monkeypatch.delenv("VESCALE_KERNELS", raising=False)
    for pkg in (REF, PORT):
        pkg.res.reset_default_policies()
        pkg.res.faultsim.disarm()
    yield
    for pkg in (REF, PORT):
        pkg.res.faultsim.disarm()
        pkg.res.reset_default_policies()
        pkg.tel.shutdown()


# ------------------------------------------------------------ the toy step
def _step_fn(params, opt, batch):
    w = params["w"] + batch.mean(axis=0).astype(np.float32) * 0.01
    return {"w": w}, {"m": opt["m"] + 1}, float(np.abs(w).sum())


def _batch_fn(i):
    rng = np.random.default_rng(1000 + i)
    return rng.normal(size=(2, 4)).astype(np.float32)


def _tok_step(params, opt, batch):
    x = np.asarray(batch["input"])
    w = params["w"] + x.mean(axis=0)[:4].astype(np.float32) * 1e-4
    return {"w": w}, {"m": opt["m"] + 1}, float(np.abs(w).sum())


def _keyed_step(params, opt, batch, step_key):
    """The toy step plus the step key's words in the loss: both loops must
    hand it ``fold_in(key(seed), step)``, bit for bit."""
    p, o, loss = _step_fn(params, opt, batch)
    k = np.asarray(step_key, dtype=np.uint64).reshape(-1)
    return p, o, loss + float(int(k[0]) * 31 + int(k[1]))


def _kw(total_steps=12, **over):
    kw = dict(step_fn=_step_fn, params={"w": np.zeros(4, np.float32)},
              opt_state={"m": np.zeros(4, np.float32)}, total_steps=total_steps,
              batch_fn=_batch_fn, save_every=3, async_save=False, install_signal_handlers=False)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("resil_data") / "train.bin"
    np.random.default_rng(0).integers(0, 50000, 100_000).astype(np.uint16).tofile(p)
    return str(p)


# Each scenario: fn(pkg, root, token_file) -> list of RunResults (one per
# run_resilient call); it arms pkg's faultsim itself.  ``_observe`` catches
# an error and compares it by type and message.
def _arm(pkg, *faults):
    pkg.res.faultsim.arm([pkg.res.Fault(*f[:1], **f[1]) for f in faults])


def sc_preempt_and_resume(pkg, root, tf):
    _arm(pkg, ("preempt", dict(at_step=7)))
    r1 = pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())
    pkg.res.faultsim.disarm()
    return [r1, pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())]


def sc_preempt_after_save(pkg, root, tf):
    _arm(pkg, ("preempt", dict(at_step=6)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())]


def sc_nan_burst(pkg, root, tf):
    _arm(pkg, ("nonfinite_loss", dict(at_step=7, count=2)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=2), **_kw())]


def sc_below_threshold(pkg, root, tf):
    _arm(pkg, ("nonfinite_loss", dict(at_step=7, count=1)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=3), **_kw())]


def sc_optimizer_skip(pkg, root, tf):
    def skip_step(params, opt, batch):
        p, o, loss = _step_fn(params, opt, batch)
        skipping = 4 <= int(o["m"][0]) <= 5
        return p, {**o, "loss_scale": {"scale": 1.0, "skip_count": int(skipping)}}, loss

    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=5),
                                  **_kw(step_fn=skip_step))]


def sc_zscore_spike(pkg, root, tf):
    def spiky(params, opt, batch):
        p, o, _ = _step_fn(params, opt, batch)
        i = int(o["m"][0]) - 1
        return p, o, 1.0 + 0.001 * i + (1000.0 if i == 30 else 0.0)

    return [pkg.res.run_resilient(
        manager=pkg.Manager(root),
        anomaly=pkg.res.AnomalyPolicy(threshold=1, zscore=8.0, min_history=10),
        **_kw(total_steps=40, step_fn=spiky, save_every=10))]


def sc_escalate_data_skip(pkg, root, tf):
    poison = float(_batch_fn(7)[0, 0])

    def bad_batch_step(params, opt, batch):
        p, o, loss = _step_fn(params, opt, batch)
        if abs(float(batch[0, 0]) - poison) < 1e-12:
            loss = float("nan")
        return p, o, loss

    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=1),
                                  **_kw(step_fn=bad_batch_step))]


def sc_rollback_cap(pkg, root, tf):
    def nan_after_3(params, opt, batch):
        p, o, loss = _step_fn(params, opt, batch)
        return p, o, float("nan") if int(o["m"][0]) >= 4 else loss

    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=1, max_rollbacks=2),
                                  **_kw(step_fn=nan_after_3, save_every=1))]


def sc_anomaly_without_checkpoint(pkg, root, tf):
    def always_nan(params, opt, batch):
        p, o, _ = _step_fn(params, opt, batch)
        return p, o, float("nan")

    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=1),
                                  **_kw(step_fn=always_nan))]


def sc_injected_oom(pkg, root, tf):
    _arm(pkg, ("oom", dict(at_step=7)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root), restart_backoff=0.001, **_kw())]


def sc_restart_budget(pkg, root, tf):
    _arm(pkg, ("oom", dict(at_step=5, count=10**6)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root), max_restarts=2,
                                  restart_backoff=0.001, **_kw())]


def sc_restart_without_checkpoint(pkg, root, tf):
    _arm(pkg, ("oom", dict(at_step=1)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())]


def sc_loader_hard_failure(pkg, root, tf):
    os.environ["VESCALE_LOADER_RETRIES"] = "2"
    pkg.res.reset_default_policies()
    try:
        _arm(pkg, ("loader_next", dict(at_call=6, count=2)))
        loader = pkg.Loader(tf, batch=2, seq_len=16, seed=11, **pkg.loader_kw)
        try:
            kw = dict(_kw(step_fn=_tok_step, restart_backoff=0.001), batch_fn=None)
            return [pkg.res.run_resilient(manager=pkg.Manager(root), loader=loader, **kw)]
        finally:
            loader.close()
    finally:
        del os.environ["VESCALE_LOADER_RETRIES"]
        pkg.res.reset_default_policies()


def sc_loader_preempt_resume(pkg, root, tf):
    kw = dict(_kw(step_fn=_tok_step), batch_fn=None)
    out = []
    for armed in (True, False):
        if armed:
            _arm(pkg, ("preempt", dict(at_step=5)))
        loader = pkg.Loader(tf, batch=2, seq_len=16, seed=11, **pkg.loader_kw)
        out.append(pkg.res.run_resilient(manager=pkg.Manager(root), loader=loader, **kw))
        loader.close()
        pkg.res.faultsim.disarm()
    return out


def sc_preempt_mid_streak(pkg, root, tf):
    _arm(pkg, ("nonfinite_loss", dict(at_step=7, count=3)), ("preempt", dict(at_step=8)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=5), **_kw())]


def sc_keyboard_interrupt(pkg, root, tf):
    fired = []

    def interrupting(params, opt, batch):
        if not fired and float(np.abs(opt["m"]).sum()) >= 7 * 4:
            fired.append(1)
            raise KeyboardInterrupt
        return _step_fn(params, opt, batch)

    r1 = pkg.res.run_resilient(manager=pkg.Manager(root), **_kw(step_fn=interrupting))
    return [r1, pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())]


def sc_schema_mismatch(pkg, root, tf):
    pkg.Manager(root, keep=3).save(5, {"model": {"w": np.ones(4, np.float32)},
                                       "optimizer": {"m": np.ones(4, np.float32)}})
    return [pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())]


def sc_all_quarantined(pkg, root, tf):
    class FailingRestore(pkg.Manager):
        def restore(self, *a, **kw):
            raise OSError("disk went away")

    _arm(pkg, ("oom", dict(at_step=4)))
    return [pkg.res.run_resilient(manager=FailingRestore(root), restart_backoff=0.001,
                                  **_kw())]


def sc_quarantine_corrupt_step(pkg, root, tf):
    pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())
    bad = sorted(glob.glob(os.path.join(root, "step_*")))[-1]
    for f in glob.glob(os.path.join(bad, "data", "**", "*.npy"), recursive=True):
        os.remove(f)
    with pytest.warns(UserWarning, match="quarantined"):
        return [pkg.res.run_resilient(manager=pkg.Manager(root), **_kw(13))]


def sc_async_drain(pkg, root, tf):
    out = [pkg.res.run_resilient(manager=pkg.Manager(root), **_kw(async_save=True))]
    root2 = root + "_2"
    _arm(pkg, ("preempt", dict(at_step=7)))
    out.append(pkg.res.run_resilient(manager=pkg.Manager(root2), **_kw(async_save=True)))
    pkg.res.faultsim.disarm()
    out.append(pkg.res.run_resilient(manager=pkg.Manager(root2), **_kw(async_save=True)))
    return out


def sc_metrics_and_events(pkg, root, tf):
    _arm(pkg, ("nonfinite_loss", dict(at_step=7, count=2)), ("storage_write", dict(at_call=0)),
         ("preempt", dict(at_step=10)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root),
                                  anomaly=pkg.res.AnomalyPolicy(threshold=2), **_kw())]


def _chip_smoke():
    """``chip_smoke.py`` (the card's script; importing it runs nothing)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


def sc_card_schedule(pkg, root, tf):
    """``chip_smoke.py``'s GPT-2 schedule on the toy step: a storage write,
    a loader fetch, NaN at steps 6-7, the OOM of step 9 (injected here,
    real on the card) and a preemption.  Each async save is drained as
    soon as it is submitted, so which step a fault restores does not hang
    on the writer thread's timing."""
    class Drained(pkg.Manager):
        def save(self, *a, **kw):
            out = super().save(*a, **kw)
            self.wait_pending()
            return out

    pkg.res.faultsim.arm(pkg.res.parse_schedule(
        f"{CHIP.RESIL_SCHEDULE};oom:step={CHIP.RESIL_OOM_STEP}"))
    loader = pkg.Loader(tf, batch=2, seq_len=16, seed=11, **pkg.loader_kw)
    try:
        kw = dict(_kw(total_steps=CHIP.RESIL_STEPS, save_every=CHIP.RESIL_SAVE_EVERY,
                      async_save=True, step_fn=_tok_step, restart_backoff=0.001),
                  batch_fn=None)
        return [pkg.res.run_resilient(manager=Drained(root, keep=2), loader=loader,
                                      anomaly=pkg.res.AnomalyPolicy(threshold=2), **kw)]
    finally:
        loader.close()


def sc_arm_from_env(pkg, root, tf):
    os.environ["VESCALE_FAULTSIM"] = "preempt:step=4"
    try:
        return [pkg.res.run_resilient(manager=pkg.Manager(root), **_kw())]
    finally:
        del os.environ["VESCALE_FAULTSIM"]


def sc_consistency_single_process(pkg, root, tf):
    """An explicitly armed checker on one process: its cadence runs and
    counts, trivially consistent."""
    return [pkg.res.run_resilient(manager=pkg.Manager(root), consistency_every=4, rng_seed=3,
                                  **_kw(step_fn=_keyed_step))]


def sc_coordinated_single_process(pkg, root, tf):
    """coordinate=True on one process: the control exchange runs, the
    async save commits at the next boundary."""
    _arm(pkg, ("preempt", dict(at_step=8)))
    return [pkg.res.run_resilient(manager=pkg.Manager(root), coordinate=True, rng_seed=5,
                                  consistency_every=2,
                                  **_kw(async_save=True, step_fn=_keyed_step))]


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items() if name.startswith("sc_")}
# the schedule's result in the reference loop, by tests/test_resilience.py
EXPECTED = {
    "preempt_and_resume": lambda rs, err: rs[0]["step"] == 6
    and rs[0]["emergency_save_step"] == 6 and rs[1]["status"] == "completed"
    and rs[1]["step"] == 11,
    "nan_burst": lambda rs, err: rs[0]["rollbacks"] == 1 and rs[0]["anomaly_steps"] == 2,
    "rollback_cap": lambda rs, err: "max_rollbacks" in err,
    "anomaly_without_checkpoint": lambda rs, err: "no committed checkpoint" in err,
    "restart_budget": lambda rs, err: "RESOURCE_EXHAUSTED" in err,
    "schema_mismatch": lambda rs, err: "state schema" in err,
    "all_quarantined": lambda rs, err: "no checkpoint survived" in err,
    "escalate_data_skip": lambda rs, err: rs[0]["rollbacks"] == 2,
    "injected_oom": lambda rs, err: rs[0]["restarts"] == 1 and rs[0]["status"] == "completed",
    "metrics_and_events": lambda rs, err: rs[0]["status"] == "preempted",
    "card_schedule": lambda rs, err: {k: rs[0][k] for k in CHIP.RESIL_EXPECT}
    == CHIP.RESIL_EXPECT,
    "consistency_single_process": lambda rs, err: rs[0]["status"] == "completed",
    "coordinated_single_process": lambda rs, err: rs[0]["status"] == "preempted"
    and rs[0]["emergency_save_step"] == 7,
}


def _observe(pkg, name, tmp_path, token_file):
    """Run one scenario through one package; everything observable."""
    root = str(tmp_path / pkg.name / "c")
    out_dir = str(tmp_path / pkg.name / "tel")
    if pkg is REF:
        pkg.tel.init(out_dir=out_dir, memtrack=False, timeseries=False, alerts=False,
                     costaudit=False)
    else:
        pkg.tel.init(out_dir=out_dir, memtrack=False)
    results, err = [], None
    try:
        results = SCENARIOS[name](pkg, root, token_file)
    except Exception as e:  # noqa: BLE001 — compared across the packages
        err = f"{type(e).__name__}: {e}".replace(str(tmp_path / pkg.name), "<tmp>")
    finally:
        pkg.res.faultsim.disarm()
    counters = {k: v for k, v in pkg.tel.get_registry().snapshot()["counters"].items()
                if k.startswith(("resilience_", "consistency_", "checkpoint_"))}
    pkg.tel.shutdown()
    events = []
    path = os.path.join(out_dir, "steps.jsonl")
    if os.path.exists(path):
        for line in open(path):
            rec = json.loads(line)
            rec.pop("ts", None)
            events.append(json.loads(json.dumps(rec).replace(str(tmp_path / pkg.name), "<tmp>")))
    res = [dict(status=r.status, step=r.step, restarts=r.restarts, rollbacks=r.rollbacks,
                quarantined=r.quarantined, anomaly_steps=r.anomaly_steps,
                emergency_save_step=r.emergency_save_step,
                losses={k: np.float64(v).tobytes() for k, v in r.losses.items()},  # NaN-safe
                params=np.asarray(r.params["w"]).tobytes(),
                opt=np.asarray(r.opt_state["m"]).tobytes()) for r in results]
    steps = {}
    for d in sorted(glob.glob(str(tmp_path / pkg.name / "c*"))):
        steps[os.path.basename(d)] = (pkg.Manager(d)._committed_steps(), sorted(os.listdir(d)))
    return dict(results=res, error=err, counters=counters, events=events, disk=steps)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_resilient_matches_reference_on_the_toy_step(name, tmp_path, token_file):
    ref = _observe(REF, name, tmp_path, token_file)
    port = _observe(PORT, name, tmp_path, token_file)
    if name in EXPECTED:
        assert EXPECTED[name](ref["results"], ref["error"] or ""), ref
    for key in ("error", "results", "disk", "counters", "events"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    assert ref["results"] or ref["error"]


def test_record_event_is_a_noop_while_dormant():
    assert port_tel.record_event("resilience_test", x=1) is None
    assert ref_tel.record_event("resilience_test", x=1) is None
    assert not port_tel.is_active()


def test_metrics_reach_prometheus_and_the_resilience_block(tmp_path, token_file):
    out = str(tmp_path / "tel")
    port_tel.init(out_dir=out, memtrack=False)
    try:
        sc_metrics_and_events(PORT, str(tmp_path / "c"), token_file)
        prom = port_tel.parse_prometheus_text(port_tel.prometheus_dump())
        assert prom["resilience_rollbacks_total"] == 1
        assert prom["resilience_io_retries_total"] >= 1
        assert prom["resilience_faults_injected_total"] >= 4
        dash = port_tel.dashboard()
        assert "resilience:" in dash
        assert "resilience_rollbacks_total" not in dash.split("resilience:")[0]
        kinds = {json.loads(l).get("event") for l in open(os.path.join(out, "steps.jsonl"))}
        assert {"resilience_rollback", "resilience_preempted"} <= kinds
    finally:
        port_res.faultsim.disarm()
        port_tel.shutdown()


# ------------------------------------------------- errors of the card itself
ILLEGAL_ADDRESS = "CUDA error: an illegal memory access was encountered"


def _card_errors():
    return {"illegal_address": RuntimeError(ILLEGAL_ADDRESS),
            "oom": torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")}


@pytest.mark.parametrize("when", ["resume", "restart"])
@pytest.mark.parametrize("kind", ["illegal_address", "oom"])
def test_a_card_error_in_restore_propagates_and_quarantines_nothing(kind, when, tmp_path):
    """A restore that fails on the card (a sticky CUDA error, or no room
    for the restored copy) is not a corrupt checkpoint: the error
    propagates and every committed step stays as it was."""
    root = str(tmp_path / "c")
    port_res.run_resilient(manager=PortManager(root), **_kw(total_steps=6))
    committed = PortManager(root)._committed_steps()

    class CardFails(PortManager):
        def restore(self, *a, **kw):
            raise _card_errors()[kind]

    if when == "restart":  # the step-exception path's restore
        _arm(PORT, ("oom", dict(at_step=7)))
    with pytest.raises(type(_card_errors()[kind]), match="CUDA"):
        port_res.run_resilient(manager=CardFails(root), restart_backoff=0.001,
                               **_kw(total_steps=9 if when == "restart" else 6))
    assert not glob.glob(os.path.join(root, "*.corrupt"))
    assert PortManager(root)._committed_steps()[:len(committed)] == committed


def test_a_cuda_error_in_a_step_propagates_without_a_restart(tmp_path):
    """Only an OOM rides the in-process restart: after any other CUDA
    error the context may be poisoned, so the loop raises it at once."""
    def failing(params, opt, batch):
        if int(opt["m"][0]) == 7:
            raise RuntimeError(ILLEGAL_ADDRESS)
        return _step_fn(params, opt, batch)

    root = str(tmp_path / "c")
    port_tel.init(out_dir=None, memtrack=False)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port_res.run_resilient(manager=PortManager(root), **_kw(step_fn=failing))
    assert "resilience_restarts_total" not in port_tel.get_registry().snapshot()["counters"]
    assert not glob.glob(os.path.join(root, "*.corrupt"))
    assert PortManager(root).latest_step() == 5


# ------------------------------------------------------------ tiny Llama
LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)
LB, LT, LR = 2, 16, 1e-3


def _llama_tokens(i):
    return np.random.default_rng(100 + i).integers(0, LLAMA["vocab_size"], (LB, LT + 1)).astype(np.int32)


def _ref_llama():
    from vescale_tpu.models import llama as jl
    from vescale_tpu.models.nanogpt import cross_entropy_loss as jax_xent
    from vescale_tpu.parallel.optimizer import adamw_lowmem
    from vescale_tpu.train import make_train_step as jax_make_train_step

    jmodel = jl.Llama(jl.LlamaConfig(dtype=jnp.float32, **LLAMA))
    params = jmodel.init(jax.random.key(0), jnp.ones((LB, LT), jnp.int32))["params"]
    tx = adamw_lowmem(LR, state_dtype=jnp.float32)
    step = jax_make_train_step(jmodel, tx, lambda lg, b: jax_xent(lg, b["target"]), donate=False)

    def batch_fn(i):
        t = jnp.asarray(_llama_tokens(i))
        return {"input": t[:, :-1], "target": t[:, 1:]}

    return params, tx.init(params), step, batch_fn


def _port_llama(ref_params):
    """A fresh port model, optimizer and FunctionalStep on the reference's
    initial weights."""
    from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss, params_from_jax
    from vescale_tpu_torch.parallel import AdamWLowmem
    from vescale_tpu_torch.train import FunctionalStep, make_train_step

    model = Llama(LlamaConfig(dtype=torch.float32, **LLAMA),
                  params_from_jax(ref_params, device="cpu"), device="cpu")
    opt = AdamWLowmem(model.parameters(), LR, state_dtype=torch.float32)
    step = make_train_step(model, opt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
    return model, opt, FunctionalStep(step, model, opt)


def _port_batch(i):
    t = torch.from_numpy(_llama_tokens(i)).long()
    return {"input": t[:, :-1], "target": t[:, 1:]}


def _port_run(ref_params, root, total, **kw):
    model, opt, fstep = _port_llama(ref_params)
    # synchronous saves: a rollback right after an async save would race
    # its commit (the reference loop checks for a committed step first)
    res = port_res.run_resilient(step_fn=fstep, params=fstep.params, opt_state=fstep.opt_state,
                                 manager=PortManager(root), total_steps=total,
                                 batch_fn=_port_batch, save_every=2, async_save=False,
                                 install_signal_handlers=False, restart_backoff=0.001, **kw)
    return res, model, opt


def _bits(tree):
    from vescale_tpu_torch.checkpoint.planner import flatten_state

    return {k: torch.as_tensor(v).detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            for k, v in flatten_state(tree)}


def test_tiny_llama_through_both_loops_within_the_train_bound(tmp_path):
    """The reference loop over the reference step against the port loop
    over ``FunctionalStep``: the bound of tests/test_torch_train.py:171."""
    params, state, step, batch_fn = _ref_llama()
    ref = ref_res.run_resilient(step_fn=step, params=params, opt_state=state,
                                manager=RefManager(str(tmp_path / "ref")), total_steps=6,
                                batch_fn=batch_fn, save_every=2, async_save=False,
                                install_signal_handlers=False)
    got, _, _ = _port_run(params, str(tmp_path / "port"), 6)
    assert ref.status == got.status == "completed" and ref.step == got.step == 5
    want = [ref.losses[i] for i in range(6)]
    np.testing.assert_allclose([got.losses[i] for i in range(6)], want, rtol=1e-5, atol=0)
    assert RefManager(str(tmp_path / "ref"))._committed_steps() == \
        PortManager(str(tmp_path / "port"))._committed_steps()


def test_tiny_llama_faulted_run_is_bitwise_its_golden_run(tmp_path):
    """The unfaulted loop bitwise the bare step loop; then storage,
    NaN-burst, OOM and preemption faults and a resume on fresh objects:
    every loss, parameter and moment bitwise the uninterrupted run's, and
    restores copy into the live parameters."""
    params, _, _, _ = _ref_llama()
    golden, gmodel, gopt = _port_run(params, str(tmp_path / "golden"), 8)
    # the loop with nothing armed computes what the bare step loop does
    _, _, bare = _port_llama(params)
    bare_losses = [float(bare(bare.params, bare.opt_state, _port_batch(i))[2]) for i in range(8)]
    assert [np.float64(x).tobytes() for x in bare_losses] == \
        [np.float64(golden.losses[i]).tobytes() for i in range(8)]
    root = str(tmp_path / "faulted")
    port_res.faultsim.arm(port_res.parse_schedule(
        "storage_write:call=1;nonfinite_loss:step=3,count=2;oom:step=5;preempt:step=7"))
    try:
        r1, model, _ = _port_run(params, root, 8, anomaly=port_res.AnomalyPolicy(threshold=2))
        ptrs = [p.data_ptr() for p in model.parameters()]
    finally:
        port_res.faultsim.disarm()
    assert (r1.status, r1.step, r1.rollbacks, r1.restarts, r1.anomaly_steps,
            r1.emergency_save_step) == ("preempted", 6, 1, 1, 2, 6)
    assert [p.data_ptr() for p in model.parameters()] == ptrs  # restored in place
    r2, model2, opt2 = _port_run(params, root, 8)
    assert r2.status == "completed" and r2.step == 7
    losses = {**r1.losses, **r2.losses}
    assert [np.float64(losses[i]).tobytes() for i in range(8)] == \
        [np.float64(golden.losses[i]).tobytes() for i in range(8)]
    from vescale_tpu_torch.models import module_tree

    assert _bits(module_tree(model2)) == _bits(module_tree(gmodel))
    assert _bits(opt2.state_tree(model2)) == _bits(gopt.state_tree(gmodel))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A reference run checkpointed at step 3 is resumed by the port; the
    continuation is within the train bound of the reference's own."""
    import shutil

    params, state, step, batch_fn = _ref_llama()
    root = str(tmp_path / "ref")
    kw = dict(step_fn=step, batch_fn=batch_fn, save_every=2, async_save=False,
              install_signal_handlers=False)
    first = ref_res.run_resilient(params=params, opt_state=state, manager=RefManager(root),
                                  total_steps=4, **kw)
    assert first.step == 3 and RefManager(root).latest_step() == 3
    shutil.copytree(root, str(tmp_path / "port"))
    ref = ref_res.run_resilient(params=params, opt_state=state, manager=RefManager(root),
                                total_steps=8, **kw)
    # the port starts from other weights: everything comes from the checkpoint
    other, _, _, _ = _ref_llama()
    other = jax.tree_util.tree_map(lambda x: x * 0 + 1, other)
    got, _, opt = _port_run(other, str(tmp_path / "port"), 8)
    assert sorted(got.losses) == sorted(ref.losses) == [4, 5, 6, 7]
    np.testing.assert_allclose([got.losses[i] for i in range(4, 8)],
                               [ref.losses[i] for i in range(4, 8)], rtol=1e-5, atol=0)
    assert opt.param_groups[0]["step"] == 8


def test_adamw_lowmem_state_chunks_are_the_references(tmp_path):
    """The port's save of AdamWLowmem's state (fp32) gives the reference
    adamw_lowmem state's "arrays" block and byte-identical chunk files."""
    from vescale_tpu import checkpoint as ref_ckpt
    from vescale_tpu_torch import checkpoint as port_ckpt
    from vescale_tpu_torch.models import params_from_jax
    from vescale_tpu_torch.parallel.optimizer import EmptyState, ScaleByAdamLowmemState

    params, state, step, batch_fn = _ref_llama()
    for i in range(2):
        params, state, _ = step(params, state, batch_fn(i))
    ref_ckpt.save(str(tmp_path / "ref"), {"optimizer": state})
    model, opt, fstep = _port_llama(params)
    inner = state[0]
    opt.load_state_tree((ScaleByAdamLowmemState(
        torch.tensor(int(inner.count), dtype=torch.int32), params_from_jax(inner.mu, device="cpu"),
        params_from_jax(inner.nu, device="cpu")), EmptyState(), EmptyState()), model)
    assert opt.param_groups[0]["step"] == 2
    port_ckpt.save(str(tmp_path / "port"), {"optimizer": opt.state_tree(model)})
    metas = [json.load(open(tmp_path / d / "meta.json"))["arrays"] for d in ("ref", "port")]
    assert metas[0] == metas[1] and "optimizer/0/.count" in metas[0]
    assert {k for k in metas[0] if k.startswith("optimizer/0/.mu/")}
    for entry in metas[0].values():
        for c in entry["chunks"]:
            assert (tmp_path / "ref" / c["file"]).read_bytes() == \
                (tmp_path / "port" / c["file"]).read_bytes(), c["file"]


def test_async_save_then_in_place_step_restores_the_pre_step_values(tmp_path):
    """``save`` copies every tensor to host bytes before it returns, so a
    step that updates the parameters and moments in place while the writes
    are in flight cannot leak into the checkpoint."""
    params, _, _, _ = _ref_llama()
    model, opt, fstep = _port_llama(params)
    fstep(fstep.params, fstep.opt_state, _port_batch(0))
    before = (_bits(fstep.params), _bits(fstep.opt_state))
    mgr = PortManager(str(tmp_path / "c"))
    mgr.save(0, {"model": fstep.params, "optimizer": fstep.opt_state}, async_checkpoint=True)
    fstep(fstep.params, fstep.opt_state, _port_batch(1))
    assert _bits(fstep.params) != before[0]
    mgr.wait_pending()
    out = mgr.restore({"model": fstep.params, "optimizer": fstep.opt_state})
    assert (_bits(out["model"]), _bits(out["optimizer"])) == before


def test_the_step_keeps_its_storage_and_a_restored_tree_aliases_it(tmp_path):
    """The moments are updated in their own storage, so a state tree taken
    before a step names the live state after it; and a restored tree
    handed to ``FunctionalStep`` ends up pointing at the live tensors, so
    no second copy of the state lives through the next step."""
    from vescale_tpu_torch.checkpoint.planner import flatten_state

    def ptrs(params, opt_state):
        return {f"{top}/{k}": v.data_ptr() for top, tree in (("m", params), ("o", opt_state))
                for k, v in flatten_state(tree) if isinstance(v, torch.Tensor) and v.dim()}

    params, _, _, _ = _ref_llama()
    _, _, fstep = _port_llama(params)
    fstep(fstep.params, fstep.opt_state, _port_batch(0))
    before = ptrs(fstep.params, fstep.opt_state)
    mgr = PortManager(str(tmp_path / "c"))
    mgr.save(0, {"model": fstep.params, "optimizer": fstep.opt_state})
    fstep(fstep.params, fstep.opt_state, _port_batch(1))
    assert ptrs(fstep.params, fstep.opt_state) == before
    out = mgr.restore({"model": fstep.params, "optimizer": fstep.opt_state})
    want = (_bits(out["model"]), _bits(out["optimizer"]))
    assert set(ptrs(out["model"], out["optimizer"]).values()).isdisjoint(before.values())
    fstep.load(out["model"], out["optimizer"])
    assert ptrs(out["model"], out["optimizer"]) == before == ptrs(fstep.params, fstep.opt_state)
    assert (_bits(fstep.params), _bits(fstep.opt_state)) == want
    assert (_bits(out["model"]), _bits(out["optimizer"])) == want


# ------------------------------------------------------- the loader's retry
def test_loader_retry_absorbs_an_injected_fault(token_file, monkeypatch):
    monkeypatch.setenv("VESCALE_LOADER_RETRIES", "3")
    port_res.reset_default_policies()
    ref = RefLoader(token_file, batch=2, seq_len=16, seed=1)
    want = [ref.next()["input"] for _ in range(5)]
    ref.close()
    port_tel.init(out_dir=None, memtrack=False)
    port_res.faultsim.arm([port_res.Fault("loader_next", at_call=2)])
    a = PortLoader(token_file, batch=2, seq_len=16, seed=1, device="cpu")
    try:
        got = [a.next()["input"] for _ in range(5)]
    finally:
        a.close()
    assert port_res.faultsim.get_injector().fired_total["loader_next"] == 1
    for g, w in zip(got, want):  # the retried fetch is the clean run's batch
        np.testing.assert_array_equal(g.numpy(), w)
    reg = port_tel.get_registry()
    assert reg.counter("resilience_io_retries_total").value == 1
    assert reg.counter("resilience_loader_retries_total").value == 1
    assert reg.histogram("data_load_seconds").count == 5


def test_loader_retry_exhausted_reraises(token_file, monkeypatch):
    monkeypatch.setenv("VESCALE_LOADER_RETRIES", "2")
    port_res.reset_default_policies()
    port_tel.init(out_dir=None, memtrack=False)
    port_res.faultsim.arm([port_res.Fault("loader_next", at_call=0, count=10)])
    a = PortLoader(token_file, batch=2, seq_len=16, seed=1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="injected native loader"):
            a.next()
        assert a.batches_served == 0
    finally:
        a.close()
    assert port_tel.get_registry().counter("resilience_io_giveups_total").value == 1


def test_closed_loader_fails_without_retrying(token_file):
    import time

    a = PortLoader(token_file, batch=2, seq_len=16, seed=1, device="cpu")
    a.close()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="closed"):
        a.next()
    assert time.perf_counter() - t0 < 0.05


def test_a_distributed_optimizer_skip_reads_as_an_anomaly_and_replays_bitwise(tmp_path):
    """``DistributedOptimizer.state_tree`` carries ``loss_scale/skip_count``
    (what ``_skip_count`` reads): an inf in one step's gradient is skipped
    by the optimizer, counted as an anomaly by the loop, rolled back and
    replayed clean, and the run ends bitwise the unfaulted one."""
    from vescale_tpu_torch.models import Llama, LlamaConfig, cross_entropy_loss, params_from_jax
    from vescale_tpu_torch.parallel import AdamWLowmem, DistributedOptimizer
    from vescale_tpu_torch.resilience.loop import _skip_count
    from vescale_tpu_torch.train import FunctionalStep, make_train_step

    params, _, _, _ = _ref_llama()

    def build():
        model = Llama(LlamaConfig(dtype=torch.float32, **LLAMA),
                      params_from_jax(params, device="cpu"), device="cpu")
        dopt = DistributedOptimizer(lambda ps: AdamWLowmem(ps, LR, state_dtype=torch.float32),
                                    models=model, loss_scale="dynamic")
        step = make_train_step(model, dopt, lambda lg, b: cross_entropy_loss(lg, b["target"]))
        return model, dopt, FunctionalStep(step, model, dopt)

    def drive(fstep, root):
        return port_res.run_resilient(
            step_fn=fstep, params=fstep.params, opt_state=fstep.opt_state,
            manager=PortManager(root), total_steps=6, batch_fn=_port_batch, save_every=2,
            async_save=False, install_signal_handlers=False,
            anomaly=port_res.AnomalyPolicy(threshold=1))

    _, _, golden_step = build()
    assert _skip_count(golden_step.opt_state) == 0
    golden = drive(golden_step, str(tmp_path / "g"))
    model, dopt, fstep = build()
    real, poisoned = dopt.reduce_grads, []

    def reduce_grads(grads=None):
        if dopt.inner.param_groups[0]["step"] == 3 and not poisoned:
            poisoned.append(1)
            next(iter(model.parameters())).grad.view(-1)[0] = float("inf")
        return real(grads)

    dopt.reduce_grads = reduce_grads
    res = drive(fstep, str(tmp_path / "f"))
    assert (res.status, res.anomaly_steps, res.rollbacks) == ("completed", 1, 1)
    assert [np.float64(res.losses[i]).tobytes() for i in range(6)] == \
        [np.float64(golden.losses[i]).tobytes() for i in range(6)]
    assert _bits(fstep.opt_state) == _bits(golden_step.opt_state)
