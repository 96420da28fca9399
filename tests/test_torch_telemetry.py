"""The port's telemetry core (``vescale_tpu_torch.telemetry``: the API,
the registry, the exporters and memtrack) against the JAX package's, on
the CPU.

  * The same sequence of ``count``, ``observe``, ``set_gauge``,
    ``record_step`` and ``record_event`` calls into both packages gives the
    same Prometheus text, the same parsed series, the same ``steps.jsonl``
    records (wall-clock fields aside) and the same dashboard text (the
    reference with its time-series store, alert engine and cost auditor
    off, the port's ``memory:`` lines aside).
  * memtrack: tags by weakref, the census by owner, the leak warning after
    ``leak_steps`` steps of growing untagged bytes, flight-record keys
    equal to the reference's, ``torch.cuda.OutOfMemoryError`` recognised
    as an OOM, and the no-op hooks while off.
  * The watchdog's hang dump carries the flight record; the checkpoint
    layer and the train step feed the registry; ``init`` refuses the
    subsystems the port does not have.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from vescale_tpu import telemetry as ref_tel
from vescale_tpu.telemetry import memtrack as ref_memtrack
from vescale_tpu.telemetry.registry import MetricsRegistry as RefRegistry

from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.telemetry import api as tel_api
from vescale_tpu_torch.telemetry import memtrack
from vescale_tpu_torch.telemetry.exporters import sanitize_metric_name
from vescale_tpu_torch.telemetry.registry import MetricsRegistry

from test_torch_ndtimeline import reset_all


@pytest.fixture(autouse=True)
def _reset():
    # both packages dormant at the start too: a test file run earlier on this
    # worker (tests/test_trace.py) can leave the reference's ndtimeline on,
    # which adds a spans rollup to the reference's records only
    reset_all()
    yield
    tel.shutdown()
    ref_tel.shutdown()


def _ref_init(**kw):
    return ref_tel.init(timeseries=False, alerts=False, costaudit=False, **kw)


def _init(**kw):
    """The port with the three subsystems off, as ``_ref_init`` runs the
    reference (tests/test_torch_trace.py holds them on, both sides)."""
    return tel.init(timeseries=False, alerts=False, costaudit=False, **kw)


# ------------------------------------------------------------------- gate
def test_dormant_helpers_are_noops_and_allocate_nothing(tmp_path):
    assert not tel.is_active() and tel_api._STATE is None
    assert tel.record_step({"loss": 1.0, "step_time_s": 0.1}) is None
    assert tel.observe("x", 1.0) is None and tel.count("y") is None
    assert tel.set_gauge("z", 2.0) is None and tel.record_event("e") is None
    assert tel.prometheus_dump() is None and tel.dashboard() is None
    assert tel.get_registry() is None and tel_api._STATE is None
    assert list(tmp_path.iterdir()) == []


def test_init_shutdown_cycle_and_refused_subsystems(tmp_path, monkeypatch):
    """The cycle, and the three subsystems the reference turns on from its
    knobs: each comes on with ``True``, goes with ``shutdown``, and
    defaults to its knob (all three on)."""
    from vescale_tpu_torch.telemetry import alerts, costaudit, timeseries

    st = tel.init(out_dir=str(tmp_path / "run"))
    assert tel.is_active() and tel.get_state() is st and st.memtrack is memtrack.get_tracker()
    assert st.timeseries is not None and st.alerts is not None and st.costaudit is not None
    tel.count("c", 2)
    assert tel.get_registry().counter("c").value == 2
    tel.shutdown()
    assert not tel.is_active() and tel.get_registry() is None
    assert memtrack.tag_array is memtrack._noop_tag_array
    off = dict(timeseries=False, alerts=False, costaudit=False)
    for name, mod in (("alerts", alerts), ("timeseries", timeseries), ("costaudit", costaudit)):
        st = tel.init(out_dir=None, **{**off, name: True})
        assert getattr(st, name) is not None and mod.is_active()
        tel.shutdown()
        assert not mod.is_active()
    monkeypatch.setenv("VESCALE_ALERTS", "0")
    st = tel.init(out_dir=None, alerts=None, timeseries=False)  # the knob turns it off
    assert tel.is_active() and st.alerts is None and not alerts.is_active()


# --------------------------------------------------------------- registry
def test_registry_metrics_percentiles_and_kinds_equal_the_reference():
    regs = (MetricsRegistry(default_window=16), RefRegistry(default_window=16))
    for reg in regs:
        reg.counter("n").inc(3)
        reg.gauge("g").set(1.5)
        h = reg.histogram("h")
        for v in range(1, 101):
            h.observe(float(v))
        reg.histogram("empty")
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].snapshot()["histograms"]["h"]["p50"] == 92.0
    with pytest.raises(ValueError):
        regs[0].counter("n").inc(-1)
    with pytest.raises(TypeError):
        regs[0].gauge("n")


def _feed(pkg, out_dir):
    """One sequence of calls: every dashboard block, odd names, NaN and
    infinite values, step records and events."""
    pkg.count("resilience_rollbacks_total")
    pkg.count("resilience_io_retries_total", 2)
    pkg.count("consistency_checks_total", 3)
    pkg.count("checkpoint_saves_total", 4)
    pkg.count("checkpoint_bytes_written_total", 123456789)
    pkg.count("grad_compress_bytes_saved_total", 5 * 2**20)
    pkg.count("grad_compress_calls_total", 7)
    pkg.set_gauge("grad_compress_ratio", 3.7)
    pkg.count("redistribute.quant_hops", 2)
    pkg.count("serve_completed_total", 16)
    pkg.set_gauge("serve_in_flight", 3)
    pkg.count("fleet_dispatch_total", 9)
    pkg.set_gauge("fleet_timeline_goodput", 0.25)
    pkg.count("kernel_flash_dispatch_total", 12)
    pkg.count("trace_merged_total")
    pkg.set_gauge("critical_path_len", 4)
    pkg.count("alerts_fired_total")
    pkg.set_gauge("cost_model_divergence", 1.5)
    pkg.set_gauge("resilience_last_reshard_seconds", 0.125)
    pkg.set_gauge("odd-name/with.dots", float("nan"))
    pkg.set_gauge("big", float("inf"))
    pkg.set_gauge("mem_tag_params_bytes", 3 * 2**30)
    for i in range(5):
        pkg.observe("checkpoint_save_seconds", 0.1 * (i + 1))
        pkg.record_step({"step_time_s": 0.5 + i / 8, "loss": 3.0 - i / 4, "tokens": 2048,
                         "tokens_per_sec": 4096.0, "skip_count": 0})
        if i == 2:
            pkg.record_event("resilience_rollback", bad_step=2, restored_step=1,
                             data_skipped=False)
    pkg.record_step({"step": 40, "loss": 1.0, "overflow": True, "grad_norm": None})
    pkg.record_step({"step": 41}, kind="serve")
    pkg.observe("empty_hist_never", 0.0)


def _records(out_dir):
    out = []
    for line in open(os.path.join(out_dir, "steps.jsonl")):
        rec = json.loads(line)
        rec.pop("ts")
        out.append(rec)
    return out


def test_same_calls_give_the_references_exports(tmp_path):
    _ref_init(out_dir=str(tmp_path / "ref"), memtrack=False)
    _feed(ref_tel, str(tmp_path / "ref"))
    _init(out_dir=str(tmp_path / "port"), memtrack=False)
    _feed(tel, str(tmp_path / "port"))
    from vescale_tpu.telemetry.exporters import parse_prometheus_text as ref_parse

    ref_text, got_text = ref_tel.prometheus_dump(), tel.prometheus_dump()
    assert got_text == ref_text
    got_series, want_series = tel.parse_prometheus_text(got_text), ref_parse(ref_text)
    assert got_series.keys() == want_series.keys() and got_series
    for k in want_series:  # NaN-safe
        assert np.float64(got_series[k]).tobytes() == np.float64(want_series[k]).tobytes(), k
    assert open(tmp_path / "port" / "metrics.prom").read() == ref_text
    assert _records(tmp_path / "port") == _records(tmp_path / "ref")
    got, want = tel.dashboard(), ref_tel.dashboard()
    assert got == want
    assert "resilience:" in got and "memory:" in got and "grad-compression:" in got
    assert sanitize_metric_name("odd-name/with.dots") == "odd_name_with_dots"
    with pytest.raises(ValueError):
        tel.parse_prometheus_text("bad line here\n")


def test_dashboard_equal_with_memtrack_on_but_for_the_memory_lines(tmp_path):
    _ref_init(out_dir=None, memtrack=True)
    _init(out_dir=None, memtrack=True)
    for pkg in (ref_tel, tel):
        pkg.count("resilience_restarts_total")
        pkg.record_step({"step_time_s": 0.25, "loss": 2.0})

    def strip(text):
        lines, skip = [], False
        for ln in text.splitlines():
            if ln.startswith("memory:"):
                skip = True
                continue
            if skip and ln.startswith("  "):
                continue
            skip = False
            lines.append(ln)
        return lines

    assert strip(tel.dashboard()) == strip(ref_tel.dashboard())
    assert "memory:" in tel.dashboard()


# ---------------------------------------------------------------- memtrack
def test_memtrack_hooks_are_noops_while_off():
    assert memtrack.tag_array is memtrack._noop_tag_array
    assert memtrack.tag_tree is memtrack._noop_tag_tree
    x = torch.ones(4)
    assert memtrack.tag_array(x, "params") is x and memtrack.dump_now() is None
    with memtrack.tagged("params"):
        assert memtrack.tag_array(x) is x
    assert not memtrack._TAG_STACK and memtrack.get_tracker() is None
    tel.init(out_dir=None, memtrack=False)
    assert memtrack.tag_array is memtrack._noop_tag_array


def test_memtrack_tags_census_and_weakrefs():
    tel.init(out_dir=None)
    tracker = memtrack.get_tracker()
    w = torch.zeros(16, 16)
    with memtrack.tagged("params"):
        memtrack.tag_array(w)
    g = memtrack.tag_array(torch.ones(8, 8), "grads")
    memtrack.tag_tree({"a": [torch.ones(3)], "b": None}, "optimizer_state")
    assert tracker.tag_of(w) == "params" and tracker.tag_of(g) == "grads"
    census = tracker.census()
    assert census["tags"]["params"]["bytes"] == 16 * 16 * 4
    assert census["tags"]["grads"]["bytes"] == 8 * 8 * 4
    assert census["top_arrays"][0]["bytes"] >= 16 * 16 * 4
    a = torch.ones(32) * 3
    memtrack.tag_array(a, "grads")
    n = tracker.num_tagged
    del a
    import gc

    gc.collect()
    assert tracker.num_tagged == n - 1  # the weakref evicted it
    for i in range(3):
        tel.record_step({"step": i, "step_time_s": 0.01, "loss": 1.0})
    names = tel.get_registry().names()
    assert {"mem_tag_params_bytes", "mem_live_arrays", "mem_host_rss_bytes"} <= set(names)
    assert len(tracker.history) == 3 and tracker.history[-1]["tags"]["params"] == 1024


def test_memtrack_census_interval_and_history_ring():
    tel.init(out_dir=None, memtrack_interval=2, memtrack_history=2)
    for i in range(6):
        tel.record_step({"step": i, "step_time_s": 0.01})
    assert [h["step"] for h in memtrack.get_tracker().history] == [2, 4]


def test_leak_warning_after_growing_untagged_bytes():
    import gc

    from vescale_tpu_torch.telemetry import alerts

    gc.collect()  # earlier tests' garbage must not be freed mid-run
    alerts.clear_fallback_warned()  # the warning is once a rule a process
    _init(out_dir=None, memtrack_leak_steps=3)  # the engine off: the one-shot warning
    hoard = []
    with pytest.warns(UserWarning, match="possible leak"):
        for i in range(1, 6):
            hoard.append(torch.ones(65536 * i) + i)  # untagged, growing every step
            tel.record_step({"step": i, "step_time_s": 0.01})
    reg = tel.get_registry()
    assert reg.counter("mem_leak_warnings_total").value == 1  # once per run of growth
    assert reg.gauge("mem_untagged_growth_steps").value >= 3


def test_no_leak_warning_on_stable_memory(recwarn):
    tel.init(out_dir=None, memtrack_leak_steps=3)
    for i in range(6):
        tel.record_step({"step": i, "step_time_s": 0.01})
    assert not any("possible leak" in str(w.message) for w in recwarn.list)
    assert tel.get_registry().get("mem_leak_warnings_total") is None


def test_flight_record_keys_equal_the_references(tmp_path):
    import jax.numpy as jnp

    _ref_init(out_dir=str(tmp_path / "ref"))
    keep_ref = ref_memtrack.tag_array(jnp.ones(32), "params")  # noqa: F841
    ref_tel.record_step({"step": 1, "step_time_s": 0.01})
    want = ref_tel.dump_now(reason="test")
    tel.init(out_dir=str(tmp_path / "port"))
    keep = memtrack.tag_array(torch.ones(32), "params")  # noqa: F841
    tel.record_step({"step": 1, "step_time_s": 0.01})
    got = tel.dump_now(reason="test")
    assert set(got) == set(want)
    assert set(got["census"]) == set(want["census"])
    assert set(got["device_memory"][0]) >= {"device", "platform", "source", "bytes_in_use",
                                            "peak_bytes_in_use", "bytes_limit"}
    assert got["census"]["tags"]["params"]["bytes"] == 128 and got["history"]
    assert got["registry"]["counters"]["train_steps_total"] == 1
    assert json.load(open(got["path"]))["reason"] == "test"
    assert os.path.basename(got["path"]) == os.path.basename(want["path"])
    assert tel.get_registry().counter("mem_flight_records_total").value == 1


def test_oom_is_recognised_and_dumped(tmp_path):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert memtrack._is_oom(oom)
    assert memtrack._is_oom(RuntimeError("RESOURCE_EXHAUSTED: [faultsim] injected out-of-memory"))
    assert not memtrack._is_oom(ValueError("not an oom"))
    assert memtrack.maybe_dump_oom(oom) is None  # dormant

    @tel.flight_recorder
    def step(exc):
        raise exc

    tel.init(out_dir=str(tmp_path))
    with pytest.raises(ValueError):
        step(ValueError("not an oom"))
    assert not [f for f in os.listdir(tmp_path) if f.startswith("flight_record_")]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        step(oom)
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flight_record_")]
    assert len(dumps) == 1
    doc = json.load(open(tmp_path / dumps[0]))
    assert doc["reason"] == "oom:OutOfMemoryError" and "CUDA out of memory" in doc["exception"]


def test_watchdog_hang_dump_carries_the_flight_record(tmp_path):
    from vescale_tpu_torch.resilience import Watchdog

    tel.init(out_dir=str(tmp_path))
    wd = Watchdog(timeout_s=0.2, poll_s=0.05, abort=False).start()
    try:
        wd.beat(7)
        deadline = time.monotonic() + 10
        while wd.last_bundle is None and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    bundle = wd.last_bundle
    assert wd.fired == 1 and bundle["step"] == 7
    assert os.path.exists(bundle["flight_record"])
    assert json.load(open(bundle["flight_record"]))["reason"] == "watchdog_hang@step7"
    assert bundle["path"].startswith(str(tmp_path))  # telemetry's out_dir
    reg = tel.get_registry()
    assert reg.counter("resilience_hang_detected_total").value == 1
    events = [json.loads(l) for l in open(tmp_path / "steps.jsonl")]
    # the stall also fires the alert engine's watchdog-stall rule (the
    # engine is on by default, as in the reference)
    assert [e["event"] for e in events] == ["resilience_hang", "alert"]
    assert (events[1]["rule"], events[1]["transition"]) == ("watchdog-stall", "ok->firing")


# --------------------------------------------------------- the runtime feeds
def test_checkpoint_feeds_the_registry_and_tags_loaded_buffers(tmp_path):
    from vescale_tpu_torch import checkpoint as ckpt

    tel.init(out_dir=None)
    state = {"model": {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}}
    ckpt.save(str(tmp_path / "ck"), state)
    out = ckpt.load(str(tmp_path / "ck"), state)
    snap = tel.get_registry().snapshot()
    c = snap["counters"]
    assert c["checkpoint_saves_total"] == c["checkpoint_commits_total"] == 1
    assert c["checkpoint_bytes_written_total"] == 256
    assert c["checkpoint_loads_total"] == 1 and c["checkpoint_bytes_read_total"] > 256
    assert {"checkpoint_save_seconds", "checkpoint_load_seconds",
            "checkpoint_commit_seconds"} <= set(snap["histograms"])
    assert memtrack.get_tracker().tag_of(out["model"]["w"]) == "checkpoint_buffers"


def test_train_step_feeds_record_step(tmp_path):
    from vescale_tpu_torch import bench

    run = bench.prepare("gpt_cpu")
    try:
        batch = run.next_batch()
        run.step(batch)  # dormant: nothing recorded
        tel.init(out_dir=str(tmp_path))
        loss = run.step(batch)
    finally:
        run.close()
    reg = tel.get_registry()
    assert reg.counter("train_steps_total").value == 1
    assert reg.counter("train_tokens_total").value == batch["input"].numel()
    assert reg.gauge("train_loss").value == float(loss)
    rec = json.loads(open(tmp_path / "steps.jsonl").readline())
    assert rec["loss"] == float(loss) and rec["tokens"] == batch["input"].numel()
    assert rec["step_time_s"] > 0 and "memory" in rec
