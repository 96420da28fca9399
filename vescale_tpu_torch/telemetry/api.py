"""The telemetry API: the zero-overhead gate.

The port of ``vescale_tpu/telemetry/api.py``.  The runtime (the train
step, the resilient loop, the checkpoint layer, the retry policies) calls
the helpers here on every operation, and a run that never calls
``telemetry.init()`` pays nothing: ``is_active()`` is one module-global
check, and no registry, lock or file exists.

    from vescale_tpu_torch import telemetry

    telemetry.init(out_dir="/tmp/run0")        # flip the gate
    ... train ...                              # steps stream to steps.jsonl
    print(telemetry.dashboard())               # human summary
    telemetry.prometheus_dump()                # Prometheus text exposition
    telemetry.shutdown()

Step records land in ``<out_dir>/steps.jsonl``, one JSON object a step,
with the event lines of ``record_event`` between them; while ndtimeline
is active each step line carries its ``spans`` rollup, and while the cost
auditor has priced or harvested anything, its ``cost_audit`` join.
``write_step_report`` writes a step report next to them.  Every helper is
a no-op (returning None) while dormant.

``init`` also turns on the time-series store (``timeseries.py``), the
alert engine (``alerts.py``) and the cost auditor (``costaudit.py``),
each by default from its knob (``VESCALE_TIMESERIES``, ``VESCALE_ALERTS``,
``VESCALE_COSTAUDIT``, all on), as the reference does.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

from . import alerts as _alerts
from . import costaudit as _costaudit
from . import memtrack as _memtrack
from . import timeseries as _timeseries
from .exporters import JsonlExporter, dashboard as _dashboard, prometheus_text
from .registry import MetricsRegistry

__all__ = [
    "init",
    "shutdown",
    "is_active",
    "get_state",
    "get_registry",
    "record_step",
    "record_event",
    "observe",
    "count",
    "set_gauge",
    "prometheus_dump",
    "dashboard",
    "write_step_report",
]


class TelemetryState:
    """Everything a live telemetry run owns.  Exists only between ``init``
    and ``shutdown``: its absence IS the off state."""

    def __init__(self, out_dir: Optional[str], rank: int, window: int, jsonl: bool):
        self.out_dir = out_dir
        self.rank = rank
        self.registry = MetricsRegistry(default_window=window)
        self.step = 0
        self.jsonl: Optional[JsonlExporter] = None
        self.memtrack = None  # set by init() when memory tracking is on
        self.timeseries = None  # set by init() when the history store is on
        self.alerts = None  # set by init() when the alert engine is on
        self.costaudit = None  # set by init() when cost auditing is on
        self.last_step_report: Optional[Dict] = None  # the flight recorder's feed
        if jsonl and out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self.jsonl = JsonlExporter(os.path.join(out_dir, "steps.jsonl"))


_STATE: Optional[TelemetryState] = None


def init(
    out_dir: Optional[str] = None,
    rank: int = 0,
    window: int = 1024,
    jsonl: bool = True,
    memtrack: bool = True,
    memtrack_interval: int = 1,
    memtrack_history: int = 16,
    memtrack_leak_steps: int = 5,
    timeseries: Optional[bool] = None,
    timeseries_cadence_s: Optional[float] = None,
    alerts: Optional[bool] = None,
    costaudit: Optional[bool] = None,
) -> TelemetryState:
    """Activate telemetry.  ``out_dir=None`` keeps everything in memory
    (the registry only: no JSONL stream, no dump files).  Initialising
    again while active closes the previous state first (its registry is
    discarded).

    ``memtrack`` (default on) also activates memory tracking
    (``memtrack.py``): device gauges and the tagged census every
    ``memtrack_interval`` steps, a ``memtrack_history``-deep sample ring
    for the flight recorder, and a leak warning after
    ``memtrack_leak_steps`` steps of strictly growing untagged bytes.

    ``timeseries`` and ``alerts`` (default: the ``VESCALE_TIMESERIES`` and
    ``VESCALE_ALERTS`` knobs, both on) turn on the metric history store
    and the SLO alert engine, which evaluates over the store.
    ``costaudit`` (default: ``VESCALE_COSTAUDIT``, on) turns on the cost
    auditor: its prediction ledger, the per-step join and its
    ``cost-model-drift`` rule, and the calibration harvest."""
    from .. import config

    global _STATE
    if _STATE is not None:
        shutdown()
    _STATE = TelemetryState(out_dir, rank, window, jsonl)
    if memtrack:
        _STATE.memtrack = _memtrack.activate(history=memtrack_history,
                                             leak_steps=memtrack_leak_steps,
                                             census_interval=memtrack_interval)
    if timeseries is None:
        timeseries = config.get_bool("VESCALE_TIMESERIES")
    if alerts is None:
        alerts = config.get_bool("VESCALE_ALERTS")
    if timeseries:
        _STATE.timeseries = _timeseries.activate(
            _STATE.registry,
            cadence_s=(timeseries_cadence_s if timeseries_cadence_s is not None
                       else config.get_float("VESCALE_TIMESERIES_CADENCE_S")),
            base_len=config.get_int("VESCALE_TIMESERIES_BASE_LEN"),
            tier_factor=config.get_int("VESCALE_TIMESERIES_TIER_FACTOR"),
            tiers=config.get_int("VESCALE_TIMESERIES_TIERS"))
    if alerts:
        _STATE.alerts = _alerts.activate(
            store=_STATE.timeseries, history=config.get_int("VESCALE_ALERTS_HISTORY"),
            min_eval_interval_s=config.get_float("VESCALE_ALERTS_EVAL_INTERVAL_S"))
    if costaudit is None:
        costaudit = config.get_bool("VESCALE_COSTAUDIT")
    if costaudit:
        # after the alerts: activation arms the drift rule on a live engine
        _STATE.costaudit = _costaudit.activate(_STATE.registry)
    return _STATE


def shutdown() -> None:
    """Deactivate: close the JSONL stream and restore the no-op hooks of
    memtrack, the store, the alert engine and the cost auditor."""
    global _STATE
    if _STATE is not None and _STATE.jsonl is not None:
        _STATE.jsonl.close()
    _costaudit.deactivate()
    _memtrack.deactivate()
    _alerts.deactivate()
    _timeseries.deactivate()
    _STATE = None


def is_active() -> bool:
    return _STATE is not None


def get_state() -> Optional[TelemetryState]:
    return _STATE


def get_registry() -> Optional[MetricsRegistry]:
    return _STATE.registry if _STATE is not None else None


# ------------------------------------------------------------- hot helpers
# Each is a one-branch no-op while dormant: the runtime calls them
# unconditionally, and runs without telemetry must not allocate or lock.

def record_step(metrics: Dict[str, Any], kind: str = "train") -> None:
    """Ingest one step's metrics (the train step's feed; a serve loop
    passes ``kind="serve"``).

    Train conventions: ``step_time_s`` feeds the step-time histogram,
    ``tokens`` the throughput counter, and the scalars (``loss``,
    ``grad_norm``, ``loss_scale``, ``skip_count``) become gauges.  The
    whole record (plus ``step``, ``rank`` and ``ts``) goes to
    steps.jsonl.  ``kind="serve"`` skips the ``train_*`` conventions but
    keeps the step counter, the memory sample and the ``spans`` rollup.

    The step boundary is also where the auditor joins (its gauges first),
    the store samples and the alert engine evaluates."""
    st = _STATE
    if st is None:
        return
    st.step = int(metrics.get("step", st.step + 1))
    reg = st.registry
    if kind == "train":
        reg.counter("train_steps_total").inc()
        if "step_time_s" in metrics:
            reg.histogram("train_step_time_seconds").observe(metrics["step_time_s"])
        if "tokens" in metrics:
            reg.counter("train_tokens_total").inc(metrics["tokens"])
        if "tokens_per_sec" in metrics:
            reg.gauge("train_tokens_per_sec").set(metrics["tokens_per_sec"])
        for key, gname in (("loss", "train_loss"), ("grad_norm", "train_grad_norm"),
                           ("loss_scale", "train_loss_scale"),
                           ("skip_count", "train_skipped_steps")):
            if key in metrics and metrics[key] is not None:
                reg.gauge(gname).set(float(metrics[key]))
        if metrics.get("overflow"):
            reg.counter("train_overflow_steps_total").inc()
    mem = None
    if st.memtrack is not None:
        # device gauges, tagged census, leak check (None on the steps the
        # census interval skips: the jsonl line then has no "memory")
        mem = st.memtrack.on_step(st.step, reg)
    audit = _costaudit.audit_step(kind)
    _timeseries.sample(kind)
    _alerts.evaluate()
    if st.jsonl is not None:
        rec = {"step": st.step, "rank": st.rank, "ts": time.time(), **metrics}
        if kind != "train":
            rec["kind"] = kind
        if mem is not None:
            rec["memory"] = mem
        spans = _step_spans()
        if spans is not None:
            rec["spans"] = spans
        if audit is not None:
            rec["cost_audit"] = audit
        st.jsonl.emit(rec)


def _step_spans():
    """The ``spans`` object of a steps.jsonl line (``{metric: {count,
    total_ms}}`` of the step just recorded) while ndtimeline is active,
    else None.  The ring is peeked, never drained."""
    from ..ndtimeline.api import is_active as _nd_active

    if not _nd_active():
        return None
    from .trace import step_span_summary

    return step_span_summary()


def record_event(kind: str, **fields) -> None:
    """Append an EVENT line to steps.jsonl (the resilient loop's restarts,
    rollbacks, preemptions, quarantines): ``{"event": kind, "step":
    <current>, ...fields}``.  No-op while dormant or without a stream."""
    st = _STATE
    if st is None or st.jsonl is None:
        return
    st.jsonl.emit({"event": kind, "step": st.step, "rank": st.rank, "ts": time.time(),
                   **fields})


def observe(name: str, value: float) -> None:
    if _STATE is not None:
        _STATE.registry.histogram(name).observe(value)


def count(name: str, n: float = 1) -> None:
    if _STATE is not None:
        _STATE.registry.counter(name).inc(n)


def set_gauge(name: str, value: float) -> None:
    if _STATE is not None:
        _STATE.registry.gauge(name).set(value)


# ----------------------------------------------------------------- outputs
def write_step_report(name: str, fn: Callable, *args, aot_report=None,
                      **kwargs) -> Optional[Dict]:
    """Build a step report of one run of ``fn(*args, **kwargs)``
    (``step_report.py``) and, with an ``out_dir``, write it as
    ``<out_dir>/<name>_report.json``.  No-op while dormant.

    ``aot_report``: the path or dict of a matching ``AOT_*_REPORT.json``;
    the report gains an ``aot_drift`` section, the budget is ledgered as a
    prediction joined to the measured peak, and drift beyond 10% raises
    the ``aot-drift-<name>`` alert."""
    st = _STATE
    if st is None:
        return None
    from .step_report import build_step_report, write_step_report as _write

    report = build_step_report(fn, *args, name=name, aot_report=aot_report, **kwargs)
    st.last_step_report = report  # the flight recorder's feed
    if st.out_dir is not None:
        _write(report, os.path.join(st.out_dir, f"{name}_report.json"))
    if report.get("flops") is not None:
        st.registry.gauge(f"step_report_{name}_flops").set(report["flops"])
    if report.get("peak_bytes") is not None:
        st.registry.gauge(f"step_report_{name}_peak_bytes").set(report["peak_bytes"])
    drift = report.get("aot_drift")
    if drift is not None:
        pid = _costaudit.record_prediction(
            "aot_memory", predicted_bytes=drift["aot_bytes"], unit="bytes",
            detail={"name": name, "source": drift["aot_source"]})
        _costaudit.record_measurement(pid, measured_bytes=drift["measured_bytes"])
        st.registry.gauge(f"step_report_{name}_aot_drift_frac").set(drift["drift_frac"])
        if drift["exceeds_tolerance"]:
            _alerts.raise_alert(
                f"aot-drift-{name}",
                message=(f"step report {name!r}: measured memory peak "
                         f"{drift['measured_bytes']:.3e} B drifts "
                         f"{drift['drift_frac'] * 100:+.1f}% from the AOT budget "
                         f"{drift['aot_bytes']:.3e} B ({drift['aot_source']}) — beyond the "
                         "10% tolerance; re-derive the AOT report or find the regression."),
                severity="warning", value=drift["drift_frac"])
        else:
            _alerts.resolve(f"aot-drift-{name}")
    return report


def prometheus_dump(path: Optional[str] = None) -> Optional[str]:
    """The live registry as Prometheus text, also written to ``path``
    (default ``<out_dir>/metrics.prom``) when there is an out_dir.  None
    while dormant."""
    st = _STATE
    if st is None:
        return None
    text = prometheus_text(st.registry)
    target = path or (os.path.join(st.out_dir, "metrics.prom") if st.out_dir else None)
    if target is not None:
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        with open(target, "w") as f:
            f.write(text)
    return text


def dashboard(title: str = "vescale_tpu telemetry") -> Optional[str]:
    return _dashboard(_STATE.registry, title) if _STATE is not None else None
