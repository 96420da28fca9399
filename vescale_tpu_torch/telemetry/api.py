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
with the event lines of ``record_event`` between them.  Every helper is a
no-op (returning None) while dormant.

Not ported (ROADMAP A14): the time-series store, the alert engine and the
cost auditor.  ``init`` raises ``NotImplementedError`` when asked for any
of them with ``True``, and leaves them off when given ``None``.  The
reference turns them on from ``VESCALE_TIMESERIES``, ``VESCALE_ALERTS``
and ``VESCALE_COSTAUDIT``; the port registers none of those knobs until
it ports the subsystems, so setting one changes nothing here.  ``write_step_report``
waits for the step report, and the per-step ``spans`` rollup for
ndtimeline.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from . import memtrack as _memtrack
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

    ``timeseries``, ``alerts`` and ``costaudit``: see the module
    docstring; ``True`` raises, ``None`` and ``False`` leave them off."""
    global _STATE
    wanted = [name for name, on in (("timeseries", timeseries), ("alerts", alerts),
                                    ("costaudit", costaudit)) if on]
    if wanted:
        raise NotImplementedError(
            f"telemetry.init({', '.join(f'{n}=True' for n in wanted)}): the port has no "
            "time-series store, alert engine or cost auditor yet (ROADMAP A14)")
    del timeseries_cadence_s  # the time-series store's; kept for the signature
    if _STATE is not None:
        shutdown()
    _STATE = TelemetryState(out_dir, rank, window, jsonl)
    if memtrack:
        _STATE.memtrack = _memtrack.activate(history=memtrack_history,
                                             leak_steps=memtrack_leak_steps,
                                             census_interval=memtrack_interval)
    return _STATE


def shutdown() -> None:
    """Deactivate: close the JSONL stream and restore memtrack's no-op
    hooks."""
    global _STATE
    if _STATE is not None and _STATE.jsonl is not None:
        _STATE.jsonl.close()
    _memtrack.deactivate()
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
    keeps the step counter and the memory sample."""
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
    if st.jsonl is not None:
        rec = {"step": st.step, "rank": st.rank, "ts": time.time(), **metrics}
        if kind != "train":
            rec["kind"] = kind
        if mem is not None:
            rec["memory"] = mem
        st.jsonl.emit(rec)


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
