"""Telemetry of the port.

  * **The global API** (``api.py``): ``init`` / ``shutdown`` gate one
    process-wide ``MetricsRegistry`` that the train step, the resilient
    loop, the checkpoint layer and the retry policies feed through
    ``count``, ``observe``, ``set_gauge``, ``record_step`` and
    ``record_event``; ``steps.jsonl`` under ``out_dir``.
  * **Exporters** (``exporters.py``): the JSONL stream, Prometheus text
    and the dashboard, with its ``resilience:`` and ``memory:`` blocks.
  * **Memory tracking** (``memtrack.py``, ``memory_report.py``): device
    gauges (host RSS without a card), the tagged census, leak detection,
    AOT-budget drift and the flight recorder.
  * **The serve path's registry** (``registry.Registry``): one a scheduler,
    read by the ops endpoints (``ops_server.py``).
  * **Step reports** (``step_report.py``): FLOPs, bytes, peak memory,
    collectives and the per-layer roofline of one measured step.
  * **The trace timeline** (``trace.py``, ``straggler.py``): clock
    offsets, merged Perfetto traces, critical paths, the per-step span
    rollup and the straggler detector over ndtimeline spans.
  * **History and alerts** (``timeseries.py``, ``alerts.py``): the tiered
    metric store and the SLO alert engine over it.
  * **Cost calibration and auditing** (``calibrate.py``, ``costaudit.py``):
    the measured collective-cost table and the predicted-vs-measured
    ledger with its calibration harvest.

Gating contract: a run that never calls ``telemetry.init()`` pays nothing
(no registry, no locks, no files; the hooks of memtrack, the store, the
alert engine and the auditor are no-op function references).
"""

from . import alerts, calibrate, costaudit, memtrack, ops_server, timeseries, trace
from .api import (
    count,
    dashboard,
    get_registry,
    get_state,
    init,
    is_active,
    observe,
    prometheus_dump,
    record_event,
    record_step,
    set_gauge,
    shutdown,
    write_step_report,
)
from .exporters import JsonlExporter, parse_prometheus_text, prometheus_text
from .memory_report import compare_with_aot, device_memory_stats
from .memtrack import dump_now, flight_recorder, tagged
from .registry import Counter, Gauge, Histogram, MetricsRegistry, Registry
from .step_report import build_step_report, read_step_report
from .straggler import StragglerDetector

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
    "MetricsRegistry",
    "Registry",
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlExporter",
    "prometheus_text",
    "parse_prometheus_text",
    "write_step_report",
    "build_step_report",
    "read_step_report",
    "StragglerDetector",
    "memtrack",
    "trace",
    "calibrate",
    "costaudit",
    "alerts",
    "timeseries",
    "ops_server",
    "compare_with_aot",
    "flight_recorder",
    "dump_now",
    "tagged",
    "device_memory_stats",
]
