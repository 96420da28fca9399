"""Telemetry of the port.

  * **The global API** (``api.py``): ``init`` / ``shutdown`` gate one
    process-wide ``MetricsRegistry`` that the train step, the resilient
    loop, the checkpoint layer and the retry policies feed through
    ``count``, ``observe``, ``set_gauge``, ``record_step`` and
    ``record_event``; ``steps.jsonl`` under ``out_dir``.
  * **Exporters** (``exporters.py``): the JSONL stream, Prometheus text
    and the dashboard, with its ``resilience:`` and ``memory:`` blocks.
  * **Memory tracking** (``memtrack.py``, ``memory_report.py``): device
    gauges (host RSS without a card), the tagged census, leak detection
    and the OOM flight recorder.
  * **The serve path's registry** (``registry.Registry``): one a scheduler,
    read by the ops endpoints (``ops_server.py``).

Gating contract: a run that never calls ``telemetry.init()`` pays nothing
(no registry, no locks, no files; memtrack's hooks are no-op function
references).  Not ported yet (ROADMAP A14): alerts, the time-series store,
the cost auditor, calibration, traces, the straggler detector, step
reports and ndtimeline.
"""

from . import memtrack
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
)
from .exporters import JsonlExporter, parse_prometheus_text, prometheus_text
from .memory_report import device_memory_stats
from .memtrack import dump_now, flight_recorder, tagged
from .registry import Counter, Gauge, Histogram, MetricsRegistry, Registry

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
    "memtrack",
    "flight_recorder",
    "dump_now",
    "tagged",
    "device_memory_stats",
]
