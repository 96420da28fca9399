"""Telemetry exporters: the per-step JSONL stream, the Prometheus text
exposition and a human-readable dashboard.

The port of ``vescale_tpu/telemetry/exporters.py``.  All three read the
same ``MetricsRegistry`` snapshot; the JSONL exporter also receives each
step record as it is emitted (the stream a dashboard tails).  For the same
metrics the text is the reference's, line for line: the dashboard's
blocks (``resilience:`` with the ``resilience_*`` and ``consistency_*``
series, ``memory:`` with the ``mem_*`` gauges, and the others) are cut
by the same name prefixes.  The ``alerts:`` block names the live
engine's firing and pending rules, and a ``timeseries:`` block describes
the live time-series store, as the reference's do.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
from typing import Dict, Optional, TextIO

from .registry import MetricsRegistry

__all__ = [
    "JsonlExporter",
    "prometheus_text",
    "parse_prometheus_text",
    "dashboard",
    "sanitize_metric_name",
]

# Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")
# one exposition line: name{labels}? value  (value: float/int/NaN/+-Inf)
_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(-?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|NaN|[+-]?Inf))$"
)


def sanitize_metric_name(name: str) -> str:
    """Map an internal metric name onto the Prometheus charset."""
    if _NAME_OK.match(name):
        return name
    fixed = _NAME_FIX.sub("_", name)
    if not re.match(r"[a-zA-Z_:]", fixed[:1] or "_"):
        fixed = "_" + fixed
    return fixed


class JsonlExporter:
    """Appends one JSON object a record to ``path``.  Opens lazily and
    flushes each line: a crashed run keeps every completed step."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[TextIO] = None
        self._lock = threading.Lock()
        self.emitted = 0

    def emit(self, record: Dict) -> None:
        line = json.dumps(record, default=str)
        with self._lock:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
            self.emitted += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def prometheus_text(registry) -> str:
    """The registry (a ``MetricsRegistry`` or a serve scheduler's
    ``Registry``) in the Prometheus text exposition format (0.0.4):
    histograms as summaries (``{quantile="..."}`` plus ``_count`` and
    ``_sum``)."""
    snap = registry.snapshot()
    lines = []
    for name in sorted(snap["counters"]):
        pname = sanitize_metric_name(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {_fmt(snap['counters'][name])}")
    for name in sorted(snap["gauges"]):
        pname = sanitize_metric_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {_fmt(snap['gauges'][name])}")
    for name in sorted(snap["histograms"]):
        pname = sanitize_metric_name(name)
        h = snap["histograms"][name]
        lines.append(f"# TYPE {pname} summary")
        for label, q in (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99")):
            if label in h:
                lines.append(f'{pname}{{quantile="{q}"}} {_fmt(h[label])}')
        lines.append(f"{pname}_count {_fmt(h['count'])}")
        lines.append(f"{pname}_sum {_fmt(h['sum'])}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"  # the canonical Prometheus spelling (repr gives 'nan')
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f.is_integer() else repr(f)


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Strict parser of the exposition format this module emits: returns
    ``{series: value}`` with the label set kept in the key, and raises
    ``ValueError`` on any non-comment line it cannot parse."""
    out: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(f"prometheus text line {lineno} unparseable: {line!r}")
        name, labels, value = m.groups()
        out[name + (labels or "")] = float(value)
    return out


def _fmt_bytes(v: float) -> str:
    """A byte count for the dashboard's memory block."""
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024.0 or unit == "TiB":
            return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024.0
    return f"{v:.1f} TiB"


# the dashboard's blocks after "counters:" and "gauges:", in order: title
# and name prefixes.  A block's counters print before its gauges; a
# "bytes" counter of grad-compression prints as a byte count.
_BLOCKS = (
    ("grad-compression:", ("grad_compress_", "redistribute.quant")),
    ("trace:", ("trace_",)),
    ("critical-path:", ("critical_path_",)),
    ("kernels:", ("kernel_",)),
    ("serving:", ("serve_",)),
    ("fleet:", ("fleet_",)),
    ("fleet-timeline:", ("fleet_timeline_",)),
    ("cost-model:", ("cost_model_",)),
    ("alerts:", ("alerts_",)),
    ("resilience:", ("resilience_", "consistency_")),
)
_ALL_PREFIXES = tuple(p for _, ps in _BLOCKS for p in ps)


def _in_block(name: str, prefixes) -> bool:
    if not name.startswith(prefixes):
        return False
    # fleet_timeline_ is carved out of the fleet_ block
    return not (prefixes == ("fleet_",) and name.startswith("fleet_timeline_"))


def _alert_lines():
    """The live alert engine's firing and pending rule names."""
    from . import alerts as _alerts

    eng = _alerts.get_engine()
    if eng is None:
        return []
    firing, pending = eng.firing(), eng.pending()
    out = [f"  firing:  {', '.join(firing) if firing else '(none)'}"]
    if pending:
        out.append(f"  pending: {', '.join(pending)}")
    return out


def _timeseries_lines():
    """The live time-series store's shape: what the alert rules read."""
    from . import timeseries as _timeseries

    store = _timeseries.get_store()
    if store is None:
        return []
    s = store.stats()
    shape = f"{s['tiers']} x {s['base_len']} @ /{s['tier_factor']}"
    return ["timeseries:",
            f"  {'timeseries_series':<48} {_fmt(s['series']):>12}",
            f"  {'timeseries_retained_samples':<48} {_fmt(s['retained_samples']):>12}",
            f"  {'timeseries_samples_taken':<48} {_fmt(s['samples_taken']):>12}",
            f"  {'timeseries_cadence_s':<48} {s['cadence_s']:>12.6g}",
            f"  {'timeseries_tiers':<48} {shape:>12}"]


def dashboard(registry: MetricsRegistry, title: str = "telemetry") -> str:
    """A fixed-width dump of the registry: the quick look at how a run is
    doing.  Memory gauges (the ``mem_`` names memtrack feeds) render as
    their own block with byte counts humanized."""
    snap = registry.snapshot()
    width = 78
    lines = ["=" * width, f"{title:^{width}}", "=" * width]
    counters, gauges = snap["counters"], snap["gauges"]
    other_counters = {n: v for n, v in counters.items() if not n.startswith(_ALL_PREFIXES)}
    other_gauges = {n: v for n, v in gauges.items()
                    if not n.startswith(("mem_",) + _ALL_PREFIXES)}
    if other_counters:
        lines.append("counters:")
        for name in sorted(other_counters):
            lines.append(f"  {name:<48} {_fmt(other_counters[name]):>12}")
    if other_gauges:
        lines.append("gauges:")
        for name in sorted(other_gauges):
            lines.append(f"  {name:<48} {other_gauges[name]:>12.6g}")
    for block, prefixes in _BLOCKS:
        if block == "resilience:":
            lines.extend(_timeseries_lines())
        bc = {n: v for n, v in counters.items() if _in_block(n, prefixes)}
        bg = {n: v for n, v in gauges.items() if _in_block(n, prefixes)}
        if not (bc or bg):
            continue
        lines.append(block)
        for name in sorted(bc):
            if block == "grad-compression:":
                shown = _fmt_bytes(bc[name]) if "bytes" in name else _fmt(bc[name])
                lines.append(f"  {name:<48} {shown:>16}")
            else:
                lines.append(f"  {name:<48} {_fmt(bc[name]):>12}")
        for name in sorted(bg):
            lines.append(f"  {name:<48} {bg[name]:>12.6g}")
        if block == "alerts:":
            lines.extend(_alert_lines())
    mem_gauges = {n: v for n, v in gauges.items() if n.startswith("mem_")}
    if mem_gauges:
        lines.append("memory:")
        for name in sorted(mem_gauges):
            v = mem_gauges[name]
            # "bytes" anywhere in the name: the tag gauges and the device
            # gauges (mem_device<i>_bytes_in_use, ...) alike
            shown = _fmt_bytes(v) if "bytes" in name else _fmt(v)
            lines.append(f"  {name:<48} {shown:>16}")
    if snap["histograms"]:
        lines.append("histograms (rolling window):")
        for name in sorted(snap["histograms"]):
            h = snap["histograms"][name]
            if h.get("count"):
                lines.append(
                    f"  {name:<38} n={h['count']:<7} p50={h.get('p50', 0):.6g} "
                    f"p95={h.get('p95', 0):.6g} p99={h.get('p99', 0):.6g}"
                )
            else:
                lines.append(f"  {name:<38} n=0")
    lines.append("=" * width)
    return "\n".join(lines)
