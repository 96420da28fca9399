"""An in-process metric registry: counters, gauges, rolling histograms, events.

Just enough of ``vescale_tpu/telemetry`` (``registry.Histogram``, the
``api`` calls ``count`` / ``observe`` / ``set_gauge`` / ``record_event``
and ``exporters.prometheus_text``) for the serve scheduler, loop and ops
endpoints.  No global gate: each scheduler owns a :class:`Registry`, so two
schedulers in one process never share numbers.
"""

from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Union

__all__ = ["Histogram", "Registry", "prometheus_text"]

Number = Union[int, float]


class Histogram:
    """Rolling-window histogram: percentiles over the last ``window``
    observations, exact monotonic count/sum over the whole run (a copy of
    ``vescale_tpu.telemetry.registry.Histogram``)."""

    __slots__ = ("name", "help", "window", "_values", "_pos", "_filled", "_count", "_sum", "_lock")

    def __init__(self, name: str, help: str = "", window: int = 1024):
        if window < 1:
            raise ValueError(f"histogram {name}: window must be >= 1")
        self.name = name
        self.help = help
        self.window = window
        self._values: List[float] = [0.0] * window  # preallocated ring
        self._pos = 0
        self._filled = 0
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: Number) -> None:
        v = float(v)
        with self._lock:
            self._values[self._pos] = v
            self._pos = (self._pos + 1) % self.window
            self._filled = min(self._filled + 1, self.window)
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _sorted_window(self):
        """(sorted recent values, count, sum) under the lock."""
        with self._lock:
            n = self._filled
            xs = sorted(self._values[:n] if n < self.window else self._values)
            return xs, self._count, self._sum

    @staticmethod
    def _nearest_rank(xs: List[float], q: float) -> float:
        return xs[max(0, math.ceil(len(xs) * q) - 1)]

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile of the rolling window; None when empty."""
        xs, _, _ = self._sorted_window()
        return self._nearest_rank(xs, q) if xs else None


class Registry:
    """Named counters, gauges and histograms plus a bounded event log."""

    def __init__(self, window: int = 1024, max_events: int = 1024):
        self._window = window
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.events: Deque[Dict[str, Any]] = deque(maxlen=max_events)

    def count(self, name: str, n: Number = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: Number) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: Number) -> None:
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = Histogram(name, window=self._window)
        hist.observe(value)

    def record_event(self, kind: str, **fields: Any) -> None:
        self.events.append({"kind": kind, **fields})

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0)


_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    """An internal metric name mapped onto the Prometheus charset."""
    if _NAME_OK.match(name):
        return name
    fixed = _NAME_FIX.sub("_", name)
    return fixed if re.match(r"[a-zA-Z_:]", fixed[:1] or "_") else "_" + fixed


def _fmt(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(registry: Registry) -> str:
    """The registry in the Prometheus text exposition format (0.0.4), as
    ``vescale_tpu.telemetry.exporters.prometheus_text`` renders it:
    histograms as summaries (``{quantile=...}`` plus ``_count``/``_sum``)."""
    with registry._lock:
        counters = dict(registry.counters)
        hists = dict(registry.histograms)
    gauges = dict(registry.gauges)
    lines = []
    for name in sorted(counters):
        pname = _metric_name(name)
        lines += [f"# TYPE {pname} counter", f"{pname} {_fmt(counters[name])}"]
    for name in sorted(gauges):
        pname = _metric_name(name)
        lines += [f"# TYPE {pname} gauge", f"{pname} {_fmt(gauges[name])}"]
    for name in sorted(hists):
        pname = _metric_name(name)
        xs, count, total = hists[name]._sorted_window()
        lines.append(f"# TYPE {pname} summary")
        if xs:
            for q in ("0.5", "0.95", "0.99"):
                lines.append(f'{pname}{{quantile="{q}"}} {_fmt(Histogram._nearest_rank(xs, float(q)))}')
        lines += [f"{pname}_count {_fmt(count)}", f"{pname}_sum {_fmt(total)}"]
    return "\n".join(lines) + "\n"
