"""Metric registries: counters, gauges, rolling histograms, events.

Two registries live here.  :class:`MetricsRegistry` (with
:class:`Counter`, :class:`Gauge` and :class:`Histogram`) is the port of
``vescale_tpu/telemetry/registry.py``: the process-global registry that
``telemetry.init()`` creates and the train loop, the checkpoint layer and
the retry policies feed through ``telemetry.api``; the exporters read its
``snapshot()``.  :class:`Registry` is the serve path's own: each
scheduler owns one, so two schedulers in one process never share numbers,
and ``GLOBAL`` holds the library's process-wide counters
(``redistribute.fallbacks``).  Both render through
``exporters.prometheus_text``.  Percentiles use the nearest-rank method.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Union

__all__ = ["GLOBAL", "Counter", "Gauge", "Histogram", "MetricsRegistry", "Registry"]

Number = Union[int, float]


class Counter:
    """Monotonic counter (Prometheus 'counter' semantics)."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-value gauge (may go up or down)."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: Number) -> None:
        self._value = float(v)

    def inc(self, n: Number = 1) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Rolling-window histogram: percentiles over the last ``window``
    observations, exact monotonic count/sum over the whole run."""

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

    def snapshot(self) -> Dict[str, float]:
        xs, count, total = self._sorted_window()
        out: Dict[str, float] = {"count": count, "sum": total, "window": len(xs)}
        if xs:
            for label, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
                out[label] = self._nearest_rank(xs, q)
            out["min"] = xs[0]
            out["max"] = xs[-1]
            out["mean"] = (total / count) if count else 0.0
        return out


class MetricsRegistry:
    """Get-or-create registry of named metrics.  A name is bound to one
    metric kind for the registry's lifetime: asking for it as another kind
    raises instead of shadowing it."""

    def __init__(self, default_window: int = 1024):
        self.default_window = default_window
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}, "
                                f"requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", window: Optional[int] = None) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   window=window or self.default_window)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Dict]:
        """A consistent read of every metric, grouped by kind."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.snapshot()
        return out


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

    def snapshot(self) -> Dict[str, Dict]:
        """The numbers in ``MetricsRegistry.snapshot``'s layout (what the
        exporters read)."""
        with self._lock:
            counters, hists = dict(self.counters), dict(self.histograms)
        return {"counters": counters, "gauges": dict(self.gauges),
                "histograms": {n: h.snapshot() for n, h in hists.items()}}


GLOBAL = Registry()

