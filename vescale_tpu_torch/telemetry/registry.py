"""An in-process metric registry: counters, gauges, rolling histograms, events.

Just enough of ``vescale_tpu/telemetry`` (``registry.Histogram`` and the
``api`` calls ``count`` / ``observe`` / ``set_gauge`` / ``record_event``)
for the serve scheduler and loop.  No exporters, no global gate: each
scheduler owns a :class:`Registry`, so two schedulers in one process never
share numbers.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Union

__all__ = ["Histogram", "Registry"]

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
