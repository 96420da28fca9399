"""NDTimerManager — span collection with a global clock.

The port of ``vescale_tpu/ndtimeline/timer.py``.  A span times a host
region on the host's wall clock (``Span.start`` in epoch seconds,
``Span.duration`` in seconds), and the region is also opened as a
``torch.profiler.record_function`` range, so it shows in a
``torch.profiler`` capture around the kernels it launched.  Device time
belongs to the profiler: a span does not synchronize the card.
Ring-buffered spans flush to pluggable handlers (handlers.py).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["Span", "NDTimerManager"]


@dataclasses.dataclass
class Span:
    metric: str
    start: float       # host wall-clock (epoch seconds)
    duration: float
    step: int
    rank: int
    tags: Optional[Dict[str, Any]] = None


class NDTimerManager:
    """Collects spans into a bounded ring buffer; flush() drains to
    handlers.  Thread-safe; nestable via context managers."""

    def __init__(self, rank: int = 0, max_spans: int = 100_000):
        self.rank = rank
        self.step = 0
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._handlers: List[Callable[[List[Span]], None]] = []
        self._calibration_offset = 0.0  # reference's clock calibration hook

    # ------------------------------------------------------------ config
    def register_handler(self, handler: Callable[[List[Span]], None]) -> None:
        self._handlers.append(handler)

    def unregister_handler(self, handler: Callable[[List[Span]], None]) -> None:
        """Remove a previously registered handler (idempotent) — a
        scoped consumer (the serve loop's fleet-trace stream) must not
        keep receiving spans after its run ends."""
        try:
            self._handlers.remove(handler)
        except ValueError:
            pass

    def calibrate(self, offset_seconds: float) -> None:
        """Shift timestamps by a global-clock offset (reference calibration
        on flush, ndtimeline/README.md:16-20)."""
        self._calibration_offset = offset_seconds

    # ----------------------------------------------------------- spans
    def record(self, metric: str, start: float, duration: float, tags=None,
               step=None) -> None:
        """``step`` overrides the counter for spans recorded on behalf of a
        step that already closed (the alert engine evaluates AFTER the
        loops advance the counter)."""
        with self._lock:
            self._spans.append(
                Span(metric, start + self._calibration_offset, duration,
                     self.step if step is None else step, self.rank, tags)
            )

    def timeit(self, metric: str, tags=None):
        """Context manager measuring a host region and opening it as a
        ``record_function`` range (shows in ``torch.profiler`` captures)."""
        mgr = self

        class _Ctx:
            def __enter__(self):
                self._ann = torch.profiler.record_function(metric)
                self._ann.__enter__()
                self._t0 = time.time()
                return self

            def __exit__(self, *exc):
                dur = time.time() - self._t0
                self._ann.__exit__(*exc)
                mgr.record(metric, self._t0, dur, tags)
                return False

        return _Ctx()

    def decorator(self, metric: str):
        def deco(fn):
            def wrapped(*a, **k):
                with self.timeit(metric):
                    return fn(*a, **k)

            return wrapped

        return deco

    def inc_step(self, n: int = 1) -> None:
        self.step += n

    def tail(self, n: int = 200) -> List[Span]:
        """Last ``n`` buffered spans WITHOUT draining them — the flight
        recorder's peek (an OOM dump must not steal spans from the flush a
        surviving handler still expects).  O(n), not O(ring): the per-step
        span summary (telemetry.record_step) peeks every step and must not
        copy a 100k-deep ring to read its newest few hundred entries."""
        import itertools

        with self._lock:
            if n >= len(self._spans):
                return list(self._spans)
            newest_first = list(itertools.islice(reversed(self._spans), n))
        return newest_first[::-1]

    # ----------------------------------------------------------- flush
    def flush(self, step_range=None) -> List[Span]:
        """Drain buffered spans to the handlers.  ``step_range=(lo, hi)``
        flushes only spans with ``lo <= step < hi``; out-of-window spans
        stay buffered (they belong to a window someone else will flush)."""
        with self._lock:
            if step_range is None:
                spans = list(self._spans)
                self._spans.clear()
            else:
                lo, hi = step_range
                spans = [s for s in self._spans if lo <= s.step < hi]
                kept = [s for s in self._spans if not (lo <= s.step < hi)]
                self._spans.clear()
                self._spans.extend(kept)
        for h in self._handlers:
            h(spans)
        return spans

    def wait(self) -> None:
        """Handlers here are synchronous; kept for API parity
        (reference wait drains the streamer queue, api.py:293)."""
        return None
