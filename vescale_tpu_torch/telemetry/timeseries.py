"""Metric time-series store — bounded ring history with tiered downsampling.

The registry (registry.py) answers "what is the value NOW"; this module
answers "what was it over the last N seconds" — the substrate the alert
engine (alerts.py) evaluates burn rates, trends and anomalies over, and
the history feed an autoscaler reads.

Design (docs/observability.md "Time-series store"):

  * **Fixed-cadence sampling.**  The train loop, the serve loop and the
    FleetRouter call :func:`sample` at their natural boundaries (train
    step, decode step, poll); the store accepts at most one sample per
    ``cadence_s`` regardless of call rate, so a 2 kHz decode loop and a
    1 Hz poll loop produce the same densities.  One accepted sample
    snapshots EVERY registry metric: counters and gauges verbatim, each
    histogram as ``name:p50/p95/p99`` value series plus ``name:count`` /
    ``name:sum`` cumulative series.
  * **Tiered downsampling.**  Each series keeps ``tiers`` rings of
    ``base_len`` (ts, value) pairs.  Tier 0 holds raw samples; every
    ``tier_factor`` tier-k samples collapse into ONE tier-(k+1) sample
    (mean for value series, last for cumulative series — a counter's
    bucket endpoint is what rate math needs).  With the defaults
    (1 s cadence, 512 samples, factor 8, 3 tiers) tier 2 retains ~9 h of
    history in a few KiB per metric; appends stay O(1).
  * **Windowed reducers.**  :meth:`TimeSeriesStore.reduce` evaluates
    ``last/min/max/avg/delta/rate/slope/count/std/pNN`` over the finest
    tier covering the requested span — ``rate`` and ``delta`` are
    endpoint-exact on cumulative series because of the last-value bucket
    aggregation above.

Gating contract (memtrack.py precedent): while dormant the module hook
``sample`` IS ``_noop_sample`` (tests assert identity) — no store, no
rings, no clock reads beyond the caller's.  ``telemetry.init()`` activates
(``timeseries=True`` default; ``VESCALE_TIMESERIES`` gates the loops'
arming), ``telemetry.shutdown()`` restores the no-op reference.  Callers
must use ``timeseries.sample(...)`` attribute access, never
``from timeseries import sample``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Series",
    "TimeSeriesStore",
    "REDUCERS",
    "activate",
    "deactivate",
    "is_active",
    "get_store",
    "sample",
]

REDUCERS = (
    "last", "min", "max", "avg", "delta", "rate", "slope", "count", "std",
)  # plus "pNN" percentiles, e.g. "p99"

_CUMULATIVE = "cumulative"  # counter-shaped: bucket-aggregate = last value
_VALUE = "value"            # gauge/percentile-shaped: bucket-aggregate = mean


class _Ring:
    """Preallocated (ts, value) ring — O(1) append, chronological read."""

    __slots__ = ("_ts", "_val", "_pos", "_filled", "cap")

    def __init__(self, cap: int):
        self.cap = cap
        self._ts = [0.0] * cap
        self._val = [0.0] * cap
        self._pos = 0
        self._filled = 0

    def append(self, ts: float, val: float) -> None:
        self._ts[self._pos] = ts
        self._val[self._pos] = val
        self._pos = (self._pos + 1) % self.cap
        self._filled = min(self._filled + 1, self.cap)

    def __len__(self) -> int:
        return self._filled

    def items(self) -> List[Tuple[float, float]]:
        """Chronological (ts, value) pairs."""
        n, p, cap = self._filled, self._pos, self.cap
        if n < cap:
            idx = range(n)
        else:
            idx = [(p + i) % cap for i in range(cap)]
        return [(self._ts[i], self._val[i]) for i in idx]

    def earliest_ts(self) -> Optional[float]:
        if self._filled == 0:
            return None
        i = 0 if self._filled < self.cap else self._pos
        return self._ts[i]


class Series:
    """One metric's tiered history.  ``kind`` decides bucket aggregation:
    ``cumulative`` keeps the bucket's LAST value (endpoint-exact rates),
    ``value`` keeps the bucket mean."""

    __slots__ = ("name", "kind", "tiers", "tier_factor", "_buckets")

    def __init__(self, name: str, kind: str, base_len: int, tier_factor: int,
                 tiers: int):
        self.name = name
        self.kind = kind
        self.tier_factor = tier_factor
        self.tiers = [_Ring(base_len) for _ in range(tiers)]
        # per-tier open bucket: [n, sum, last_ts, last_val]
        self._buckets = [[0, 0.0, 0.0, 0.0] for _ in range(tiers)]

    def append(self, ts: float, val: float) -> None:
        self._append_tier(0, ts, val)

    def _append_tier(self, k: int, ts: float, val: float) -> None:
        self.tiers[k].append(ts, val)
        if k + 1 >= len(self.tiers):
            return
        b = self._buckets[k]
        b[0] += 1
        b[1] += val
        b[2], b[3] = ts, val
        if b[0] >= self.tier_factor:
            agg = b[3] if self.kind == _CUMULATIVE else b[1] / b[0]
            n_ts = b[2]
            b[0], b[1] = 0, 0.0
            self._append_tier(k + 1, n_ts, agg)

    def window(self, span_s: float, now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Chronological samples within the last ``span_s`` seconds, read
        from the FINEST tier whose retained history covers the span (the
        coarsest tier answers spans beyond every ring's reach)."""
        now = time.time() if now is None else now
        cut = now - span_s
        chosen = None
        for ring in self.tiers:
            e = ring.earliest_ts()
            if e is not None and e <= cut:
                chosen = ring
                break
        if chosen is None:
            # no tier's history covers the span (short run, or a span
            # beyond every ring's reach): answer from the tier reaching
            # furthest back — finest wins ties, so a young series serves
            # ALL its samples instead of an empty coarse ring
            best = None
            for ring in self.tiers:
                e = ring.earliest_ts()
                if e is not None and (best is None or e < best):
                    best, chosen = e, ring
            if chosen is None:
                return []
        return [(t, v) for t, v in chosen.items() if t >= cut]

    def retained_samples(self) -> int:
        return sum(len(r) for r in self.tiers)


def _reduce_samples(samples: List[Tuple[float, float]], reducer: str
                    ) -> Optional[float]:
    """Apply one named reducer to chronological (ts, value) samples."""
    if not samples:
        return None
    vals = [v for _, v in samples]
    if reducer == "last":
        return vals[-1]
    if reducer == "min":
        return min(vals)
    if reducer == "max":
        return max(vals)
    if reducer == "avg":
        return sum(vals) / len(vals)
    if reducer == "count":
        return float(len(vals))
    if reducer == "delta":
        return vals[-1] - vals[0]
    if reducer == "rate":
        if len(samples) < 2:
            return None
        dt = samples[-1][0] - samples[0][0]
        return (vals[-1] - vals[0]) / dt if dt > 0 else None
    if reducer == "slope":
        # least-squares slope per second over the window
        if len(samples) < 2:
            return None
        t0 = samples[0][0]
        ts = [t - t0 for t, _ in samples]
        mt = sum(ts) / len(ts)
        mv = sum(vals) / len(vals)
        den = sum((t - mt) ** 2 for t in ts)
        if den <= 0:
            return None
        return sum((t - mt) * (v - mv) for t, v in zip(ts, vals)) / den
    if reducer == "std":
        mv = sum(vals) / len(vals)
        return math.sqrt(sum((v - mv) ** 2 for v in vals) / len(vals))
    if reducer.startswith("p") and reducer[1:].isdigit():
        q = int(reducer[1:]) / 100.0
        xs = sorted(vals)
        return xs[max(0, math.ceil(len(xs) * q) - 1)]
    raise ValueError(f"unknown reducer {reducer!r} (choose from {REDUCERS} or pNN)")


class TimeSeriesStore:
    """Everything a live time-series run owns (created ONLY by
    ``telemetry.init(timeseries=True)``; its absence IS the off state)."""

    def __init__(
        self,
        registry,
        cadence_s: float = 1.0,
        base_len: int = 512,
        tier_factor: int = 8,
        tiers: int = 3,
    ):
        if cadence_s < 0:
            raise ValueError(f"cadence_s must be >= 0, got {cadence_s}")
        if base_len < 2 or tier_factor < 2 or tiers < 1:
            raise ValueError(
                f"bad store shape: base_len={base_len} tier_factor={tier_factor} "
                f"tiers={tiers}"
            )
        self.registry = registry
        self.cadence_s = float(cadence_s)
        self.base_len = int(base_len)
        self.tier_factor = int(tier_factor)
        self.num_tiers = int(tiers)
        self._series: Dict[str, Series] = {}
        self._last_sample = 0.0
        self.samples_taken = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- append
    def _get(self, name: str, kind: str) -> Series:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = Series(
                name, kind, self.base_len, self.tier_factor, self.num_tiers
            )
        return s

    def sample(self, kind: Optional[str] = None, now: Optional[float] = None,
               force: bool = False) -> bool:
        """Snapshot the registry into the rings; at most one accepted
        sample per ``cadence_s`` (``force`` bypasses — tests and the
        router's explicit poll cadence).  Returns whether a sample was
        taken.  ``kind`` is advisory (the caller's boundary name); the
        cadence limiter is global so overlapping loops do not double the
        density."""
        now = time.time() if now is None else now
        with self._lock:
            if not force and (now - self._last_sample) < self.cadence_s:
                return False
            self._last_sample = now
            snap = self.registry.snapshot()
            for name, v in snap["counters"].items():
                self._get(name, _CUMULATIVE).append(now, float(v))
            for name, v in snap["gauges"].items():
                self._get(name, _VALUE).append(now, float(v))
            for name, h in snap["histograms"].items():
                for q in ("p50", "p95", "p99"):
                    if q in h:
                        self._get(f"{name}:{q}", _VALUE).append(now, float(h[q]))
                self._get(f"{name}:count", _CUMULATIVE).append(now, float(h["count"]))
                self._get(f"{name}:sum", _CUMULATIVE).append(now, float(h["sum"]))
            self.samples_taken += 1
            return True

    # ------------------------------------------------------------- queries
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, metric: str) -> Optional[Series]:
        with self._lock:
            return self._series.get(metric)

    def window(self, metric: str, span_s: float, now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        s = self.series(metric)
        return s.window(span_s, now) if s is not None else []

    def reduce(self, metric: str, span_s: float, reducer: str = "last",
               now: Optional[float] = None) -> Optional[float]:
        """One reduced number over the window; None when the series is
        absent or too thin for the reducer."""
        return _reduce_samples(self.window(metric, span_s, now), reducer)

    def retained_samples(self) -> int:
        with self._lock:
            return sum(s.retained_samples() for s in self._series.values())

    def stats(self) -> Dict[str, float]:
        """The ``timeseries:`` dashboard block feed."""
        with self._lock:
            return {
                "series": len(self._series),
                "samples_taken": self.samples_taken,
                "retained_samples": sum(
                    s.retained_samples() for s in self._series.values()
                ),
                "cadence_s": self.cadence_s,
                "tiers": self.num_tiers,
                "base_len": self.base_len,
                "tier_factor": self.tier_factor,
            }


# --------------------------------------------------------------- gate flips
_STORE: Optional[TimeSeriesStore] = None


# This IS the module's public hook while dormant (memtrack contract): the
# loops call it per step/poll and an un-instrumented run must pay one
# no-op frame, nothing else.  activate() rebinds; deactivate() restores
# this exact reference (the gating test asserts identity).
def _noop_sample(kind: Optional[str] = None, now: Optional[float] = None,
                 force: bool = False) -> bool:
    return False


sample = _noop_sample


def is_active() -> bool:
    return _STORE is not None


def get_store() -> Optional[TimeSeriesStore]:
    return _STORE


def activate(
    registry,
    cadence_s: float = 1.0,
    base_len: int = 512,
    tier_factor: int = 8,
    tiers: int = 3,
) -> TimeSeriesStore:
    """Create the store and bind the live hook (called by
    ``telemetry.init``; do not call directly unless you know why)."""
    global _STORE, sample
    _STORE = TimeSeriesStore(
        registry,
        cadence_s=cadence_s,
        base_len=base_len,
        tier_factor=tier_factor,
        tiers=tiers,
    )
    sample = _STORE.sample
    return _STORE


def deactivate() -> None:
    """Drop the store and restore the no-op hook reference."""
    global _STORE, sample
    _STORE = None
    sample = _noop_sample
