"""Straggler detection over cross-rank merged ndtimeline spans.

A ``StragglerDetector`` is a span handler (the ``NDtimelineStreamer``
handler interface: ``handler(List[Span])``) that accumulates per-(metric,
rank) durations and flags ranks whose latency exceeds a configurable
multiple of the cross-rank MEDIAN for that metric.  Median (not mean): one
slow rank must not drag the baseline toward itself — on an 8-rank job a
2x-slow rank shifts the mean by 12.5% but the median not at all.

It also consumes the offline shape: ``update_from_merged`` takes the
``parser_handler.merge_ranks`` rollup, so post-hoc analysis of raw span
dumps uses the same thresholds as the live collector path.

Clock skew: duration-based flagging is skew-immune (a duration is one
host's clock differenced against itself), but START-time comparisons —
"rank 3 enters every step 8 ms after everyone else", the upstream-cause
view of a straggler — are only meaningful after skew correction.  Feed the
detector the offsets from ``telemetry.trace.estimate_clock_offsets`` via
:meth:`set_clock_offsets`; :meth:`lag_report` then compares SKEW-CORRECTED
per-(metric, step) start times across ranks instead of assuming
synchronized host clocks, and refuses to flag lags smaller than the
estimate's own residual (a lag claim below the measurement noise floor is
not a signal).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

__all__ = ["StragglerDetector"]


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class StragglerDetector:
    """Flags per-metric slow ranks.

    ``threshold``: a rank is a straggler for a metric when its mean recent
    duration exceeds ``threshold * median`` of all ranks' means (and the
    absolute excess tops ``min_excess_ms`` — microsecond-scale jitter on
    microsecond-scale metrics is not a health signal).
    ``window``: per-(metric, rank) rolling sample count.
    ``min_ranks``: below this many reporting ranks there is no population to
    compare against; nothing is flagged.
    ``lag_threshold_ms``: minimum mean start-time lag behind the cross-rank
    median for :meth:`lag_report` to flag a rank (raised to the clock-sync
    residual when that is larger).
    """

    def __init__(
        self,
        threshold: float = 1.5,
        window: int = 256,
        min_ranks: int = 2,
        min_excess_ms: float = 0.0,
        lag_threshold_ms: float = 1.0,
    ):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1.0, got {threshold}")
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_ranks = int(min_ranks)
        self.min_excess_ms = float(min_excess_ms)
        self.lag_threshold_ms = float(lag_threshold_ms)
        # metric -> rank -> rolling durations (ms)
        self._samples: Dict[str, Dict[int, collections.deque]] = {}
        # metric -> step -> rank -> earliest skew-corrected start (s);
        # bounded to the last `window` steps per metric
        self._starts: Dict[str, "collections.OrderedDict" ] = {}
        self._offsets_s: Dict[int, float] = {}  # rank -> clock offset vs rank 0
        self._residual_ms = 0.0
        self._lock = threading.Lock()
        self.spans_seen = 0

    # ---------------------------------------------------------- clock sync
    def set_clock_offsets(self, clock) -> None:
        """Arm skew correction with cross-rank clock offsets: a
        ``telemetry.trace.ClockSync`` or a ``{rank: offset_seconds}``
        mapping (offsets relative to rank 0, as ``estimate_clock_offsets``
        reports them).  Spans already ingested are NOT re-aligned — arm the
        offsets before attaching the detector to a streamer."""
        from .trace import ClockSync

        with self._lock:
            if isinstance(clock, ClockSync):
                self._offsets_s = {r: clock.offset_s(r) for r in range(len(clock.offsets_us))}
                self._residual_ms = clock.residual_us / 1e3
            else:
                self._offsets_s = {int(r): float(o) for r, o in dict(clock).items()}
                self._residual_ms = 0.0

    def _aligned_start(self, span) -> float:
        return span.start - self._offsets_s.get(span.rank, 0.0)

    # -------------------------------------------------------------- feeds
    def __call__(self, spans) -> None:
        """Streamer/flush handler: ingest a span batch."""
        with self._lock:
            for s in spans:
                dq = self._samples.setdefault(s.metric, {}).setdefault(
                    s.rank, collections.deque(maxlen=self.window)
                )
                dq.append(s.duration * 1e3)
                self.spans_seen += 1
                steps = self._starts.setdefault(s.metric, collections.OrderedDict())
                cell = steps.setdefault(int(s.step), {})
                t = self._aligned_start(s)
                cell[s.rank] = min(cell.get(s.rank, t), t)
                while len(steps) > self.window:
                    steps.popitem(last=False)
        self.publish_alerts()

    def update_from_merged(self, merged: Dict[tuple, Dict]) -> None:
        """Ingest a ``parser_handler.merge_ranks`` rollup: ``{(step, metric):
        {"per_rank_ms": {rank: total_ms}, ...}}`` — each (step, rank) total
        counts as one sample."""
        with self._lock:
            for (_step, metric), row in merged.items():
                for rank, ms in row.get("per_rank_ms", {}).items():
                    dq = self._samples.setdefault(metric, {}).setdefault(
                        int(rank), collections.deque(maxlen=self.window)
                    )
                    dq.append(float(ms))
                    self.spans_seen += 1
        self.publish_alerts()

    # ------------------------------------------------------------ queries
    def rank_means(self, metric: str) -> Dict[int, float]:
        with self._lock:
            per_rank = self._samples.get(metric, {})
            return {r: sum(dq) / len(dq) for r, dq in per_rank.items() if dq}

    def report(self, metric: Optional[str] = None) -> List[Dict]:
        """Flagged stragglers, worst ratio first.  Each entry:
        ``{metric, rank, mean_ms, median_ms, ratio}``."""
        with self._lock:
            metrics = [metric] if metric is not None else list(self._samples)
        out: List[Dict] = []
        for m in metrics:
            means = self.rank_means(m)
            if len(means) < self.min_ranks:
                continue
            med = _median(list(means.values()))
            if med <= 0.0:
                continue
            for rank, mean in means.items():
                if mean > self.threshold * med and (mean - med) >= self.min_excess_ms:
                    out.append(
                        {
                            "metric": m,
                            "rank": rank,
                            "mean_ms": mean,
                            "median_ms": med,
                            "ratio": mean / med,
                        }
                    )
        out.sort(key=lambda e: e["ratio"], reverse=True)
        return out

    def lag_report(self, metric: Optional[str] = None) -> List[Dict]:
        """Start-time stragglers: ranks that ENTER a metric's region late
        relative to the cross-rank median of SKEW-CORRECTED start times,
        averaged over the retained steps.  A rank busy exactly as long as
        its peers but consistently starting late points at an upstream
        cause (slow input pipeline, late collective exit) that duration
        ratios cannot see.  Flags mean lags above ``lag_threshold_ms`` OR
        the clock-sync residual, whichever is larger — below the residual
        the 'lag' is indistinguishable from clock noise.  Entries:
        ``{metric, rank, mean_lag_ms, steps}``, worst first."""
        floor = max(self.lag_threshold_ms, self._residual_ms)
        with self._lock:
            metrics = [metric] if metric is not None else list(self._starts)
            snap = {
                m: {step: dict(cell) for step, cell in self._starts.get(m, {}).items()}
                for m in metrics
            }
        out: List[Dict] = []
        for m, steps in snap.items():
            lags: Dict[int, List[float]] = {}
            for cell in steps.values():
                if len(cell) < self.min_ranks:
                    continue
                med = _median(list(cell.values()))
                for rank, t in cell.items():
                    lags.setdefault(rank, []).append((t - med) * 1e3)
            for rank, ls in lags.items():
                mean_lag = sum(ls) / len(ls)
                if mean_lag > floor:
                    out.append(
                        {"metric": m, "rank": rank, "mean_lag_ms": mean_lag, "steps": len(ls)}
                    )
        out.sort(key=lambda e: e["mean_lag_ms"], reverse=True)
        return out

    def publish_alerts(self) -> None:
        """Route the straggler findings through the alert engine (one
        lifecycle, /alerts visibility, ALERT timeline span) — the
        previously-silent watcher's migration.  Only acts while the engine
        is live: a dormant run keeps the old report()/summary() pull
        model, no new warnings."""
        from . import alerts as _alerts

        if not _alerts.is_active():
            return
        flagged = self.report()
        lagged = self.lag_report()
        if flagged or lagged:
            worst = (
                flagged[0]["ratio"] if flagged else lagged[0]["mean_lag_ms"]
            )
            _alerts.raise_alert(
                "straggler-lag", message=self.summary(), severity="warning",
                value=float(worst),
            )
        else:
            _alerts.resolve("straggler-lag")

    def healthy(self) -> bool:
        # both straggler shapes gate health: duration outliers AND
        # skew-corrected start-time lags (summary() prints both; automation
        # reacting to healthy() must see what summary() names)
        return not self.report() and not self.lag_report()

    def summary(self) -> str:
        flagged = self.report()
        lagged = self.lag_report()
        if not flagged and not lagged:
            return "stragglers: none"
        lines = ["stragglers:"]
        for e in flagged:
            lines.append(
                f"  rank {e['rank']:<4} {e['metric']:<28} "
                f"{e['mean_ms']:.3f} ms vs median {e['median_ms']:.3f} ms "
                f"({e['ratio']:.2f}x)"
            )
        for e in lagged:
            lines.append(
                f"  rank {e['rank']:<4} {e['metric']:<28} "
                f"starts {e['mean_lag_ms']:.3f} ms late (skew-corrected, "
                f"{e['steps']} steps)"
            )
        return "\n".join(lines)
