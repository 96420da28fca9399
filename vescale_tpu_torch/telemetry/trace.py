"""Unified distributed trace timeline — one step, every rank, one file.

ndtimeline gives each rank a host-span stream (timer.py) and the streamer a
live merge (streamer.py), but there has been no way to LOOK at a step across
ranks on a single timeline: per-rank span dumps carry raw host clocks (which
skew by milliseconds across hosts — longer than many of the spans), the
chrome-trace handler wrote one rank's view, and nothing extracted where the
step's time actually went.

This module closes that loop:

  * :func:`estimate_clock_offsets` — cross-rank clock-offset estimation
    over the resilience layer's ``allgather_ints`` control plane: K rounds
    of wall-clock exchange, per-rank offsets relative to rank 0 with a
    reported residual bound (the spread across rounds).  Feed the result to
    ``NDTimerManager.calibrate`` (record-time alignment) or to
    :func:`merge_traces` (merge-time alignment).
  * :func:`merge_traces` — merge per-rank span streams into one skew-
    corrected stream, ready for :func:`write_perfetto` (the upgraded
    ``ChromeTraceHandler``: pid/tid metadata from ``world_info`` rank
    coordinates, flow events between tagged send/recv pairs).
  * :func:`critical_path` — per-step critical-path extraction: the
    backward-chained sequence of spans covering the step's makespan, with
    the coverage fraction (1 - coverage = time no recorded span explains).
  * :func:`bubble_fraction` — pipeline bubble fraction from the
    PipeEngine's per-instruction spans: 1 - mean per-stage busy fraction
    over the step window.
  * :func:`record_trace_metrics` — feeds the ``trace:`` and
    ``critical-path:`` dashboard blocks (exporters.py) from a merge.
  * :func:`step_span_summary` — the per-step span rollup telemetry's
    ``record_step`` embeds in ``steps.jsonl``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

from ..ndtimeline import predefined as _predefined
from ..ndtimeline.timer import Span

__all__ = [
    "ClockSync",
    "estimate_clock_offsets",
    "merge_traces",
    "stream_process_names",
    "write_perfetto",
    "load_perfetto",
    "spans_from_perfetto",
    "critical_path",
    "critical_paths_by_step",
    "bubble_fraction",
    "step_span_summary",
    "record_trace_metrics",
    "PIPE_METRICS",
]


# the PipeEngine instruction spans the bubble-fraction computation reads
PIPE_METRICS = frozenset(
    (
        _predefined.FORWARD_COMPUTE,
        _predefined.BACKWARD_COMPUTE,
        _predefined.WGRAD_COMPUTE,
    )
)


# ------------------------------------------------------------- clock sync
@dataclasses.dataclass
class ClockSync:
    """Per-rank host-clock offsets relative to rank 0 (microseconds,
    ``offset_us[p]`` = rank p's clock minus rank 0's), plus the residual
    bound: half the worst cross-round spread — aligned timestamps from two
    ranks are comparable only down to this granularity."""

    offsets_us: List[float]
    residual_us: float
    rounds: int

    def offset_s(self, rank: int) -> float:
        if 0 <= rank < len(self.offsets_us):
            return self.offsets_us[rank] / 1e6
        return 0.0

    def as_dict(self) -> Dict:
        return {
            "offsets_us": list(self.offsets_us),
            "residual_us": self.residual_us,
            "rounds": self.rounds,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ClockSync":
        return cls(
            offsets_us=[float(x) for x in d["offsets_us"]],
            residual_us=float(d["residual_us"]),
            rounds=int(d.get("rounds", 0)),
        )


def estimate_clock_offsets(
    rounds: Optional[int] = None, tag: str = "vescale_clock_sync"
) -> ClockSync:
    """Estimate per-rank clock offsets over ``allgather_ints`` (the
    control plane of ``distributed.py``): each round, every rank samples its wall clock
    immediately before entering the gather; rank p's offset is the
    cross-round MEDIAN of ``t_p - t_0`` (the median discards rounds where a
    straggling entry skewed the exchange).  Single-process: all zeros.

    Every rank computes the full offset vector (the gather is symmetric),
    so any rank can merge any rank's spans.  Accuracy is bounded by the
    gather's own duration — ``residual_us`` reports the observed bound so
    downstream skew claims stay honest."""
    from .. import config as envreg
    from ..distributed import allgather_ints

    if rounds is None:
        rounds = envreg.get_int("VESCALE_CLOCK_SYNC_ROUNDS") or 8
    rounds = max(1, int(rounds))
    samples: List[List[int]] = []
    for _ in range(rounds):
        now_us = int(time.time() * 1e6)
        rows = allgather_ints([now_us], tag=tag)
        samples.append([int(r[0]) for r in rows])
    world = len(samples[0])
    offsets: List[float] = []
    residual = 0.0
    for p in range(world):
        deltas = [row[p] - row[0] for row in samples]
        offsets.append(float(statistics.median(deltas)))
        if len(deltas) > 1:
            residual = max(residual, (max(deltas) - min(deltas)) / 2.0)
    return ClockSync(offsets_us=offsets, residual_us=residual, rounds=rounds)


# ---------------------------------------------------------------- merging
def _offset_fn(clock) -> "callable":
    if clock is None:
        return lambda key: 0.0
    if hasattr(clock, "offset_s"):  # ClockSync (int ranks) or a
        return clock.offset_s  # fleet-style sync keyed by stream id
    if isinstance(clock, Mapping):
        return lambda key: float(clock.get(key, 0.0))
    raise TypeError(f"clock must be ClockSync, mapping or None, got {type(clock)}")


def _is_replica_qualified(span_streams) -> bool:
    return (
        isinstance(span_streams, Mapping)
        and bool(span_streams)
        and any(not isinstance(k, int) for k in span_streams)
    )


def merge_traces(
    span_streams: Union[Sequence[Span], Mapping[int, Sequence[Span]], Mapping[str, Sequence[Span]]],
    clock=None,
) -> List[Span]:
    """Merge per-rank span streams into ONE stream on rank 0's clock.

    ``span_streams``: either a flat span iterable (ranks read from each
    span) or ``{rank: spans}`` (the mapping's rank wins — the shape you get
    from per-rank ``parse_raw_spans`` files).  ``clock``: a
    :class:`ClockSync` or ``{rank: offset_seconds}``; each span's start is
    shifted by ``-offset(rank)``.  Returns NEW spans sorted by aligned
    start (inputs are never mutated).

    **Replica-qualified stream identities** (fleet mode): the mapping keys
    may be STRINGS (``"router"``, ``"r0"``, ``"r1"``, …) — the shape a
    multi-replica fleet produces, where two replicas' rank-0 spans would
    otherwise collide on one pid lane.  Each stream is then assigned its
    own pid lane (sorted-key order, deterministic), every span gains a
    ``stream`` tag naming its origin, and the clock offsets are looked up
    by the SAME key (a ``{key: offset_seconds}`` mapping or anything with
    an ``offset_s(key)`` method, e.g. ``fleettrace.FleetClockSync``).
    :func:`stream_process_names` yields the matching
    ``write_perfetto(process_names=...)`` labels."""
    off = _offset_fn(clock)
    out: List[Span] = []
    if _is_replica_qualified(span_streams):
        keys = sorted(span_streams, key=str)
        pid_of = {k: i for i, k in enumerate(keys)}
        for k in keys:
            for s in span_streams[k]:
                tags = dict(s.tags) if s.tags else {}
                tags.setdefault("stream", str(k))
                out.append(
                    Span(
                        metric=s.metric,
                        start=s.start - off(k),
                        duration=s.duration,
                        step=s.step,
                        rank=pid_of[k],
                        tags=tags,
                    )
                )
        out.sort(key=lambda s: (s.start, s.rank, s.metric))
        return out
    if isinstance(span_streams, Mapping):
        items: Iterable = (
            (rank, s) for rank, spans in span_streams.items() for s in spans
        )
    else:
        items = ((s.rank, s) for s in span_streams)
    for rank, s in items:
        out.append(
            Span(
                metric=s.metric,
                start=s.start - off(rank),
                duration=s.duration,
                step=s.step,
                rank=int(rank),
                tags=dict(s.tags) if s.tags else None,
            )
        )
    out.sort(key=lambda s: (s.start, s.rank, s.metric))
    return out


def stream_process_names(span_streams: Mapping) -> Dict[int, str]:
    """The ``write_perfetto(process_names=...)`` labels matching
    :func:`merge_traces`' pid assignment: replica-qualified (string-keyed)
    streams map sorted-key order onto pids 0..n-1; int-keyed streams keep
    rank == pid."""
    if not isinstance(span_streams, Mapping):
        return {}
    keys = sorted(span_streams, key=str)
    if _is_replica_qualified(span_streams):
        return {i: str(k) for i, k in enumerate(keys)}
    return {int(k): f"rank {k}" for k in keys}


def write_perfetto(
    spans: Sequence[Span],
    path: str,
    process_names: Optional[Mapping[int, str]] = None,
    world_infos: Optional[Mapping[int, object]] = None,
) -> str:
    """Write a merged span stream as one Perfetto/Chrome trace.  Rank ->
    pid; ``world_infos`` (``{rank: WorldInfo}``) names each process lane
    with its nD coordinate (``rank 1 [dp=1 tp=0 pp=0]``) so the timeline
    reads in topology terms, not bare integers."""
    from ..ndtimeline.handlers import ChromeTraceHandler

    names = dict(process_names or {})
    for rank, wi in (world_infos or {}).items():
        names.setdefault(
            int(rank),
            f"rank {rank} [dp={getattr(wi, 'dp_rank', 0)} "
            f"tp={getattr(wi, 'tp_rank', 0)} pp={getattr(wi, 'pp_rank', 0)}]",
        )
    handler = ChromeTraceHandler(path, process_names=names)
    handler(list(spans))
    return handler.write()


def load_perfetto(path: str) -> Dict:
    """Load a trace written by :func:`write_perfetto` /
    ``ChromeTraceHandler.write`` back into its JSON dict (the round-trip
    surface the handler tests assert on)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError(f"{path}: not a chrome-trace JSON (no traceEvents)")
    return data


def spans_from_perfetto(path: str) -> List[Span]:
    """Reconstruct :class:`Span` objects from a written trace's duration
    ('X') events — the load half of the round-trip test."""
    out = []
    for ev in load_perfetto(path)["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        step = int(args.pop("step", 0))
        out.append(
            Span(
                metric=ev["name"],
                start=ev["ts"] / 1e6,
                duration=ev.get("dur", 0) / 1e6,
                step=step,
                rank=int(ev.get("pid", 0)),
                tags=args or None,
            )
        )
    out.sort(key=lambda s: (s.start, s.rank, s.metric))
    return out


# ---------------------------------------------------------- critical path
def critical_path(spans: Sequence[Span]) -> Dict:
    """Backward-chained critical path through a (merged, aligned) span set:
    start from the latest-ending span, repeatedly hop to the latest-ending
    span that finishes before the current one starts.  The chain is the
    sequence of host regions that bound the makespan; ``coverage`` is the
    fraction of the chained window the spans themselves explain (the rest
    is time no recorded span accounts for — device work, scheduling gaps,
    or genuinely idle bubble).

    Returns ``{spans, total_ms, window_ms, coverage, n_spans}`` (empty
    input -> zeros)."""
    spans = [s for s in spans if s.duration >= 0]
    if not spans:
        return {"spans": [], "total_ms": 0.0, "window_ms": 0.0, "coverage": 0.0, "n_spans": 0}
    by_end = sorted(spans, key=lambda s: s.start + s.duration)
    cur = by_end[-1]
    chain = [cur]
    # walk the end-sorted list backwards: the first span ending at or
    # before cur.start is the latest such span (the binding predecessor).
    # i strictly decreases across chain links so the walk terminates even
    # on zero-duration spans (a span that "ends at or before" its own
    # start must never become its own predecessor)
    i = len(by_end) - 1
    while True:
        pred = None
        while i >= 0:
            cand = by_end[i]
            if cand is not cur and cand.start + cand.duration <= cur.start:
                pred = cand
                break
            i -= 1
        if pred is None:
            break
        chain.append(pred)
        cur = pred
        i -= 1
    chain.reverse()
    total = sum(s.duration for s in chain)
    window = (by_end[-1].start + by_end[-1].duration) - chain[0].start
    return {
        "spans": chain,
        "total_ms": total * 1e3,
        "window_ms": window * 1e3,
        "coverage": (total / window) if window > 0 else 1.0,
        "n_spans": len(chain),
    }


def critical_paths_by_step(spans: Sequence[Span]) -> Dict[int, Dict]:
    """Per-step critical paths: group by ``span.step`` and extract each
    step's chain independently (cross-step chains would bind on the flush
    boundary, not the work)."""
    by_step: Dict[int, List[Span]] = {}
    for s in spans:
        by_step.setdefault(int(s.step), []).append(s)
    return {step: critical_path(ss) for step, ss in sorted(by_step.items())}


def bubble_fraction(spans: Sequence[Span], step: Optional[int] = None) -> Optional[float]:
    """Pipeline bubble fraction from PipeEngine instruction spans
    (forward/backward/wgrad compute, tagged with their stage): over the
    step window (earliest pipe-span start to latest end), each stage's busy
    time is the sum of its span durations; the bubble fraction is
    ``1 - mean_stage(busy / window)``.  ``step=None`` pools all steps.
    Returns None when the stream carries no stage-tagged pipe spans."""
    pipe = PIPE_METRICS
    rows = [
        s
        for s in spans
        if s.metric in pipe
        and (step is None or int(s.step) == int(step))
        and s.tags is not None
        and "stage" in s.tags
    ]
    if not rows:
        return None
    t0 = min(s.start for s in rows)
    t1 = max(s.start + s.duration for s in rows)
    window = t1 - t0
    if window <= 0:
        return None
    busy: Dict[int, float] = {}
    for s in rows:
        busy[int(s.tags["stage"])] = busy.get(int(s.tags["stage"]), 0.0) + s.duration
    frac = sum(min(1.0, b / window) for b in busy.values()) / len(busy)
    return max(0.0, min(1.0, 1.0 - frac))


# ---------------------------------------------------------- telemetry feed
def step_span_summary(
    step: Optional[int] = None, manager=None, limit: int = 512
) -> Optional[Dict[str, Dict[str, float]]]:
    """Per-metric rollup of one step's spans from the live manager's ring
    (``tail`` — peeked, never drained): ``{metric: {count, total_ms}}``.
    The feed ``telemetry.record_step`` embeds as the ``spans`` object of a
    steps.jsonl line.  Bounded by ``limit`` tail spans so a long-buffered
    run never pays an O(ring) copy per step.

    ``step=None`` summarizes the NEWEST buffered span's step — the step
    that just finished.  Not ``manager.step``: on the default train path
    ``auto_inc_step`` advances the counter BEFORE telemetry records the
    step, so the counter already names the (empty) next step."""
    from ..ndtimeline.api import get_manager, is_active

    if manager is None:
        if not is_active():
            return None
        manager = get_manager()
    tail = manager.tail(limit)
    if step is None:
        if not tail:
            return None
        step = tail[-1].step
    out: Dict[str, Dict[str, float]] = {}
    for s in tail:
        if int(s.step) != int(step):
            continue
        cell = out.setdefault(s.metric, {"count": 0, "total_ms": 0.0})
        cell["count"] += 1
        cell["total_ms"] += s.duration * 1e3
    for cell in out.values():
        cell["total_ms"] = round(cell["total_ms"], 4)
    return out or None


def record_trace_metrics(
    merged: Sequence[Span],
    clock: Optional[ClockSync] = None,
    bubble: Optional[float] = None,
    cp: Optional[Dict] = None,
) -> None:
    """Publish a merge's headline numbers into the telemetry registry —
    the ``trace:`` and ``critical-path:`` dashboard blocks (exporters.py
    group on the ``trace_`` / ``critical_path_`` prefixes).  No-op while
    telemetry is dormant."""
    from . import api as _tel

    if not _tel.is_active():
        return
    _tel.count("trace_merges_total")
    _tel.count("trace_spans_merged_total", len(merged))
    _tel.set_gauge("trace_ranks", len({s.rank for s in merged}))
    if clock is not None:
        _tel.set_gauge("trace_clock_residual_us", clock.residual_us)
    if bubble is None:
        bubble = bubble_fraction(merged)
    if bubble is not None:
        _tel.set_gauge("trace_pipe_bubble_fraction", bubble)
    if cp is None and merged:
        cp = critical_path(merged)
    if cp is not None:
        _tel.set_gauge("critical_path_ms", cp["total_ms"])
        _tel.set_gauge("critical_path_window_ms", cp["window_ms"])
        _tel.set_gauge("critical_path_coverage", cp["coverage"])
        _tel.set_gauge("critical_path_spans", cp["n_spans"])
