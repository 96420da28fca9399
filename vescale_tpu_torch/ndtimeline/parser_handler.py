"""parse_raw_spans (reference legacy/vescale/ndtimeline/handlers/
parser_handler.py): read back LocalRawHandler JSONL span dumps and aggregate
per-metric statistics for offline analysis."""

from __future__ import annotations

import json
import math
import statistics
from typing import Dict, List

from .timer import Span

__all__ = ["parse_raw_spans", "aggregate", "merge_ranks"]


def parse_raw_spans(path: str) -> List[Span]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(
                Span(
                    metric=d["metric"],
                    start=d["start"],
                    duration=d["duration"],
                    step=d.get("step", 0),
                    rank=d.get("rank", 0),
                    tags=d.get("tags"),
                )
            )
    return out


def merge_ranks(spans: List[Span]) -> Dict[tuple, Dict[str, float]]:
    """Cross-rank merge keyed by (step, metric) — the reference parser's
    per-(rank, step, metric) join (legacy parser_handler.py) rolled up so
    stragglers are visible: per-rank totals, cross-rank mean/max and the
    max/mean imbalance ratio.  Feed it the concatenation of every rank's
    ``parse_raw_spans`` output."""
    cell: Dict[tuple, Dict[int, float]] = {}
    for s in spans:
        cell.setdefault((s.step, s.metric), {}).setdefault(s.rank, 0.0)
        cell[(s.step, s.metric)][s.rank] += s.duration * 1e3
    out: Dict[tuple, Dict[str, float]] = {}
    for key, per_rank in cell.items():
        vals = list(per_rank.values())
        mean = statistics.fmean(vals)
        out[key] = {
            "per_rank_ms": dict(sorted(per_rank.items())),
            "mean_ms": mean,
            "max_ms": max(vals),
            "imbalance": (max(vals) / mean) if mean > 0 else 1.0,
        }
    return out


def aggregate(spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """Per-metric count/total/mean/p50/p99 (ms)."""
    by_metric: Dict[str, List[float]] = {}
    for s in spans:
        by_metric.setdefault(s.metric, []).append(s.duration * 1e3)
    out = {}
    for m, xs in by_metric.items():
        xs_sorted = sorted(xs)
        out[m] = {
            "count": len(xs),
            "total_ms": sum(xs),
            "mean_ms": statistics.fmean(xs),
            "p50_ms": xs_sorted[len(xs) // 2],
            # nearest-rank percentile (int(n*0.99) would report the max at n=100)
            "p99_ms": xs_sorted[max(0, math.ceil(len(xs) * 0.99) - 1)],
        }
    return out
