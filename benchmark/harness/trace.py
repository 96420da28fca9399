"""A ``torch.profiler`` capture of part of the window, reduced to what the
per-layer metrics and the result line read: device time by kernel name,
the device's busy seconds, the traced window's length, the device
operations that took most time, and the longest idle gaps labelled by the
benchmark's own host span that was open when each gap began."""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.traced"
_NOT_WORK = ("Sync", "sync", "Wait", "wait")  # device records that are not operations


def short_name(name: str, width: int = 72) -> str:
    """A kernel's name without its return type, template and parameters."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    while "<" in s:
        t = re.sub(r"<[^<>]*>", "", s)
        if t == s:
            break
        s = t
    return s.split("(", 1)[0][:width]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Capture:
    """Profile from :meth:`start` to :meth:`stop`; each ends in a
    synchronise, so the traced window holds whole steps."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.active = False
        self.summary: Optional[Dict] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.active = True

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False
        t = time.perf_counter()
        self.summary = reduce_events(self.prof.profiler.kineto_results.events())
        self.summary["reduce_s"] = time.perf_counter() - t
        self.prof = None


def reduce_events(events) -> Dict:
    """The summary of a capture's kineto events."""
    from torch.autograd import DeviceType

    dev: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    window = None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the host spans' images on the device's timeline are no work
            if e.is_user_annotation() or name.startswith("bench.") or any(
                    w in name for w in _NOT_WORK):
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name == WINDOW_SPAN:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith("bench."):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if window is None:
        raise RuntimeError("the capture holds no window span")
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += (b - a) / 1e9
    busy = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    spans.sort()
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        label = "host, outside the benchmark's spans"
        best = None
        hi = bisect.bisect_right(starts, a)
        for s, e, n in spans[max(0, hi - 64):hi]:
            if s <= a < e and (best is None or e - s < best):
                label, best = n, e - s
        idle[label] += (b - a) / 1e9
    ops: Dict[str, float] = defaultdict(float)
    for n, s in by_name.items():
        ops[short_name(n)] += s
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s, "kernel_s": dict(by_name),
            "device_ops": top(ops), "idle_gaps": top(idle), "device_events": len(dev)}


def kernel_seconds(summary: Dict, *needles: str) -> float:
    """Device seconds of the kernels whose names hold any of ``needles``."""
    return sum(s for n, s in summary["kernel_s"].items() if any(k in n for k in needles))
