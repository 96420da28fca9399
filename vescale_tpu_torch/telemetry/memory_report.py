"""Memory measurement: device stats, the host fallback and the census of
tagged tensors.

The port of ``vescale_tpu/telemetry/memory_report.py``'s measurement
functions.  Pure functions; the stateful half (the tag registry, per-step
sampling, leak detection, the flight recorder) is ``memtrack.py``.
Everything here degrades instead of raising: memory observability must
never be what kills a run.

``device_memory_stats`` reads the CUDA caching allocator
(``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
``.peak``) and ``torch.cuda.mem_get_info`` (the card's total bytes) under
the reference's keys (``bytes_in_use``, ``peak_bytes_in_use``,
``bytes_limit``).  Without a card it gives one host-RSS entry, as the
reference does on the CPU backend.  The census walks the tensors memtrack
tagged, not every live tensor: PyTorch has no ``jax.live_arrays()``.

``compare_with_aot`` diffs a step report's measured peak against an
``AOT_*_REPORT.json`` budget, as the reference diffs its compiled one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

__all__ = [
    "host_rss_bytes",
    "host_peak_rss_bytes",
    "device_memory_stats",
    "live_array_census",
    "aot_memory_budget",
    "compare_with_aot",
]


def host_rss_bytes() -> Optional[int]:
    """This process's resident-set size (Linux ``/proc``; None elsewhere)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return None


def host_peak_rss_bytes() -> Optional[int]:
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card allocator stats (bytes in use, peak, limit).  Without a
    card, one host-RSS entry (``source: "host_rss"``) rather than none:
    the gauges must always have something to say."""
    out: List[Dict[str, Any]] = []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            try:
                stats = torch.cuda.memory_stats(i)
                _free, total = torch.cuda.mem_get_info(i)
            except Exception:
                continue
            out.append({
                "device": f"cuda:{i}",
                "id": i,
                "platform": "gpu",
                "source": "device",
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_limit": int(total),
                "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            })
    if not out:
        out.append({
            "device": "host",
            "platform": "cpu",
            "source": "host_rss",
            "bytes_in_use": host_rss_bytes(),
            "peak_bytes_in_use": host_peak_rss_bytes(),
            "bytes_limit": None,
        })
    return out


def live_array_census(tag_of: Callable[[Any], Optional[str]], arrays: Iterable[Any],
                      top_k: int = 10) -> Dict[str, Any]:
    """Bucket ``arrays`` (live tensors) by owner tag: ``tag_of(t)`` maps
    one to its tag or None (``untagged``).  Returns per-tag ``{count,
    bytes}`` buckets and the ``top_k`` largest tensors, the first thing
    to read in an OOM dump.  A tensor's bytes are its storage's share it
    views (``numel * element_size``)."""
    buckets: Dict[str, Dict[str, int]] = {}
    largest: List[Dict[str, Any]] = []
    n = 0
    for t in arrays:
        try:
            nbytes = int(t.numel()) * int(t.element_size())
            shape, dtype = tuple(t.shape), str(t.dtype).replace("torch.", "")
        except Exception:
            continue
        n += 1
        tag = tag_of(t) or "untagged"
        b = buckets.setdefault(tag, {"count": 0, "bytes": 0})
        b["count"] += 1
        b["bytes"] += nbytes
        largest.append({"shape": shape, "dtype": dtype, "bytes": nbytes, "tag": tag})
    largest.sort(key=lambda e: e["bytes"], reverse=True)
    return {"live_arrays": n, "tags": buckets, "top_arrays": largest[:top_k]}


# ----------------------------------------------------------- AOT drift
def aot_memory_budget(aot: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The per-device memory budget of an ``AOT_*_REPORT.json`` document:
    the measured fp32-compile bytes, else the bf16-basis total; None when
    it carries neither."""
    measured = (aot.get("measured") or {}).get("per_device_bytes_fp32_compile")
    if measured:
        return {"bytes": float(measured), "source": "measured.per_device_bytes_fp32_compile"}
    bf16 = (aot.get("bf16_basis_memory") or {}).get("total_bytes")
    if bf16:
        return {"bytes": float(bf16), "source": "bf16_basis_memory.total_bytes"}
    return None


def compare_with_aot(report: Dict[str, Any], aot: Any,
                     tolerance: float = 0.10) -> Optional[Dict[str, Any]]:
    """Diff a step report's ``peak_bytes`` against the matching AOT report's
    budget; ``exceeds_tolerance`` flags drift beyond ``tolerance`` (10%)
    either way.  ``aot`` is a loaded document or a path to one.  None
    (never raises) when either side lacks a usable byte count — on the
    CPU the port's report has no ``peak_bytes``."""
    if isinstance(aot, str):
        try:
            with open(aot) as f:
                aot = json.load(f)
        except (OSError, ValueError):
            return None
    if not isinstance(aot, dict):
        return None
    budget = aot_memory_budget(aot)
    measured = report.get("peak_bytes")
    if budget is None or not measured:
        return None
    drift = (float(measured) - budget["bytes"]) / budget["bytes"]
    return {
        "aot_bytes": budget["bytes"],
        "aot_source": budget["source"],
        "measured_bytes": float(measured),
        "drift_frac": drift,
        "tolerance": tolerance,
        "exceeds_tolerance": abs(drift) > tolerance,
        "components": {k: report.get(k) for k in ("argument_bytes", "output_bytes", "temp_bytes",
                                                  "alias_bytes", "generated_code_bytes")},
    }
