"""CommDebugMode: count the collectives a computation issues.

The port of ``vescale_tpu/debug/comm_mode.py`` (reference CommDebugMode,
vescale/dtensor/debug/_comm_mode.py:21).  The reference compiles the
program and counts collectives in its optimized HLO; the port has no HLO
and issues every collective itself, through ``collectives.py``, which
counts each one in ``collectives.CALLS`` (and its operand bytes in
``BYTES``) under ``"<backend>.<op>"``.  So the port counts what a run
issues: the delta of those counters over the region.  This is not torch's
DTensor ``CommDebugMode`` (the port's collectives are not DTensor ops).

Counts come back under the reference's logical names (``all_reduce``,
``all_gather``, ``reduce_scatter``, ``all_to_all``,
``collective_permute``, plus ``broadcast`` and ``scatter``), the int8
collectives under their logical op and an ``<op>:int8`` tag, as the
reference's wire-dtype convention counts them; ``total`` sums the logical
keys.  ``attribute_plan(plan, compiled=True, darray=d)`` runs each hop of a
redistribution plan on ``d`` and attaches the collectives that hop issued
(``hlo_collectives``, the reference's key, here counted from the run), where
the reference lowers each hop and parses its HLO: a stated departure.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict

__all__ = ["comm_counts", "count_calls", "CommDebugMode"]

# the collectives module's op names -> (logical op, int8 tag or None)
_LOGICAL = {
    "all_reduce": ("all_reduce", None),
    "all_gather": ("all_gather", None),
    "reduce_scatter": ("reduce_scatter", None),
    "all_to_all": ("all_to_all", None),
    "ppermute": ("collective_permute", None),
    "broadcast": ("broadcast", None),
    "scatter": ("scatter", None),
    "q_psum": ("all_reduce", "all_reduce:int8"),
    "q_all_gather": ("all_gather", "all_gather:int8"),
    "q_psum_scatter": ("reduce_scatter", "reduce_scatter:int8"),
    "q_all_to_all": ("all_to_all", "all_to_all:int8"),
}
_BASE = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "collective_permute")


def count_calls(calls: Dict[str, int]) -> Dict[str, int]:
    """``collectives.CALLS``-style counts (``"<backend>.<op>"``) in the
    logical vocabulary, with ``total`` (the tag keys excluded)."""
    out: Dict[str, int] = {k: 0 for k in _BASE}
    for key, n in calls.items():
        op = key.split(".", 1)[1] if "." in key else key
        if op not in _LOGICAL or not n:
            continue  # host-copy records and unknown keys
        logical, tag = _LOGICAL[op]
        out[logical] = out.get(logical, 0) + n
        if tag is not None:
            out[tag] = out.get(tag, 0) + n
    out["total"] = sum(v for k, v in out.items() if k != "total" and ":" not in k)
    return out


def _delta(now: Counter, before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in now.items() if v - before.get(k, 0)}


def comm_counts(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` and count the collectives it issued."""
    with CommDebugMode() as comm:
        fn(*args, **kwargs)
    return comm.get_comm_counts()


class CommDebugMode:
    """``with CommDebugMode() as comm: ...`` counts the collectives the
    region issues; ``comm.trace(fn, *args)`` counts one call and returns
    its result.  ``calls`` / ``bytes`` are the raw deltas of
    ``collectives.CALLS`` / ``BYTES`` (``"<backend>.<op>"``), ``counts``
    the logical view."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.plan_attribution: Dict[str, Any] = {}
        self._before = None

    def __enter__(self):
        from .. import collectives as C

        self._before = (dict(C.CALLS), dict(C.BYTES))
        return self

    def __exit__(self, *exc):
        self._close()
        return False

    def _close(self) -> None:
        from .. import collectives as C

        if self._before is None:
            return
        calls0, bytes0 = self._before
        self.calls = _delta(C.CALLS, calls0)
        self.bytes = _delta(C.BYTES, bytes0)
        self.counts = count_calls(self.calls)

    def trace(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` and count what it issues (the region's counts so far
        included when called inside ``with``)."""
        from .. import collectives as C

        if self._before is None:
            self._before = (dict(C.CALLS), dict(C.BYTES))
            try:
                return fn(*args, **kwargs)
            finally:
                self._close()
                self._before = None
        out = fn(*args, **kwargs)
        self._close()
        return out

    def get_comm_counts(self) -> Dict[str, int]:
        return dict(self.counts)

    def get_total_counts(self) -> int:
        return self.counts.get("total", 0)

    def get_comm_bytes(self) -> int:
        """Operand bytes of every collective counted (``BYTES`` delta)."""
        return sum(self.bytes.values())

    def attribute_plan(self, plan, compiled: bool = False, darray=None) -> Dict[str, Any]:
        """The collectives of a ``redistribute_plan.RedistributePlan``,
        hop by hop, from ``plan_comm_summary`` (what the telemetry bytes
        gauge reads).  ``compiled=True`` with ``darray`` (laid out as the
        plan's ``src`` on a live mesh) runs the hops on it and attaches
        each hop's issued collectives as ``hlo_collectives`` and the
        result as ``output``."""
        from .. import collectives as C
        from ..redistribute_plan import plan_comm_summary

        summary = plan_comm_summary(plan)
        if compiled:
            if darray is None:
                raise ValueError("attribute_plan(compiled=True) runs the hops: pass darray=")
            d = darray
            for hop, rec in zip(plan.hops, summary["hops"]):
                before = dict(C.CALLS)
                d = hop.apply(d)
                rec["hlo_collectives"] = count_calls(_delta(C.CALLS, before))
            summary["output"] = d
        self.plan_attribution = summary
        return summary

