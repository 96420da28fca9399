"""ndtimeline public API (reference legacy/vescale/ndtimeline/api.py:72
init_ndtimers, :318 flush, :293 wait, :309 inc_step)."""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

from .timer import NDTimerManager
from .world_info import WorldInfo

__all__ = [
    "init_ndtimers",
    "deinit_ndtimers",
    "flush",
    "wait",
    "inc_step",
    "ndtimeit",
    "ndtimer",
    "get_manager",
    "is_active",
]

_MANAGER: Optional[NDTimerManager] = None
_ACTIVE = False  # set ONLY by init_ndtimers: the runtime auto-
# instrumentation gate.  A stray flush()/inc_step() on an un-profiled run
# auto-creates a manager (API compat) but must NOT flip instrumentation on.


def get_manager() -> NDTimerManager:
    global _MANAGER
    if _MANAGER is None:
        _MANAGER = NDTimerManager()
    return _MANAGER


def init_ndtimers(rank: int = 0, mesh=None, handlers=(), max_spans: int = 100_000) -> NDTimerManager:
    """(api.py:72) — create the global manager, register handlers."""
    global _MANAGER, _ACTIVE
    _ACTIVE = True
    _MANAGER = NDTimerManager(rank=rank, max_spans=max_spans)
    if mesh is not None:
        _MANAGER.world = WorldInfo.from_mesh(mesh, rank)
    for h in handlers:
        _MANAGER.register_handler(h)
    return _MANAGER


def deinit_ndtimers() -> None:
    """Deactivate the profiler and drop the global manager — the inverse
    of :func:`init_ndtimers`, for A/B overhead rungs (bench.py measures a
    traced leg then restores the dormant no-op state) and test teardown.
    Buffered spans that were never flushed are discarded."""
    global _MANAGER, _ACTIVE
    _ACTIVE = False
    _MANAGER = None


def flush(step_range=None, next_iteration: bool = False):
    """(api.py:318) Drain buffered spans to the registered handlers.

    ``step_range``: a ``range`` or ``(lo, hi)`` pair — only spans with
    ``lo <= span.step < hi`` are flushed (handlers see them, they are
    returned); spans OUTSIDE the window stay buffered for a later flush.
    ``next_iteration=True`` advances the global step counter after the
    flush (the reference's end-of-iteration flush shape)."""
    if step_range is not None:
        if isinstance(step_range, range):
            if step_range.step != 1:
                raise ValueError(
                    f"flush: strided step_range unsupported ({step_range})"
                )
            step_range = (step_range.start, step_range.stop)
        lo, hi = step_range
        if hi < lo:
            raise ValueError(f"flush: empty/inverted step_range ({lo}, {hi})")
    mgr = get_manager()
    spans = mgr.flush(step_range=step_range)
    if next_iteration:
        mgr.inc_step()
    return spans


def wait() -> None:
    """(api.py:293)"""
    get_manager().wait()


def inc_step(n: int = 1) -> None:
    """(api.py:309)"""
    get_manager().inc_step(n)


def is_active() -> bool:
    """True only after an EXPLICIT ``init_ndtimers`` — the gate the
    runtime's auto-instrumentation checks so un-profiled production runs
    pay nothing (a stray ``flush()``/``inc_step()`` must not activate it)."""
    return _ACTIVE and _MANAGER is not None


def ndtimeit(metric: str, tags=None):
    """Context manager: with ndtimeit("forward-compute"): ...

    A no-op (``nullcontext``) until the profiler is explicitly
    initialized: the runtime wiring (pipe engine, train step, checkpoint)
    calls this on every operation, and dormant instrumentation must not
    build TraceAnnotations, take locks, or grow a ring buffer nobody
    flushes."""
    if not is_active():
        return contextlib.nullcontext()
    return _MANAGER.timeit(metric, tags)


def ndtimer(metric: str):
    """Decorator form.  Resolves the manager at CALL time through
    ``ndtimeit``: dormant runs pay nothing, and an ``init_ndtimers`` after
    decoration is picked up (a decoration-time manager binding would both
    defeat the _ACTIVE gate and orphan the spans when the global manager is
    replaced)."""

    def deco(fn):
        @functools.wraps(fn)  # keep __name__/__doc__ for introspection
        # (debug dumps, functools caches, help())
        def wrapped(*args, **kwargs):
            with ndtimeit(metric):
                return fn(*args, **kwargs)

        return wrapped

    return deco
