"""Preemption handling: SIGTERM/SIGINT become a flag the serve loop reads at
its step boundaries.

A copy of ``vescale_tpu/resilience/preempt.py``.  The signal callback only
sets a flag (and remembers which signal); the drain happens on the serving
thread at the next boundary.  ``request()`` is the programmatic twin that
faultsim's ``preempt`` kind and tests use.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """SIGTERM/SIGINT -> stop flag; checked at step boundaries.

        handler = PreemptionHandler().install()
        ...
        if handler.requested():
            <drain>
        handler.uninstall()

    ``install`` chains: the previous handlers are saved and restored by
    ``uninstall``.  Installing from a thread other than the main one wires
    no signal (CPython allows ``signal.signal`` only there); ``request()``
    still works."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._signum: Optional[int] = None
        self._prev = {}
        self._installed = False

    def _on_signal(self, signum, frame):
        # flag only: the handler runs between the main thread's bytecodes,
        # so taking a lock here could deadlock against the code it interrupted
        self._signum = signum
        self._flag.set()

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):  # not the main thread / exotic prev
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def request(self, signum: Optional[int] = None) -> None:
        """Programmatic preemption (faultsim, tests, orchestrators)."""
        self._signum = signum
        self._flag.set()

    def requested(self) -> bool:
        return self._flag.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def clear(self) -> None:
        """Re-arm after a handled preemption."""
        self._signum = None
        self._flag.clear()
