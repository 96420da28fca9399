"""Distributed-friendly pdb (reference legacy/vescale/debug/pdb.py): break
only on a chosen process, with stdin reopened from the terminal.

The port's copy of ``vescale_tpu/debug/pdb.py``."""

from __future__ import annotations

import pdb
import sys

__all__ = ["ForkedPdb", "set_trace"]


class ForkedPdb(pdb.Pdb):
    """Pdb that works from forked or spawned worker processes."""

    def interaction(self, *args, **kwargs):
        _stdin = sys.stdin
        try:
            sys.stdin = open("/dev/stdin")
            super().interaction(*args, **kwargs)
        finally:
            sys.stdin = _stdin


def set_trace(rank: int = 0, current_rank: int = 0) -> None:
    """Break only on ``rank`` (``current_rank``: this process's rank)."""
    if current_rank == rank:
        ForkedPdb().set_trace(sys._getframe().f_back)
