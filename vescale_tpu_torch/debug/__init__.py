"""Debugging aids: the collective counter, the debug logger, a pdb for
worker processes (the port of ``vescale_tpu/debug``)."""

from .debug_log import DebugLogger
from .comm_mode import CommDebugMode, comm_counts
from . import pdb

__all__ = ["DebugLogger", "CommDebugMode", "comm_counts", "pdb"]
