"""The serve loop's fault envelope: preemption, fault injection, the hang
watchdog and the cross-rank desync error."""

from . import faultsim
from .consistency import DesyncError, compare_rows
from .preempt import PreemptionHandler
from .watchdog import Watchdog, dump_all_stacks

__all__ = ["DesyncError", "PreemptionHandler", "Watchdog", "compare_rows", "dump_all_stacks",
           "faultsim"]
