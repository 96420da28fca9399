"""vescale_tpu_torch.resilience: fault tolerance for training and serving.

The port of ``vescale_tpu/resilience``:

  1. **faultsim** (``faultsim.py``): deterministic fault injection keyed on
     call counts or steps, zero cost disarmed.
  2. **retry** (``retry.py``): ``RetryPolicy`` with bounded attempts and
     seeded backoff, wired into the checkpoint storage (``ckpt_policy``)
     and ``TokenDataLoader.next`` (``loader_policy``).
  3. **preempt** (``preempt.py``): SIGTERM / SIGINT set a stop flag read
     at step boundaries.
  4. **loop** (``loop.py``): ``run_resilient``, the auto-recovering train
     loop: auto-resume from the newest committed checkpoint, quarantine
     of a corrupt one, preemption with drain and emergency save, resize,
     the anomaly guard (NaN, optimizer skip, z-score spike: rollback and
     replay, then a data skip), in-process restarts after a step
     exception, and across processes the coordinated protocol.
  5. **watchdog** (``watchdog.py``): a heartbeat with a step-progress
     deadline; a hang becomes a stack dump, a flight record and an
     optional abort.
  6. **consistency** (``consistency.py``): cross-rank fingerprints that
     raise ``DesyncError`` before a divergent rank can commit a save.

The serve loop's envelope (``serve/loop.py``) uses faultsim, preempt, the
watchdog and the desync error.  Every recovery event is a ``resilience_*``
or ``consistency_*`` counter in the telemetry registry (the ``resilience:``
block of the dashboard) and an event line in ``steps.jsonl``.
"""

from . import consistency, faultsim
from .consistency import ConsistencyChecker, DesyncError, compare_rows
from .faultsim import Fault, FaultInjector, arm_from_env, parse_schedule
from .loop import AnomalyPolicy, RunResult, run_resilient
from .preempt import PreemptionHandler
from .retry import RetryPolicy, ckpt_policy, loader_policy, reset_default_policies
from .watchdog import Watchdog, dump_all_stacks

__all__ = [
    "faultsim",
    "consistency",
    "Fault",
    "FaultInjector",
    "parse_schedule",
    "arm_from_env",
    "RetryPolicy",
    "ckpt_policy",
    "loader_policy",
    "reset_default_policies",
    "PreemptionHandler",
    "AnomalyPolicy",
    "RunResult",
    "run_resilient",
    "Watchdog",
    "dump_all_stacks",
    "ConsistencyChecker",
    "DesyncError",
    "compare_rows",
]
