"""Deterministic fault injection: the test substrate of the serve loop's
fault envelope.

A copy of ``vescale_tpu/resilience/faultsim.py``, grammar and all.  A fault
fires at a deterministic point keyed on the per-kind **call counter** (the
Nth time the hook is consulted) or on the **step** published by
``set_step``, optionally repeating ``count`` consecutive times; a seeded
probability mode (``p`` + ``seed``) hashes the call index so even "random"
faults replay exactly.  The schedule comes from ``arm([...])`` or the
``VESCALE_FAULTSIM`` knob:

    VESCALE_FAULTSIM="oom:step=4;request_timeout:step=6;preempt:step=9"
    VESCALE_FAULTSIM="oom:step=4,rank=0"     # only rank 0 fires

Grammar: ``kind:key=value[,key=value...]`` joined by ``;``; keys are
``call`` (0-based per-kind call index), ``step``, ``count`` (default 1),
``p`` (probability per call), ``seed`` and ``rank`` (a filter: the same
text armed on every process fires on that rank only).  A fault fires at
most ``count`` times in all.

Every kind of the JAX package is accepted (``KINDS``).  The port's serve
loop consults ``preempt``, ``oom``, ``hang`` (sleeps
``VESCALE_FAULTSIM_HANG_S``), ``request_timeout``, ``slow_decode`` (sleeps
``VESCALE_FAULTSIM_SLOW_DECODE_S``) and ``replica_kill`` (``os._exit`` with
``VESCALE_FAULTSIM_KILL_EXIT_CODE``); its ops server consults
``poll_blackhole``.  The others have no hook site in the port yet.

Gating: while disarmed the module hooks ``check`` / ``fires`` / ``set_step``
ARE the no-op functions ``_noop_check`` / ``_noop_fires`` /
``_noop_set_step``, so a run pays one attribute access and call per hook
site.  Call them as ``faultsim.fires(...)``, never bind them with ``from
faultsim import fires`` (that freezes the disarmed binding).
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "KINDS",
    "Fault",
    "FaultInjector",
    "arm",
    "disarm",
    "is_armed",
    "get_injector",
    "parse_schedule",
    "arm_from_env",
    "check",
    "fires",
    "set_step",
]

KINDS = (
    "storage_write",
    "storage_read",
    "loader_next",
    "nonfinite_loss",
    "preempt",
    "oom",
    "hang",
    "resize",
    "request_timeout",
    "slow_decode",
    "replica_kill",
    "poll_blackhole",
    "canary_diverge",
    "router_kill",
    "journal_torn_write",
)

# errors raised by `check` per kind; observation kinds never raise — their
# callers use `fires` and act on the bool
_RAISES = {
    "storage_write": lambda ctx: OSError(f"[faultsim] injected storage write failure ({ctx})"),
    "storage_read": lambda ctx: OSError(f"[faultsim] injected storage read failure ({ctx})"),
    "loader_next": lambda ctx: RuntimeError(f"[faultsim] injected native loader failure ({ctx})"),
    "oom": lambda ctx: RuntimeError(
        f"RESOURCE_EXHAUSTED: [faultsim] injected out-of-memory ({ctx})"
    ),
}


def _splitmix64(x: int) -> int:
    """Deterministic 64-bit mix: the seeded probability mode replays
    bit-exactly across runs."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _process_rank() -> int:
    """This process's rank for the ``rank=`` selector: the
    ``torch.distributed`` rank while a process group is up, else the
    ``RANK`` variable of the torchrun contract, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    env = os.environ.get("RANK")
    return int(env) if env not in (None, "") else 0


@dataclass
class Fault:
    """One scheduled fault.  Exactly one trigger: ``at_call`` (0-based
    per-kind call index), ``at_step`` (via ``set_step``) or ``p`` (seeded
    per-call probability).  ``count`` consecutive firings; ``rank``
    restricts firing to one process."""

    kind: str
    at_call: Optional[int] = None
    at_step: Optional[int] = None
    p: float = 0.0
    seed: int = 0
    count: int = 1
    rank: Optional[int] = None
    fired: int = field(default=0, init=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")
        triggers = (self.at_call is not None) + (self.at_step is not None) + (self.p > 0)
        if triggers != 1:
            raise ValueError(
                f"fault {self.kind}: exactly one trigger of call/step/p required"
            )

    def should_fire(self, call_index: int, step: Optional[int]) -> bool:
        # the rank selector is a filter, not a trigger
        if self.rank is not None and self.rank != _process_rank():
            return False
        # at most `count` firings in all: a step-keyed fault must not fire
        # again when a recovery replays the same step
        if self.fired >= self.count:
            return False
        if self.at_call is not None:
            return self.at_call <= call_index < self.at_call + self.count
        if self.at_step is not None:
            return step is not None and self.at_step <= step < self.at_step + self.count
        # seeded probability: crc32 of the kind, not hash() (salted per process)
        h = _splitmix64(
            self.seed * 1000003 + zlib.crc32(self.kind.encode()) + call_index * 2654435761
        )
        return (h / 2.0**64) < self.p


class FaultInjector:
    """Live schedule state: per-kind call counters and the current step.
    Exists only between ``arm`` and ``disarm``."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self.calls: Dict[str, int] = {k: 0 for k in KINDS}
        self.fired_total: Dict[str, int] = {k: 0 for k in KINDS}
        self.step: Optional[int] = None
        self._lock = threading.Lock()  # the ops server consults from its thread

    def _consult(self, kind: str, ctx: str) -> bool:
        with self._lock:
            idx = self.calls[kind]
            self.calls[kind] = idx + 1
            hit = False
            for f in self.faults:
                if f.kind == kind and f.should_fire(idx, self.step):
                    f.fired += 1
                    hit = True
            if hit:
                self.fired_total[kind] += 1
        return hit

    def check(self, kind: str, ctx: str = "") -> None:
        """Raise the kind's injected error if a fault is due (raising
        kinds); observation kinds never raise here."""
        if self._consult(kind, ctx) and kind in _RAISES:
            raise _RAISES[kind](ctx or f"call#{self.calls[kind] - 1}")

    def fires(self, kind: str, ctx: str = "") -> bool:
        """Consume one call slot and report whether a fault fires."""
        return self._consult(kind, ctx)

    def set_step(self, step: int) -> None:
        self.step = int(step)


def _noop_check(kind: str, ctx: str = "") -> None:
    return None


def _noop_fires(kind: str, ctx: str = "") -> bool:
    return False


def _noop_set_step(step: int) -> None:
    return None


check = _noop_check
fires = _noop_fires
set_step = _noop_set_step

_INJECTOR: Optional[FaultInjector] = None


def is_armed() -> bool:
    return _INJECTOR is not None


def get_injector() -> Optional[FaultInjector]:
    return _INJECTOR


def arm(faults: List[Fault]) -> FaultInjector:
    """Install a fault schedule and rebind the live hooks.  Re-arming
    replaces the previous schedule (counters restart at zero)."""
    global _INJECTOR, check, fires, set_step
    _INJECTOR = FaultInjector(faults)
    check = _INJECTOR.check
    fires = _INJECTOR.fires
    set_step = _INJECTOR.set_step
    return _INJECTOR


def disarm() -> None:
    """Drop the schedule and restore the no-op hooks."""
    global _INJECTOR, check, fires, set_step
    _INJECTOR = None
    check = _noop_check
    fires = _noop_fires
    set_step = _noop_set_step


def parse_schedule(text: str) -> List[Fault]:
    """Parse the ``VESCALE_FAULTSIM`` grammar (module docstring)."""
    faults: List[Fault] = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, argstr = part.partition(":")
        kind = kind.strip()
        kwargs: Dict[str, float] = {}
        if argstr:
            for kv in argstr.split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k not in ("call", "step", "count", "p", "seed", "rank"):
                    raise ValueError(f"faultsim spec {part!r}: unknown key {k!r}")
                kwargs[k] = float(v) if k == "p" else int(v)
        faults.append(
            Fault(
                kind,
                at_call=int(kwargs["call"]) if "call" in kwargs else None,
                at_step=int(kwargs["step"]) if "step" in kwargs else None,
                p=float(kwargs.get("p", 0.0)),
                seed=int(kwargs.get("seed", 0)),
                count=int(kwargs.get("count", 1)),
                rank=int(kwargs["rank"]) if "rank" in kwargs else None,
            )
        )
    return faults


def arm_from_env(var: str = "VESCALE_FAULTSIM") -> Optional[FaultInjector]:
    """Arm from the schedule in ``var`` if it is set; None otherwise.
    ``VESCALE_FAULTSIM`` is read through the port's knobs; any other name
    is read as it stands."""
    from ..serve import config as _config

    if var in _config.DEFAULTS:
        text = _config.get_str(var)
    else:
        text = os.environ.get(var)
    if not text:
        return None
    return arm(parse_schedule(text))
