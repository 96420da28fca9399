"""The port's knobs read from the environment, with the JAX package's defaults.

The same names and defaults as the serving, resilience, faultsim,
redistribute, checkpoint, gradient-compression and telemetry knobs of
``vescale_tpu/analysis/envreg.py``; read live at each call, without that
module's registry machinery.  A knob whose default is ``None`` reads as
``None`` while unset.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["DEFAULTS", "get_bool", "get_int", "get_float", "get_str"]

DEFAULTS = {
    "VESCALE_SERVE_SLOTS": 8,
    "VESCALE_SERVE_PAGE_SIZE": 16,
    "VESCALE_SERVE_PAGES_PER_SLOT": 4,
    "VESCALE_SERVE_MAX_QUEUE": 64,
    "VESCALE_SERVE_SLO_TTFT_S": 0.0,
    "VESCALE_SERVE_TENANT_WEIGHTS": None,
    "VESCALE_SERVE_PREFIX_CACHE": False,
    "VESCALE_SERVE_PREFIX_CACHE_PAGES": 0,
    "VESCALE_SPEC_K": 4,
    "VESCALE_SPEC_DRAFTER_LAYERS": 1,
    # the resilient loop's envelope
    "VESCALE_SERVE_DEADLINE_S": 0.0,
    "VESCALE_SERVE_OPS_PORT": None,
    "VESCALE_SERVE_IDLE_S": 0.002,
    "VESCALE_SERVE_REPLICA_ID": None,
    "VESCALE_BARRIER_TIMEOUT": None,
    "VESCALE_WATCHDOG_TIMEOUT": 0.0,
    "VESCALE_WATCHDOG_ABORT": True,
    "VESCALE_WATCHDOG_EXIT_CODE": 17,
    "VESCALE_WATCHDOG_DIR": None,
    "VESCALE_FAULTSIM": None,
    "VESCALE_FAULTSIM_HANG_S": 3600.0,
    "VESCALE_FAULTSIM_SLOW_DECODE_S": 0.05,
    "VESCALE_FAULTSIM_KILL_EXIT_CODE": 29,
    # the SPMD core
    "VESCALE_STRICT_REDISTRIBUTE": False,
    # the checkpoint and its storage retries
    "VESCALE_NATIVE_CKPT_IO": True,
    "VESCALE_CKPT_RETRIES": 3,
    "VESCALE_IO_BACKOFF_BASE": 0.05,
    "VESCALE_IO_BACKOFF_MAX": 5.0,
    "VESCALE_IO_BACKOFF_JITTER": 0.25,
    "VESCALE_IO_ATTEMPT_TIMEOUT": 0.0,
    "VESCALE_ELASTIC_RESTORE": True,
    # the train loop: the loader's retries and the consistency cadence
    "VESCALE_LOADER_RETRIES": 3,
    "VESCALE_CONSISTENCY_EVERY": None,
    # the int8 gradient collectives (parallel/ddp.py, collectives.py)
    "VESCALE_GRAD_COMPRESS": "",
    "VESCALE_GRAD_COMPRESS_BLOCK": 64,
    "VESCALE_GRAD_COMPRESS_SR": False,
    "VESCALE_GRAD_COMPRESS_SEED": 0,
}
# envreg's booleans: unset takes the default; these (case-insensitive) are
# false, anything else is true
_FALSE = ("", "0", "false", "off", "no")


def _raw(name: str) -> Optional[str]:
    if name not in DEFAULTS:
        raise KeyError(f"{name} is not a knob of the port")
    v = os.environ.get(name)
    return v if v not in (None, "") else None


def get_bool(name: str) -> bool:
    if name not in DEFAULTS:
        raise KeyError(f"{name} is not a knob of the port")
    v = os.environ.get(name)
    return bool(DEFAULTS[name]) if v is None else v.strip().lower() not in _FALSE


def get_int(name: str) -> Optional[int]:
    v = _raw(name)
    if v is None:
        return None if DEFAULTS[name] is None else int(DEFAULTS[name])
    return int(v)


def get_float(name: str) -> Optional[float]:
    v = _raw(name)
    if v is None:
        return None if DEFAULTS[name] is None else float(DEFAULTS[name])
    return float(v)


def get_str(name: str) -> Optional[str]:
    v = _raw(name)
    return DEFAULTS[name] if v is None else v
