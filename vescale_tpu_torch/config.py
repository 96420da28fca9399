"""The port's knobs read from the environment, with the JAX package's defaults.

The same names and defaults as the serving, fleet, autoscaling,
resilience, faultsim, redistribute, planner, analysis, debug, checkpoint,
gradient-compression and telemetry knobs of
``vescale_tpu/analysis/envreg.py``; read live at
each call, without that module's registry machinery.  A knob whose default is ``None`` reads as
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
    # the SPMD core and the redistribution planner
    "VESCALE_STRICT_REDISTRIBUTE": False,
    "VESCALE_REDISTRIBUTE_QUANT": False,
    "VESCALE_REDISTRIBUTE_MEM_FACTOR": 4.0,
    "VESCALE_REDISTRIBUTE_MAX_HOPS": 3,
    # analysis and debugging: shardcheck's mode and the debug logger's gate
    "VESCALE_SHARDCHECK": "warn",
    "VESCALE_DEBUG_MODE": "",
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
    # telemetry: the time-series store, the alert engine, the cost auditor,
    # the calibration table, the clock sync and the fleet trace stream
    "VESCALE_TIMESERIES": True,
    "VESCALE_TIMESERIES_CADENCE_S": 1.0,
    "VESCALE_TIMESERIES_BASE_LEN": 512,
    "VESCALE_TIMESERIES_TIER_FACTOR": 8,
    "VESCALE_TIMESERIES_TIERS": 3,
    "VESCALE_ALERTS": True,
    "VESCALE_ALERTS_HISTORY": 256,
    "VESCALE_ALERTS_EVAL_INTERVAL_S": 0.25,
    "VESCALE_ALERTS_BURN_WINDOWS": None,
    "VESCALE_ALERTS_BURN_FOR_S": 0.0,
    "VESCALE_COSTAUDIT": True,
    "VESCALE_COSTAUDIT_DEPTH": 256,
    "VESCALE_COSTAUDIT_THRESHOLD": 3.0,
    "VESCALE_COSTAUDIT_DECAY": 0.25,
    "VESCALE_COSTAUDIT_CADENCE_S": 30.0,
    "VESCALE_COSTAUDIT_HARVEST": True,
    "VESCALE_COST_CALIBRATION": None,
    "VESCALE_CLOCK_SYNC_ROUNDS": 8,
    "VESCALE_FLEET_TRACE_DIR": None,
    "VESCALE_FLEET_TRACE_FLUSH_EVERY": 1,
    # the fleet router: polls, breakers, dispatch retries, hedging, its ops
    # port, the write-ahead journal and the leader lease (serve/router.py,
    # serve/journal.py)
    "VESCALE_FLEET_POLL_S": 0.05,
    "VESCALE_FLEET_POLL_TIMEOUT_S": 2.0,
    "VESCALE_FLEET_BREAKER_FAILURES": 3,
    "VESCALE_FLEET_BREAKER_COOLDOWN_S": 1.0,
    "VESCALE_FLEET_HEALTH_STALE_S": 10.0,
    "VESCALE_FLEET_RETRIES": 3,
    "VESCALE_FLEET_BACKOFF_S": 0.05,
    "VESCALE_FLEET_BACKOFF_MAX_S": 2.0,
    "VESCALE_FLEET_HEDGE_S": 0.0,
    "VESCALE_FLEET_OPS_PORT": None,
    "VESCALE_FLEET_JOURNAL_DIR": None,
    "VESCALE_FLEET_JOURNAL_FSYNC": "flush",
    "VESCALE_FLEET_JOURNAL_ROTATE_BYTES": 1048576,
    "VESCALE_FLEET_JOURNAL_SNAPSHOT_EVERY": 256,
    "VESCALE_FLEET_LEASE_PATH": None,
    "VESCALE_FLEET_LEASE_TTL_S": 2.0,
    # the fleet autoscaler (serve/autoscale.py)
    "VESCALE_AUTOSCALE_MIN": 1,
    "VESCALE_AUTOSCALE_MAX": 4,
    "VESCALE_AUTOSCALE_UP_BURN": 1.0,
    "VESCALE_AUTOSCALE_DOWN_BURN": 0.5,
    "VESCALE_AUTOSCALE_UP_QUEUE": 4,
    "VESCALE_AUTOSCALE_UP_HOLD_S": 1.0,
    "VESCALE_AUTOSCALE_DOWN_HOLD_S": 5.0,
    "VESCALE_AUTOSCALE_COOLDOWN_S": 5.0,
    "VESCALE_AUTOSCALE_WINDOW_S": 10.0,
    "VESCALE_AUTOSCALE_TICK_S": 0.25,
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
