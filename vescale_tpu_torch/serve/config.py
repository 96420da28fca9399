"""Serve knobs read from the environment, with the JAX package's defaults.

The same names and defaults as the serving block of
``vescale_tpu/analysis/envreg.py``; read live at each call, without that
module's registry machinery.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["DEFAULTS", "get_int", "get_float", "get_str"]

DEFAULTS = {
    "VESCALE_SERVE_SLOTS": 8,
    "VESCALE_SERVE_PAGE_SIZE": 16,
    "VESCALE_SERVE_PAGES_PER_SLOT": 4,
    "VESCALE_SERVE_MAX_QUEUE": 64,
    "VESCALE_SERVE_SLO_TTFT_S": 0.0,
    "VESCALE_SERVE_TENANT_WEIGHTS": None,
}


def _raw(name: str) -> Optional[str]:
    if name not in DEFAULTS:
        raise KeyError(f"{name} is not a serve knob of the port")
    v = os.environ.get(name)
    return v if v not in (None, "") else None


def get_int(name: str) -> int:
    v = _raw(name)
    return int(DEFAULTS[name]) if v is None else int(v)


def get_float(name: str) -> float:
    v = _raw(name)
    return float(DEFAULTS[name]) if v is None else float(v)


def get_str(name: str) -> Optional[str]:
    v = _raw(name)
    return DEFAULTS[name] if v is None else v
