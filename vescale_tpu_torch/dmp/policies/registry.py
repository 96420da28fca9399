"""Auto-plan policy registry (reference legacy/vescale/dmp/policies/
registry.py:22): named policies mapping a module's parameters to
parameter and forward plans.  The port's copy of
``vescale_tpu/dmp/policies/registry.py``."""

from __future__ import annotations

from typing import Callable, Dict

__all__ = ["register_policy", "get_policy", "POLICIES"]

POLICIES: Dict[str, Callable] = {}


def register_policy(name: str):
    def deco(fn: Callable):
        POLICIES[name.upper()] = fn
        return fn

    return deco


def get_policy(name: str) -> Callable:
    key = name.upper()
    if key not in POLICIES:
        raise KeyError(f"unknown auto-plan policy {name!r}; have {sorted(POLICIES)}")
    return POLICIES[key]
