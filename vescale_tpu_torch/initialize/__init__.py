"""Deferred initialization on the meta device (``deferred_init.py``)."""

from .deferred_init import (
    deferred_init,
    is_deferred,
    materialize_dparameter,
    materialize_dtensor,
    materialize_module,
)

__all__ = [
    "deferred_init",
    "is_deferred",
    "materialize_dparameter",
    "materialize_dtensor",
    "materialize_module",
]
