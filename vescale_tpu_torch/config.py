"""The port's knobs read from the environment: a view over the registry.

``analysis/envreg.py`` declares every knob once, with the JAX package's
name, type, default and doc; ``DEFAULTS`` is derived from it.  These
accessors read live at each call and raise ``KeyError`` on a name the
registry does not hold.  A knob whose default is ``None`` reads as
``None`` while unset; a knob set empty reads as unset (where
``envreg.get_str`` returns the empty string).
"""

from __future__ import annotations

from typing import Optional

from .analysis import envreg

__all__ = ["DEFAULTS", "get_bool", "get_int", "get_float", "get_str"]

DEFAULTS = {v.name: v.default for v in envreg.all_vars()}
get_bool = envreg.get_bool
get_int = envreg.get_int
get_float = envreg.get_float


def get_str(name: str) -> Optional[str]:
    """``envreg.get_str``, but a knob set empty reads as unset."""
    return envreg.get_raw(name) or DEFAULTS[name]
