"""patch_method (reference vescale/utils/monkey_patch.py, via
``vescale_tpu/model/patch/monkey_patch.py``) — swap a method on a class or
an instance, returning an undo handle.  ``DModule`` binds ``fqn:method``
forward-plan entries with it."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["patch_method"]


def patch_method(target: Any, name: str, new_fn: Callable) -> Callable[[], None]:
    """Set ``target.name = new_fn``; the returned ``undo()`` puts the old
    attribute back (an instance patch is removed, uncovering the class's)."""
    had_own = name in getattr(target, "__dict__", {})
    old = getattr(target, name)
    setattr(target, name, new_fn)

    def undo() -> None:
        if had_own or isinstance(target, type):
            setattr(target, name, old)
        else:
            delattr(target, name)

    return undo
