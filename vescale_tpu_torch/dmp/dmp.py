"""auto_parallelize_module (reference legacy/vescale/dmp/dmp.py:185): the
zero-plan entry point.  A policy derives the sharding plan from the
module's parameter names and shapes, then ``parallelize_module`` applies
it.

The port of ``vescale_tpu/dmp/dmp.py``.  The reference reads the abstract
parameter tree through ``jax.eval_shape``; here a module on ``meta`` (the
port's deferred init) has the same names and shapes and costs no memory:
``PlanGenerator.generate`` takes a module (on any device, only names and
shapes are read) or a factory and its arguments (e.g. ``Llama, config``),
which it calls under ``initialize.deferred_init``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from torch import nn

from ..dmodule.api import DModule, parallelize_module
from ..mesh import DeviceMesh
from . import policies  # noqa: F401  (registers the built-in policies)
from .policies.registry import get_policy

__all__ = ["auto_parallelize_module", "PlanGenerator"]


def abstract_params(module, *args, **kwargs) -> Dict[str, Any]:
    """``{name: tensor}`` of a module (its parameters, shapes only read);
    a factory is called with ``args`` on ``meta`` first."""
    if not isinstance(module, nn.Module):
        from ..initialize import deferred_init

        module = deferred_init(module, *args, **kwargs)
    return dict(module.named_parameters())


class PlanGenerator:
    """(reference dmp.py:61) a policy-driven plan from the module's
    parameter names and shapes."""

    def __init__(self, policy: str = "MEGATRON"):
        self.policy = policy

    def generate(self, module, mesh: DeviceMesh, *args, **kwargs) -> Dict[str, Any]:
        """The plan of ``module`` (or of ``module(*args, **kwargs)`` built on
        ``meta`` when it is a factory)."""
        return get_policy(self.policy)(abstract_params(module, *args, **kwargs), mesh)


def auto_parallelize_module(module: nn.Module, device_mesh: DeviceMesh, *,
                            policy: str = "MEGATRON",
                            init_fn: Optional[Callable] = None) -> DModule:
    """One call: derive the plan, then ``parallelize_module`` (reference
    auto_parallelize_module, dmp.py:185).  ``init_fn`` as for
    ``parallelize_module`` (a module built on ``meta``)."""
    plan = PlanGenerator(policy).generate(module, device_mesh)
    return parallelize_module(module, device_mesh, plan, init_fn=init_fn)
