"""Auto-plan: derive a module's sharding plan from the module itself (the
port of ``vescale_tpu/dmp``)."""

from .dmp import PlanGenerator, auto_parallelize_module
from .policies.registry import get_policy, register_policy

__all__ = ["auto_parallelize_module", "PlanGenerator", "register_policy", "get_policy"]
