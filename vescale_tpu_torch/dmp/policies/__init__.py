from . import megatron, registry  # noqa: F401
