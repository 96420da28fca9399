"""Plan-driven tensor and sequence parallelism (``parallelize_module``)."""

from .api import DModule, PlacementsInterface, parallelize_module

__all__ = ["DModule", "PlacementsInterface", "parallelize_module"]
