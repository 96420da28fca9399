"""Parallelism plans of the port (the pipeline plan and its enums)."""

from .spec import (
    ModeType,
    PipelineP2PSpec,
    PipelineScheduleType,
    PipelineSplitMethodType,
    TracerType,
)
from .pipeline_parallel import PipelineParallelPlan

__all__ = [
    "ModeType",
    "PipelineP2PSpec",
    "PipelineParallelPlan",
    "PipelineScheduleType",
    "PipelineSplitMethodType",
    "TracerType",
]
