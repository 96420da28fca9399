"""Pipeline parallelism of the port — ``vescale_tpu/pipe/``: stage units
and their split (``pipe_stage``), the schedules (``schedules``), the eager
engine (``engine``), the split of a traced graph (``graph_split``) and the
compiled pipeline over a ``pp`` mesh (``spmd``)."""

from .pipe_stage import PipeModule, StageUnit, construct_pipeline_stage
from .schedules import (
    Instruction,
    InstructionKind,
    StageCosts,
    gpipe_schedule,
    one_f_one_b_schedule,
    interleaved_1f1b_schedule,
    zero_bubble_schedule,
    zero_bubble_cost_schedule,
    simulate_schedule,
    estimate_stage_costs,
    build_schedule,
)
from .engine import PipeEngine, PendingWgrad
from .graph_split import GraphPipeModule, split_graph

__all__ = [
    "PipeModule",
    "StageUnit",
    "construct_pipeline_stage",
    "Instruction",
    "InstructionKind",
    "StageCosts",
    "gpipe_schedule",
    "one_f_one_b_schedule",
    "interleaved_1f1b_schedule",
    "zero_bubble_schedule",
    "zero_bubble_cost_schedule",
    "simulate_schedule",
    "estimate_stage_costs",
    "build_schedule",
    "PipeEngine",
    "PendingWgrad",
    "GraphPipeModule",
    "split_graph",
    "build_pipe_module",
]


def build_pipe_module(plan, *, units=None, fn=None, params_example=None, x_example=None):
    """A pipeline module per ``plan.tracer_type`` (the legacy
    PipeParser.parse dispatch, pipe_parser.py:60): MODULE_PATH splits an
    explicit ``units`` list; every tracer type (VESCALE_FX, HF_FX,
    TORCH_DYNAMO, JAXPR) splits the traced ``fn(params, x)`` graph."""
    from ..plan import TracerType

    if plan.tracer_type == TracerType.MODULE_PATH:
        if units is None:
            raise ValueError("MODULE_PATH tracer needs `units`")
        return construct_pipeline_stage(units, plan, x_example)
    if fn is None or params_example is None or x_example is None:
        raise ValueError(f"{plan.tracer_type} tracer needs fn, params_example and x_example")
    return split_graph(fn, params_example, x_example, plan)
