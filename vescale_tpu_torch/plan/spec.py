"""Plan enums — the port of ``vescale_tpu/plan/spec.py`` (legacy veScale's
``plan/spec.py``), with the same names and values, so a plan moves between
the packages by its values."""

from __future__ import annotations

import dataclasses
import enum

__all__ = [
    "ModeType",
    "PipelineSplitMethodType",
    "PipelineScheduleType",
    "TracerType",
    "PipelineP2PSpec",
]


class ModeType(enum.Enum):
    EAGER = "eager"
    GRAPH_EAGER = "graph_eager"
    COMPILE = "compile"  # the compiled pipeline over a pp mesh (pipe/spmd.py)


class PipelineSplitMethodType(enum.Enum):
    UNIFORM = "uniform"
    MANUAL = "manual"
    PARAMETERS = "parameters"  # balance by parameter count
    AUTOBALANCE = "autobalance"
    FLOPS = "flops"


class PipelineScheduleType(enum.Enum):
    SIMPLE_1F1B = "1f1b"
    INTERLEAVED_1F1B = "interleaved_1f1b"
    GPIPE = "gpipe"
    ZERO_BUBBLE = "zbv"
    GRAPH_PIPE = "graph_pipe"


class TracerType(enum.Enum):
    """How a model is cut into pipeline stages.  MODULE_PATH splits an
    explicit list of stage units (``pipe/pipe_stage.py``); every other
    value traces ``fn(params, x)`` into a torch.fx graph and cuts its node
    list by FLOPs (``pipe/graph_split.py``).  ``JAXPR`` keeps the
    reference's name for that mode, so a plan of either package means the
    same split."""

    VESCALE_FX = "vescale_fx"
    HF_FX = "hf_fx"
    TORCH_DYNAMO = "dynamo"
    MODULE_PATH = "module_path"  # explicit stage-unit lists
    JAXPR = "jaxpr"              # graph-level auto-split (pipe/graph_split.py)


@dataclasses.dataclass
class PipelineP2PSpec:
    """The p2p tensor spec for manual stage IO (legacy ``plan/spec.py``)."""

    peer_stage_idx: int
    peer_output_idx: int = 0
