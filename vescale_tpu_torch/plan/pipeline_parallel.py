"""``PipelineParallelPlan`` — the port of
``vescale_tpu/plan/pipeline_parallel.py`` (legacy veScale's
``plan/pipeline_parallel.py:28``): the same fields, defaults and
``__post_init__`` rules."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from .spec import ModeType, PipelineScheduleType, PipelineSplitMethodType, TracerType

__all__ = ["PipelineParallelPlan"]


@dataclasses.dataclass
class PipelineParallelPlan:
    mode: ModeType = ModeType.EAGER
    split_method: PipelineSplitMethodType = PipelineSplitMethodType.UNIFORM
    num_stages: int = 2
    virtual_chunks: int = 1
    split_points: Optional[Sequence[str]] = None  # unit names ending each group
    batch_p2p_comm: bool = True          # parity flags of the legacy plan
    overlap_p2p_comm: bool = True
    use_zero_bubble: bool = False
    schedule_type: PipelineScheduleType = PipelineScheduleType.SIMPLE_1F1B
    num_model_chunks: int = 1
    tracer_type: TracerType = TracerType.MODULE_PATH
    smallest_unsplittable_units: Optional[Sequence[str]] = None
    uniform_split_ops: bool = False
    p2p_tensor_shapes: Optional[Any] = None
    reuse_p2p_tensor_shape: bool = False
    forward_only: bool = False
    # cost model for ZERO_BUBBLE (pipe.schedules.StageCosts or per-stage
    # weights): routes scheduling through the cost-graph generator
    schedule_costs: Optional[Any] = None
    # declared cross-stage activation layouts: per boundary i, the
    # placements stage i emits and stage i+1 expects
    stage_out_placements: Optional[Sequence[Any]] = None
    stage_in_placements: Optional[Sequence[Any]] = None

    def __post_init__(self):
        if self.schedule_type == PipelineScheduleType.INTERLEAVED_1F1B and self.virtual_chunks < 2:
            self.virtual_chunks = max(2, self.num_model_chunks)
        if self.use_zero_bubble:
            self.schedule_type = PipelineScheduleType.ZERO_BUBBLE
        if (self.stage_out_placements is None) != (self.stage_in_placements is None):
            raise ValueError(
                "stage_out_placements and stage_in_placements must be "
                "declared together (one per stage boundary)"
            )
        if self.stage_out_placements is not None and (
            len(self.stage_out_placements) != len(self.stage_in_placements)
        ):
            raise ValueError(
                "stage_out_placements and stage_in_placements must have "
                "equal length (one entry per stage boundary)"
            )

    def boundary_report(self, mesh, activation_shape, dtype=None):
        """The declared cross-stage layouts audited through
        ``analysis.check_stage_boundaries``: boundary i's output spec
        against its input spec on ``mesh``, for an activation of
        ``activation_shape`` (fp32 unless ``dtype``).  VSC106 where the
        move would take the fallback, VSC108 where the planner carries it;
        a report with no findings when nothing is declared."""
        import torch

        from ..analysis import FindingReport, check_stage_boundaries
        from ..placements import normalize_placements
        from ..spec import DArraySpec, TensorMeta

        if self.stage_out_placements is None:
            return FindingReport("pipeline boundaries")
        meta = TensorMeta(tuple(activation_shape), dtype or torch.float32)
        n = len(meta.shape)

        def spec(pl):
            return DArraySpec(mesh, normalize_placements(pl, mesh.ndim, n), meta)

        return check_stage_boundaries(
            [spec(o) for o in self.stage_out_placements],
            [spec(i) for i in self.stage_in_placements], name="pipeline boundaries")
