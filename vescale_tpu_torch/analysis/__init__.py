"""Analysis of the port: the coded findings model (``findings.py``) and
shardcheck (``shardcheck.py``).

The port of ``vescale_tpu/analysis``.  **shardcheck** propagates a
symbolic sharding through a program traced by ``torch.fx`` (``make_fx``
on ``meta`` tensors) and the planner's transitions: implicit
materialization, sharding conflicts, Partial misuse, donation misses,
rank-divergent collectives in the source, stage-boundary misfits.  The
``VSC12x`` decline codes are shared with the multi-hop redistribution
planner (``redistribute_plan``).  The reference's vescale-lint and its env
registry police the JAX package's own source and knobs; the port keeps its
knobs in ``config.py`` and has neither.

Mode: ``VESCALE_SHARDCHECK`` = ``off`` | ``warn`` (default) | ``strict``.
``warn`` surfaces error- and warning-severity findings as one Python
warning at the integration points (the DModule plan audit, the step
report); ``strict`` raises ``ShardcheckError``.  CLI: ``python -m
vescale_tpu_torch.analysis``.
"""

from __future__ import annotations

import warnings as _warnings

from .findings import CODES, Finding, FindingCode, FindingReport, Severity, code
from .shardcheck import (
    SymSharding,
    check_param_plan,
    check_stage_boundaries,
    check_transition,
    rank_divergence_findings,
    shardcheck,
    shardcheck_graph,
    shardcheck_module,
    sym_from_spec,
)

__all__ = [
    "CODES",
    "Finding",
    "FindingCode",
    "FindingReport",
    "Severity",
    "code",
    "SymSharding",
    "sym_from_spec",
    "shardcheck",
    "shardcheck_graph",
    "shardcheck_module",
    "check_transition",
    "check_stage_boundaries",
    "check_param_plan",
    "rank_divergence_findings",
    "mode",
    "enabled",
    "is_strict",
    "ShardcheckError",
    "dispatch_report",
]


class ShardcheckError(RuntimeError):
    """Raised in strict mode when a report carries error-severity findings."""

    def __init__(self, report: FindingReport):
        self.report = report
        super().__init__(report.format())


def mode() -> str:
    """``off`` | ``warn`` | ``strict`` (``VESCALE_SHARDCHECK``; an unknown
    value reads as ``warn``)."""
    from .. import config

    m = (config.get_str("VESCALE_SHARDCHECK") or "warn").strip().lower()
    return m if m in ("off", "warn", "strict") else "warn"


def enabled() -> bool:
    return mode() != "off"


def is_strict() -> bool:
    return mode() == "strict"


def dispatch_report(report: FindingReport, stacklevel: int = 2) -> FindingReport:
    """Route a report by the mode: strict raises on an error-severity
    finding, warn emits one aggregated warning, off (or a clean report)
    stays silent.  Returns the report."""
    if not enabled() or not report.findings:
        return report
    if report.count(Severity.ERROR) and is_strict():
        raise ShardcheckError(report)
    if report.count(Severity.WARNING):
        _warnings.warn("shardcheck: " + report.format(), stacklevel=stacklevel + 1)
    return report
