"""The findings model — one coded vocabulary for every static diagnostic.

The port's copy of ``vescale_tpu/analysis/findings.py``, whole: the port
imports nothing of the JAX package, so it keeps its own.  The checkpoint's
elastic preflight reports through it (VSC130-132).

Every diagnostic the analysis layer emits — shardcheck program findings,
``vescale-lint`` framework-invariant violations, and the redistribution
planner's decline reasons — is a :class:`Finding` carrying a stable
``VSC###`` code, a severity, optional mesh-dim / op provenance, and (for
data-movement findings) an estimated byte count priced by the collective
cost model in ``collectives.py``.  Stable codes are the contract: the CLI
greps them, tests assert them, docs/known_failures.md indexes by them, and
``redistribute_plan`` reuses the VSC12x block as its structured decline
reasons instead of free-form strings.

Code blocks:

  VSC10x  shardcheck — sharded-program hazards (materialization, Partial
          misuse, donation misses, divergent control flow, stage misfits)
  VSC12x  redistribute planner decline reasons (shared with
          ``redistribute_plan.decline_reason`` / ``_warn_fallback``)
  VSC13x  elastic restore — cross-world checkpoint compatibility
          (``checkpoint.elastic`` preflight, raised BEFORE chunk bytes are
          read; the loader's global-cursor re-split shares the block)
  VSC20x  vescale-lint — framework invariants established by PRs 1-5
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Severity",
    "FindingCode",
    "Finding",
    "FindingReport",
    "CODES",
    "code",
]


class Severity(enum.IntEnum):
    """Ordered so ``max(findings)`` and threshold comparisons read naturally."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR" — for CLI lines
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class FindingCode:
    """A stable diagnostic code: identity + default severity + title."""

    code: str  # "VSC101"
    severity: Severity
    title: str

    def __str__(self) -> str:
        return self.code


_CODE_DEFS: Tuple[Tuple[str, Severity, str], ...] = (
    # --- VSC10x: shardcheck program findings -----------------------------
    ("VSC101", Severity.ERROR,
     "implicit full materialization of a sharded operand"),
    ("VSC102", Severity.WARNING,
     "sharding conflict forces a reshard between operands"),
    ("VSC103", Severity.ERROR,
     "Partial placement consumed by a non-linear op"),
    ("VSC104", Severity.ERROR,
     "collective under rank-divergent Python control flow (deadlock hazard)"),
    ("VSC105", Severity.WARNING,
     "donation miss: step input is rebuilt as an output but not donated"),
    ("VSC106", Severity.ERROR,
     "cross-stage resharding mismatch would hit the materializing fallback"),
    ("VSC107", Severity.WARNING,
     "suspicious parameter placement in a sharding plan"),
    ("VSC108", Severity.INFO,
     "cross-stage resharding resolved by the multi-hop planner (costed)"),
    ("VSC109", Severity.INFO,
     "analysis could not run (untraceable program or aborted walk)"),
    # --- VSC12x: redistribute planner decline reasons --------------------
    ("VSC120", Severity.ERROR,
     "every candidate path needs an intermediate above the per-shard memory budget"),
    ("VSC121", Severity.ERROR,
     "no per-shard hop sequence within the hop bound over the candidate lattice"),
    ("VSC122", Severity.ERROR,
     "cross-mesh: a side has no plain unpadded per-shard bridge form"),
    ("VSC123", Severity.ERROR,
     "cross-mesh: the unpadded bridge spec exceeds the per-shard memory budget"),
    ("VSC124", Severity.ERROR,
     "cross-mesh: source-side strip to the bridge form failed"),
    ("VSC125", Severity.ERROR,
     "cross-mesh: destination-side dress from the bridge form failed"),
    ("VSC126", Severity.INFO,
     "planner was not consulted for this spec pair"),
    ("VSC127", Severity.INFO,
     "quantized (int8) redistribution hop declined: cost model or layout does not favor it"),
    ("VSC128", Severity.INFO,
     "transition routed through a LOSSY int8-quantized hop (gated by VESCALE_REDISTRIBUTE_QUANT)"),
    # --- VSC13x: elastic restore (cross-world checkpoint compatibility) --
    ("VSC130", Severity.INFO,
     "checkpoint written by a different mesh/world size; resharding on load"),
    ("VSC131", Severity.ERROR,
     "checkpoint/template logical shape mismatch (not a reshardable layout change)"),
    ("VSC132", Severity.ERROR,
     "elastic restore disabled (VESCALE_ELASTIC_RESTORE=0) but writer mesh differs"),
    ("VSC133", Severity.ERROR,
     "loader position cannot be re-split: global batch shape changed across the resume"),
    # --- VSC20x: vescale-lint framework invariants -----------------------
    ("VSC201", Severity.ERROR,
     "direct os.environ read of a VESCALE_* variable outside analysis.envreg"),
    ("VSC202", Severity.ERROR,
     "VESCALE_* variable not registered in analysis.envreg"),
    ("VSC203", Severity.ERROR,
     "disarmed hook bound to a non-module-level callable (gating contract)"),
    ("VSC204", Severity.ERROR,
     "lock/allocation/IO inside a signal-handler frame"),
    ("VSC205", Severity.ERROR,
     "bare except in a retry loop swallows KeyboardInterrupt"),
    ("VSC206", Severity.ERROR,
     "kernel library load or kernel op definition outside vescale_tpu_torch/kernels "
     "(device dispatch and launch counts)"),
    ("VSC207", Severity.WARNING,
     "ad-hoc warn-once latch outside the alert engine (telemetry/alerts.py)"),
    ("VSC208", Severity.WARNING,
     "priced decision (simulate_schedule/estimate_stage_costs) without a cost-audit record_prediction"),
)

CODES: Dict[str, FindingCode] = {
    c: FindingCode(c, sev, title) for c, sev, title in _CODE_DEFS
}


def code(name: str) -> FindingCode:
    """Look up a code by its ``VSC###`` name (KeyError on unknown — codes
    are a closed vocabulary; adding one is a doc-visible event)."""
    return CODES[name]


@dataclasses.dataclass
class Finding:
    """One diagnostic instance.

    ``where`` is op provenance — a jaxpr equation summary, a ``file:line``,
    or a stage/boundary label, whichever the emitting engine has.
    ``mesh_dim`` names the mesh axis involved (when one axis is at fault).
    ``bytes_est`` / ``cost_us`` price the implied data movement using the
    per-collective cost functions in ``collectives.py``.
    """

    code: FindingCode
    message: str
    where: Optional[str] = None
    mesh_dim: Optional[str] = None
    bytes_est: Optional[int] = None
    cost_us: Optional[float] = None
    severity: Optional[Severity] = None  # override; defaults to code severity

    def __post_init__(self):
        if isinstance(self.code, str):
            self.code = CODES[self.code]
        if self.severity is None:
            self.severity = self.code.severity

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "code": self.code.code,
            "severity": str(self.severity),
            "title": self.code.title,
            "message": self.message,
        }
        for k in ("where", "mesh_dim", "bytes_est", "cost_us"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    def format(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        dim = f" (mesh dim {self.mesh_dim!r})" if self.mesh_dim else ""
        size = ""
        if self.bytes_est is not None:
            size = f" ~{self.bytes_est / 2**20:.2f} MiB"
            if self.cost_us is not None:
                size += f" / ~{self.cost_us:.0f}us"
        return f"{self.code.code} {self.severity}: {self.message}{dim}{size}{loc}"


@dataclasses.dataclass
class FindingReport:
    """A named batch of findings with severity roll-ups (the unit the CLI
    prints, the step report embeds, and strict mode gates on)."""

    name: str
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def add(self, *findings: Finding) -> "FindingReport":
        self.findings.extend(findings)
        return self

    def extend(self, findings) -> "FindingReport":
        self.findings.extend(findings)
        return self

    def by_code(self, c) -> List[Finding]:
        want = c.code if isinstance(c, FindingCode) else c
        return [f for f in self.findings if f.code.code == want]

    def codes(self) -> List[str]:
        return sorted({f.code.code for f in self.findings})

    @property
    def max_severity(self) -> Optional[Severity]:
        return max((f.severity for f in self.findings), default=None)

    def count(self, at_least: Severity = Severity.INFO) -> int:
        return sum(1 for f in self.findings if f.severity >= at_least)

    def ok(self, strict: bool = False) -> bool:
        """Gate: non-strict passes unless an ERROR finding exists; strict
        also fails on WARNING (INFO findings never fail a run)."""
        threshold = Severity.WARNING if strict else Severity.ERROR
        return self.count(threshold) == 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "n_findings": len(self.findings),
            "max_severity": str(self.max_severity) if self.findings else None,
            "codes": self.codes(),
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def format(self) -> str:
        if not self.findings:
            return f"{self.name}: clean (0 findings)"
        lines = [f"{self.name}: {len(self.findings)} finding(s)"]
        for f in sorted(self.findings, key=lambda f: (-int(f.severity), f.code.code)):
            lines.append("  " + f.format())
        return "\n".join(lines)
