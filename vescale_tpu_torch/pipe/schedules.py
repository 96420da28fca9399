"""Pipeline schedules — instruction IR + generators.

The port of ``vescale_tpu/pipe/schedules.py``: the generators, the
simulator and the cost-driven zero bubble are framework-free and copied as
they are, so every schedule equals the reference's instruction lists
(``tests/test_torch_pipeline.py``).  Only ``estimate_stage_costs`` differs:
it counts each group's FLOPs over the aten ops it dispatches
(``graph_split.OpRecorder``: matmuls exact, each kernel's custom op by its
wrapper's ``cost``, every other op its output elements), where the
reference counts a jaxpr's equations by the same rules.

The legacy instruction VM (legacy/vescale/pipe/_schedules/) maps as:
  - instruction base/registry      <- instruction_base.py:58
  - 1F1B (pipedream flush)         <- pipedream_flush.py:653,762
  - GPipe                          <- pipedream_flush.py (forward_backward_no_pipelining variants)
  - Interleaved 1F1B (VPP)         <- looping_bfs.py:699,873
  - Zero-bubble (split B into dgrad/wgrad)  <- zero_bubble_v.py:132,198,602

The IR is deliberately tiny: SEND/RECV pairs are implicit in the
single-controller engine (activations flow through a table; on hardware the
transfer is an XLA transfer/ppermute — see spmd.py for the compiled path),
so instructions carry only compute semantics + ordering.  Zero-bubble's
W/B split is first-class: B (dgrad) propagates the activation gradient,
W (wgrad) accumulates the weight gradient later, filling bubbles.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import List, Optional, Sequence, Tuple, Union

from ..plan import PipelineParallelPlan, PipelineScheduleType

__all__ = [
    "InstructionKind",
    "Instruction",
    "StageCosts",
    "gpipe_schedule",
    "one_f_one_b_schedule",
    "interleaved_1f1b_schedule",
    "zero_bubble_schedule",
    "zero_bubble_cost_schedule",
    "simulate_schedule",
    "estimate_stage_costs",
    "build_schedule",
]


class InstructionKind(enum.Enum):
    FORWARD = "F"
    BACKWARD = "B"        # full backward (dgrad + wgrad fused)
    BACKWARD_DGRAD = "Bd"  # zero-bubble: input grad only
    BACKWARD_WGRAD = "W"   # zero-bubble: weight grad accumulation


@dataclasses.dataclass(frozen=True)
class Instruction:
    kind: InstructionKind
    stage: int          # physical pipeline stage
    microbatch: int
    chunk: int = 0      # virtual/model chunk (interleaved schedules)

    def __repr__(self):
        c = f"c{self.chunk}" if self.chunk else ""
        return f"{self.kind.value}{c}(s{self.stage},m{self.microbatch})"


def gpipe_schedule(num_stages: int, num_microbatches: int) -> List[List[Instruction]]:
    """All forwards, then all backwards (reference GPIPE mode)."""
    out = []
    for s in range(num_stages):
        ins = [Instruction(InstructionKind.FORWARD, s, m) for m in range(num_microbatches)]
        ins += [
            Instruction(InstructionKind.BACKWARD, s, m)
            for m in reversed(range(num_microbatches))
        ]
        out.append(ins)
    return out


def one_f_one_b_schedule(num_stages: int, num_microbatches: int) -> List[List[Instruction]]:
    """PipeDream-flush 1F1B (reference pipedream_flush.py:762): per stage,
    ``num_stages - s - 1`` warmup forwards, then 1F1B steady state, then
    cooldown backwards."""
    F, B = InstructionKind.FORWARD, InstructionKind.BACKWARD
    out = []
    for s in range(num_stages):
        warmup = min(num_stages - s - 1, num_microbatches)
        remaining = num_microbatches - warmup
        ins = [Instruction(F, s, m) for m in range(warmup)]
        fwd_m, bwd_m = warmup, 0
        for _ in range(remaining):
            ins.append(Instruction(F, s, fwd_m))
            fwd_m += 1
            ins.append(Instruction(B, s, bwd_m))
            bwd_m += 1
        while bwd_m < num_microbatches:
            ins.append(Instruction(B, s, bwd_m))
            bwd_m += 1
        out.append(ins)
    return out


def interleaved_1f1b_schedule(
    num_stages: int, num_microbatches: int, virtual_chunks: int
) -> List[List[Instruction]]:
    """Interleaved 1F1B / VPP (reference looping_bfs.py:873).  Each physical
    stage hosts ``virtual_chunks`` model chunks; microbatches cycle chunks in
    groups of ``num_stages`` (Megatron ordering).

    The generated order is dependency-consistent for the eager engine; exact
    bubble timing is the compiled path's concern.

    Requires ``num_microbatches % num_stages == 0`` (Megatron's own
    constraint): a partial tail wave makes the wave-cycled order
    dependency-INFEASIBLE — stage 0 would issue the tail microbatch's next
    chunk before its previous chunk cleared the pipeline, deadlocking the
    engine.  (The compiled ``pipe.spmd.pipeline_blocks`` path decodes slots
    per step and has no such restriction.)"""
    F, B = InstructionKind.FORWARD, InstructionKind.BACKWARD
    M, S, V = num_microbatches, num_stages, virtual_chunks
    if virtual_chunks > 1 and M % S != 0:
        raise ValueError(
            f"interleaved 1F1B needs num_microbatches ({M}) divisible by "
            f"num_stages ({S}) — a partial tail wave deadlocks the schedule "
            "(Megatron imposes the same constraint)"
        )
    out = []
    total = M * V
    for s in range(S):
        # forward order: chunks in waves of min(S, M) microbatches
        fwd_order = []
        group = min(S, M)
        m0 = 0
        while len(fwd_order) < total:
            for v in range(V):
                for m in range(m0, min(m0 + group, M)):
                    fwd_order.append((m, v))
            m0 += group
        bwd_order = []
        m0 = 0
        while len(bwd_order) < total:
            for v in reversed(range(V)):
                for m in range(m0, min(m0 + group, M)):
                    bwd_order.append((m, v))
            m0 += group
        warmup = min((S - s - 1) * 2 + (V - 1) * S, total)
        ins = [Instruction(F, s, m, v) for m, v in fwd_order[:warmup]]
        fi, bi = warmup, 0
        while fi < total or bi < total:
            if fi < total:
                m, v = fwd_order[fi]
                ins.append(Instruction(F, s, m, v))
                fi += 1
            if bi < total:
                m, v = bwd_order[bi]
                ins.append(Instruction(B, s, m, v))
                bi += 1
        out.append(ins)
    return out


def zero_bubble_schedule(num_stages: int, num_microbatches: int) -> List[List[Instruction]]:
    """Zero-bubble (ZB-H1-style, reference zero_bubble_v.py): 1F1B skeleton
    with backward split into Bd (dgrad, on the critical path) and W (wgrad,
    deferred to fill bubbles / drained at the end)."""
    F, Bd, W = InstructionKind.FORWARD, InstructionKind.BACKWARD_DGRAD, InstructionKind.BACKWARD_WGRAD
    out = []
    for s in range(num_stages):
        warmup = min(num_stages - s - 1, num_microbatches)
        remaining = num_microbatches - warmup
        ins = [Instruction(F, s, m) for m in range(warmup)]
        fwd_m, bwd_m, w_m = warmup, 0, 0
        for _ in range(remaining):
            ins.append(Instruction(F, s, fwd_m))
            fwd_m += 1
            ins.append(Instruction(Bd, s, bwd_m))
            bwd_m += 1
            # defer W by num_stages-s-1 microbatches to fill the bubble
            if bwd_m - w_m > max(0, num_stages - s - 1):
                ins.append(Instruction(W, s, w_m))
                w_m += 1
        while bwd_m < num_microbatches:
            ins.append(Instruction(Bd, s, bwd_m))
            bwd_m += 1
            if w_m < bwd_m - 1:
                ins.append(Instruction(W, s, w_m))
                w_m += 1
        while w_m < num_microbatches:
            ins.append(Instruction(W, s, w_m))
            w_m += 1
        out.append(ins)
    return out


# --------------------------------------------------- cost-graph scheduling
@dataclasses.dataclass(frozen=True)
class StageCosts:
    """Per-stage instruction costs driving cost-aware schedule generation —
    the role of the reference's profiled CostGraph (zero_bubble_v.py:198:
    per-ScheduledNode F/B/W durations + comm edges).

    ``f``/``bd``/``w``: cost of one FORWARD / BACKWARD_DGRAD /
    BACKWARD_WGRAD per stage (len ``num_stages``); a fused BACKWARD costs
    ``bd + w``.  ``comm``: activation/cotangent hop cost between adjacent
    stages (the reference's p2p edge weight; on TPU an ICI transfer)."""

    f: Tuple[float, ...]
    bd: Tuple[float, ...]
    w: Tuple[float, ...]
    comm: float = 0.0

    def __post_init__(self):
        # frozen dataclass doubles as the schedule-cache key: coerce
        # sequence fields so list-built instances stay hashable, and comm
        # so np scalars hash/compare like the equal python float
        for name in ("f", "bd", "w"):
            object.__setattr__(self, name, tuple(float(x) for x in getattr(self, name)))
        object.__setattr__(self, "comm", float(self.comm))

    @staticmethod
    def uniform(num_stages: int, f: float = 1.0, bd: float = 1.0,
                w: float = 1.0, comm: float = 0.0) -> "StageCosts":
        return StageCosts((f,) * num_stages, (bd,) * num_stages, (w,) * num_stages, comm)

    @staticmethod
    def from_weights(weights: Sequence[float], comm: float = 0.0) -> "StageCosts":
        """Costs proportional to per-stage work (e.g. param or FLOP counts):
        dgrad and wgrad each cost about one forward (2 matmuls vs 1 per
        linear map — the standard 1:1:1 F:Bd:W ratio the ZB paper assumes)."""
        t = tuple(float(x) for x in weights)
        return StageCosts(t, t, t, comm)

    def of(self, ins: Instruction) -> float:
        k = ins.kind
        if k == InstructionKind.FORWARD:
            return self.f[ins.stage]
        if k == InstructionKind.BACKWARD:
            return self.bd[ins.stage] + self.w[ins.stage]
        if k == InstructionKind.BACKWARD_DGRAD:
            return self.bd[ins.stage]
        return self.w[ins.stage]


def _dep_key(ins: Instruction):
    return (ins.kind, ins.stage, ins.microbatch, ins.chunk)


def _deps(ins: Instruction, num_stages: int, num_chunks: int = 1) -> List[Tuple]:
    """Predecessor completion events of ``ins`` — the edges of the reference
    CostGraph (zero_bubble_v.py:198), generalized to V virtual chunks: chunk
    ``v`` of stage ``s`` is virtual stage ``v*S + s`` (Megatron VPP order,
    matching PipeModule.group_index).  Forward flows up the virtual-stage
    chain (wrapping S-1 -> 0 into the next chunk); the cotangent flows back
    down it."""
    F, B = InstructionKind.FORWARD, InstructionKind.BACKWARD
    Bd, W = InstructionKind.BACKWARD_DGRAD, InstructionKind.BACKWARD_WGRAD
    s, m, v = ins.stage, ins.microbatch, ins.chunk
    if ins.kind == F:
        if s > 0:
            return [(F, s - 1, m, v)]
        if v > 0:
            return [(F, num_stages - 1, m, v - 1)]  # chunk wrap-around hop
        return []
    if ins.kind in (B, Bd):
        deps: List[Tuple] = [(F, s, m, v)]
        if s < num_stages - 1:
            # the downstream virtual stage produces our cotangent with its
            # dgrad (or fused backward — whichever its schedule uses)
            deps.append(("cot", s + 1, m, v))
        elif v < num_chunks - 1:
            deps.append(("cot", 0, m, v + 1))  # wrap: next chunk, stage 0
        return deps
    if ins.kind == W:
        return [(Bd, s, m, v)]
    return []


def _ready_time(
    ins: Instruction, done: dict, num_stages: int, costs: StageCosts, num_chunks: int = 1
) -> Optional[float]:
    """Earliest start of ``ins`` given completion times ``done`` — the ONE
    encoding of the dependency/hop rules, shared by the simulator and the
    greedy generator so their cost models can never drift apart.  None if a
    predecessor hasn't completed."""
    t = 0.0
    for dep in _deps(ins, num_stages, num_chunks):
        if dep[0] == "cot":
            _, ds, dm, dv = dep
            key = (InstructionKind.BACKWARD_DGRAD, ds, dm, dv)
            if key not in done:
                key = (InstructionKind.BACKWARD, ds, dm, dv)
            if key not in done:
                return None
            t = max(t, done[key] + costs.comm)
        else:
            if dep not in done:
                return None
            hop = costs.comm if dep[0] == InstructionKind.FORWARD and dep[1] != ins.stage else 0.0
            t = max(t, done[dep] + hop)
    return t


def _num_chunks_of(schedule: List[List[Instruction]]) -> int:
    return 1 + max((i.chunk for stage_ins in schedule for i in stage_ins), default=0)


def simulate_schedule(
    schedule: List[List[Instruction]],
    costs: StageCosts,
) -> float:
    """Event-driven makespan of a per-stage instruction schedule under the
    cost model: stages execute their lists in order (each stage is a serial
    resource), cross-stage edges add ``costs.comm``; virtual chunks follow
    the VPP virtual-stage chain (chunk costs = hosting stage's costs).
    Returns the time the last instruction completes."""
    S = len(schedule)
    if len(costs.f) != S or len(costs.bd) != S or len(costs.w) != S:
        raise ValueError(
            f"StageCosts for {len(costs.f)} stages used with a {S}-stage schedule"
        )
    done: dict = {}
    V = _num_chunks_of(schedule)

    def ready_at(ins: Instruction) -> Optional[float]:
        return _ready_time(ins, done, S, costs, V)

    stage_time = [0.0] * S
    pos = [0] * S
    makespan = 0.0
    while any(p < len(q) for p, q in zip(pos, schedule)):
        progressed = False
        for s in range(S):
            while pos[s] < len(schedule[s]):
                ins = schedule[s][pos[s]]
                t = ready_at(ins)
                if t is None:
                    break
                start = max(stage_time[s], t)
                end = start + costs.of(ins)
                done[_dep_key(ins)] = end
                stage_time[s] = end
                makespan = max(makespan, end)
                pos[s] += 1
                progressed = True
        if not progressed:
            stuck = [q[p] for p, q in zip(pos, schedule) if p < len(q)]
            raise RuntimeError(f"schedule deadlock in simulation; waiting on {stuck[:8]}")
    return makespan


def _zb_greedy_schedule(
    num_stages: int,
    num_microbatches: int,
    costs: StageCosts,
    virtual_chunks: int = 1,
    max_inflight: Optional[int] = None,
) -> List[List[Instruction]]:
    """Global-clock greedy over the ZB dependency graph: repeatedly start the
    schedulable instruction with the earliest feasible start time, preferring
    dgrad > forward > wgrad on ties — W work naturally slots into gaps whose
    length the cost model exposes (the reference generator's rollout,
    zero_bubble_v.py:602).  With ``virtual_chunks`` > 1 each stage's F/Bd/W
    streams exist per chunk and dependencies follow the VPP virtual-stage
    chain (the reference CostGraph's virtual chunks, zero_bubble_v.py:198).

    Memory bound: the engine pins each forward's linearization residuals
    until BACKWARD_WGRAD pops them (engine.py wgrad_stash), so stage ``s``
    may hold at most ``(V-1)*S + 2*(S-s) - 1`` forwards whose WGRAD hasn't
    run — the effective residual depth of the fixed-defer ZB-H1 heuristic
    (its in-flight F-Bd depth ``S-s`` plus its W deferral ``S-s-1``),
    extended by the VPP warmup term.  This MATCHES the heuristic candidate's
    own peak (both candidates honor the same contract); note it is ~2x the
    1F1B in-flight depth ``S-s`` — pass ``max_inflight`` to pin a tighter
    per-stage cap when HBM is the binding constraint (V=1 only; a cap below
    the VPP warmup depth deadlocks V>1).  A looser cap trades O(M) memory
    for makespan the way the reference's memory-limited CostGraph
    deliberately does not."""
    S, M, V = num_stages, num_microbatches, virtual_chunks
    F, Bd, W = InstructionKind.FORWARD, InstructionKind.BACKWARD_DGRAD, InstructionKind.BACKWARD_WGRAD
    prio = {Bd: 0, F: 1, W: 2}
    done: dict = {}
    stage_time = [0.0] * S
    schedule: List[List[Instruction]] = [[] for _ in range(S)]
    bptr = [[0] * V for _ in range(S)]
    wptr = [[0] * V for _ in range(S)]
    cap = [max(1, (V - 1) * S + 2 * (S - s) - 1) for s in range(S)]
    if max_inflight is not None:
        if V > 1:
            raise ValueError("max_inflight caps are V=1 only (VPP warmup needs the default)")
        cap = [max(1, min(c, max_inflight)) for c in cap]

    # Forwards issue in the canonical Megatron wave order (chunks cycle in
    # groups of min(S, M) microbatches — the same order the interleaved
    # generator uses).  A free F order lets the rollout burn a stage's whole
    # residual cap on chunk-0 forwards while every backward transitively
    # waits on the LAST chunk's forward (no W can free the cap) — deadlock.
    # Pinning the F order keeps the rollout deadlock-free; the cost model
    # still owns the placement of every Bd and W.
    group = min(S, M)
    fwd_order: List[Tuple[int, int]] = []
    m0 = 0
    while len(fwd_order) < M * V:
        for v in range(V):
            for m in range(m0, min(m0 + group, M)):
                fwd_order.append((m, v))
        m0 += group
    fnext = [0] * S
    fcount = [0] * S

    def candidates(s):
        out = []
        nxt = []
        live = fcount[s] - sum(wptr[s])
        if fnext[s] < M * V and live < cap[s]:
            m, v = fwd_order[fnext[s]]
            nxt.append(Instruction(F, s, m, v))
        for v in range(V):
            if bptr[s][v] < M:
                nxt.append(Instruction(Bd, s, bptr[s][v], v))
            if wptr[s][v] < bptr[s][v]:  # wgrad ready once its dgrad has run
                nxt.append(Instruction(W, s, wptr[s][v], v))
        for ins in nxt:
            rdy = _ready_time(ins, done, S, costs, V)
            if rdy is not None:
                out.append((ins, rdy))
        return out

    total = 3 * M * S * V
    scheduled = 0
    while scheduled < total:
        best = None
        for s in range(S):
            for ins, rdy in candidates(s):
                start = max(stage_time[s], rdy)
                # chunk in the tie-break keeps the rollout deterministic
                key = (start, prio[ins.kind], s, ins.chunk)
                if best is None or key < best[0]:
                    best = (key, ins, start)
        if best is None:
            raise RuntimeError("zb greedy scheduler stalled (dependency bug)")
        _, ins, start = best
        s = ins.stage
        end = start + costs.of(ins)
        done[_dep_key(ins)] = end
        stage_time[s] = end
        schedule[s].append(ins)
        if ins.kind == F:
            fnext[s] += 1
            fcount[s] += 1
        elif ins.kind == Bd:
            bptr[s][ins.chunk] += 1
        else:
            wptr[s][ins.chunk] += 1
        scheduled += 1
    return schedule


@functools.lru_cache(maxsize=256)
def _zb_cost_schedule_cached(
    num_stages: int,
    num_microbatches: int,
    costs: StageCosts,
    virtual_chunks: int = 1,
    max_inflight: Optional[int] = None,
):
    cands = [
        _zb_greedy_schedule(num_stages, num_microbatches, costs, virtual_chunks, max_inflight)
    ]
    if max_inflight is None:
        # the fixed heuristics don't honor a tightened residual cap — only
        # the capped greedy is a candidate when one is requested
        if virtual_chunks > 1:
            if num_microbatches % num_stages == 0:
                # interleaved 1F1B (fused B) is the V>1 heuristic baseline;
                # with a partial tail wave its order is infeasible (see
                # interleaved_1f1b_schedule) — the greedy alone covers that
                cands.append(
                    interleaved_1f1b_schedule(num_stages, num_microbatches, virtual_chunks)
                )
        else:
            cands.append(zero_bubble_schedule(num_stages, num_microbatches))
    # prediction recording lives in the public wrapper (this fn is
    # lru-cached: recording here would skip cache hits)
    # the schedule with the least makespan
    return min(cands, key=lambda sch: simulate_schedule(sch, costs))  # vescale-lint: disable=VSC208


def zero_bubble_cost_schedule(
    num_stages: int,
    num_microbatches: int,
    costs: Union[StageCosts, Sequence[float], None] = None,
    virtual_chunks: int = 1,
    max_inflight: Optional[int] = None,
) -> List[List[Instruction]]:
    """Cost-aware zero-bubble schedule (reference CostGraph generator,
    zero_bubble_v.py:198,602): generate candidate schedules — a fixed
    heuristic (ZB-H1 defer for V=1, interleaved 1F1B for V>1) and a
    cost-model greedy rollout — simulate each under the cost model, and
    return the one with the smallest makespan.

    ``costs``: a ``StageCosts``, a per-stage weight sequence (param/FLOP
    counts — 1:1:1 F:Bd:W assumed), or None (uniform).  ``max_inflight``
    (V=1 only) pins a per-stage residual cap below the default ZB-H1 depth
    for HBM-bound configs (greedy-only: the fixed heuristics don't honor
    it).  Results are memoized per (S, M, costs, V, cap): a training loop
    re-building its schedule every step pays the Python rollout once."""
    if costs is None:
        costs = StageCosts.uniform(num_stages)
    elif not isinstance(costs, StageCosts):
        costs = StageCosts.from_weights(costs)
    if len(costs.f) != num_stages or len(costs.bd) != num_stages or len(costs.w) != num_stages:
        raise ValueError(
            f"schedule_costs has {len(costs.f)} stages, plan has {num_stages}"
        )
    cached = _zb_cost_schedule_cached(
        num_stages, num_microbatches, costs, virtual_chunks, max_inflight
    )
    from ..telemetry import costaudit as _ca

    if _ca.is_active():
        # ledger the chosen schedule's simulated makespan — units follow
        # the StageCosts the caller priced in (µs when they came from a
        # calibrated estimate_stage_costs, abstract cost units otherwise,
        # which the auditor counts but never computes divergence over)
        from ..telemetry import calibrate as _cal

        digest = _cal.active_digest()
        _ca.record_prediction(
            "pipe_schedule",
            predicted_us=simulate_schedule(cached, costs) if digest is not None else None,
            digest=digest,
            unit="us" if digest is not None else "cost",
            detail={"stages": num_stages, "microbatches": num_microbatches,
                    "virtual_chunks": virtual_chunks},
        )
    return [list(stage) for stage in cached]  # callers may mutate their copy


def estimate_stage_costs(
    pipe_module, params_per_group, x_example, comm: Optional[float] = 0.0
) -> StageCosts:
    """Per-stage costs from the FLOP model — the profiling role of the
    reference's CostGraph (zero_bubble_v.py:198): run each group's forward
    once on ``x_example`` (a real stage-0 input, e.g. one microbatch)
    without autograd under ``graph_split.OpRecorder`` — the aten-op rules of
    the reference's jaxpr count: matmuls exact, a kernel's custom op by its
    wrapper's ``cost`` (as ``telemetry.costaudit`` counts it), every other
    op its output elements — and assume the standard 1:1:1 F:Bd:W ratio.  Requires one group per
    stage (V=1, the cost schedule's domain).

    ``comm=None`` asks for MEASURED units: with a calibration table armed
    (``VESCALE_COST_CALIBRATION``, telemetry/calibrate.py) carrying a
    ``matmul_gflops`` throughput sample, stage FLOPs convert to
    microseconds and ``comm`` becomes the table's ppermute time for the
    boundary activation's byte size; a table without a ppermute bucket
    prices the hop by ``collectives.analytic_cost_us`` (the ring formula
    over the card's NVLink rate).  Without a usable table,
    ``comm=None`` is ``comm=0.0`` in FLOP units, as in the reference."""
    import torch

    from .graph_split import OpRecorder

    weights, x = [], x_example
    act_bytes = None
    for g in range(pipe_module.num_groups):
        fwd = pipe_module.group_forward(g)
        with torch.no_grad(), OpRecorder() as count:
            x = fwd(params_per_group[g], x)
        weights.append(count.flops)
        if g == 0:  # the stage-boundary activation every p2p hop moves
            act_bytes = sum(t.numel() * t.element_size() for t in _tensor_leaves(x))
    if comm is None:
        from ..telemetry import calibrate as _cal

        # table_for, not active_table: the platform staleness check gates
        # the matmul_gflops conversion too
        table = _cal.table_for(None)
        gflops = (table.meta.get("matmul_gflops") if table is not None else None)
        if table is not None and gflops:
            us_per_flop = 1.0 / (float(gflops) * 1e3)  # GFLOP/s -> us/FLOP
            n = max(2, pipe_module.num_groups)
            comm_us = _cal.table_cost_us(table, "ppermute", n, act_bytes or 0)
            if comm_us is None:
                from .. import collectives as C

                comm_us = C.analytic_cost_us("ppermute", (act_bytes or 0) / 1e9, n)
            sc = StageCosts.from_weights(
                [w * us_per_flop for w in weights], comm=comm_us
            )
            from ..telemetry import costaudit as _ca

            # us-denominated stage costs are a priced plan: ledger the total
            _ca.record_prediction(
                "pipe_stage_costs",
                predicted_us=sum(sc.f) + sum(sc.bd) + sum(sc.w),
                digest=table.digest(), unit="us",
                detail={"stages": len(sc.f), "comm_us": comm_us},
            )
            return sc
        comm = 0.0  # no usable table: FLOP units
    return StageCosts.from_weights(weights, comm=comm)


def _tensor_leaves(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensor_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensor_leaves(v)]
    return []


def build_schedule(
    plan: PipelineParallelPlan,
    num_microbatches: int,
    costs: Optional[StageCosts] = None,
) -> List[List[Instruction]]:
    """Reference ScheduleEngine/PipelineEmitter dispatch (pipe_emmiter.py:132).
    ``costs`` (or ``plan.schedule_costs``) routes ZERO_BUBBLE through the
    cost-graph generator."""
    st = plan.schedule_type
    if st == PipelineScheduleType.GPIPE:
        return gpipe_schedule(plan.num_stages, num_microbatches)
    if st == PipelineScheduleType.SIMPLE_1F1B:
        return one_f_one_b_schedule(plan.num_stages, num_microbatches)
    if st == PipelineScheduleType.INTERLEAVED_1F1B:
        return interleaved_1f1b_schedule(plan.num_stages, num_microbatches, plan.virtual_chunks)
    if st == PipelineScheduleType.ZERO_BUBBLE:
        costs = costs if costs is not None else plan.schedule_costs
        V = max(1, plan.virtual_chunks or 1)
        if costs is not None or V > 1:
            # V>1 always routes through the cost generator (uniform costs if
            # none given) — the fixed-defer heuristic is V=1-only
            return zero_bubble_cost_schedule(plan.num_stages, num_microbatches, costs, V)
        return zero_bubble_schedule(plan.num_stages, num_microbatches)
    raise NotImplementedError(f"schedule {st}")
