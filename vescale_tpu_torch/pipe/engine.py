"""PipeEngine — executes pipeline schedules.

The port of ``vescale_tpu/pipe/engine.py`` (legacy veScale's PipeEngine
and ScheduleEngine, engine/pipe.py:33, pipe/pipe_emmiter.py:43,132):
minibatch -> microbatches, instruction execution, the loss averaged over
the last group's microbatches, the shared-parameter grad sync and the
zero-bubble B/W split.

This is the *eager* (schedule-exact) engine: single-controller, each
instruction runs as torch ops on this process, activations and cotangents
flow through tables.  The compiled pipeline over a ``pp`` mesh is
``spmd.py``.

Backward: FORWARD runs the group on leaves that share the parameters'
storage (``detach().requires_grad_()``) and keeps its autograd graph.  A
fused BACKWARD asks ``torch.autograd.grad`` for the parameters and the
input together.  For zero-bubble schedules the backward is split for real
(reference zero_bubble_v.py:132 ScheduledNode B/W):

  * BACKWARD_DGRAD asks ``torch.autograd.grad(..., inputs=[x],
    retain_graph=True)`` alone.  Autograd runs only the nodes on a path to
    ``x`` and computes only the outputs those paths need, so the
    weight-gradient matmuls do not run (``graph_split.OpRecorder`` counts
    them: ``tests/test_torch_pipeline.py``).
  * BACKWARD_WGRAD later asks for the parameters only (a ``PendingWgrad``:
    the retained graph and the output cotangent).  Like the reference's
    ``linear_transpose`` of the shared linearization, it walks the graph
    again from the output, so the group's internal cotangents (the
    attention backward among them) run a second time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..plan import PipelineParallelPlan
from ..telemetry import memtrack as _memtrack
from .pipe_stage import PipeModule, activation_leaves as _leaves, rebuild as _rebuild, tree_add
from .schedules import Instruction, InstructionKind, build_schedule

__all__ = ["PipeEngine", "PendingWgrad"]


def _as_input(x):
    """A stage input that autograd can differentiate: each float tensor a
    new leaf over the same storage; integer tensors (tokens) as they are."""
    return _rebuild(x, [t.detach().requires_grad_(True) if t.is_floating_point() else t
                        for t in _leaves(x)])


def _tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    return [tree]


def _tree_build(tree, leaves: List[Any]):
    """``leaves`` in the nesting of ``tree``."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        return next(it)

    return go(tree)


def _grads(outputs, dys, inputs: List[torch.Tensor], retain: bool) -> List[torch.Tensor]:
    """d(outputs)/d(inputs) with cotangents ``dys``; zeros for an input the
    outputs do not reach (the reference's vjp gives zeros too)."""
    pairs = [(o, d) for o, d in zip(outputs, dys) if o.requires_grad and d is not None]
    if not inputs:
        return []
    return list(torch.autograd.grad([o for o, _ in pairs], inputs, [d for _, d in pairs],
                                    retain_graph=retain, allow_unused=True,
                                    materialize_grads=True))


@dataclasses.dataclass
class PendingWgrad:
    """A deferred weight grad: everything needed to compute dparams later.

    Holding the retained graph (``outputs``) and ``dy`` rather than a
    computed dparams is the observable difference from a fake split: the
    weight-grad matmuls run when BACKWARD_WGRAD executes, not at dgrad
    time."""

    outputs: List[torch.Tensor]   # the group's output leaves, graph retained
    dy: List[Any]                 # their cotangents
    structure: Any                # the group's parameter tree (its nesting)
    params: List[torch.Tensor]    # the parameter leaves of the forward

    def compute(self):
        return _tree_build(self.structure, _grads(self.outputs, self.dy, self.params,
                                                  retain=False))


class PipeEngine:
    """Schedule-exact EAGER pipeline executor — the semantics and
    profiling engine.

    Single-controller by construction: activations and cotangents flow
    through Python tables on this process, so it cannot scale over ranks.
    Run multi-rank training through the compiled pipeline
    (``pipe/spmd.py`` ``pipeline_blocks`` / ``pipeline_blocks_zb``).  Use
    this engine for schedule studies, instruction-level parity, and
    ``profile_costs`` feeding the cost-graph scheduler.  A live
    ``torch.distributed`` world of more than one rank refuses to start
    (see ``forward_backward``)."""

    def __init__(
        self,
        module: PipeModule,
        plan: PipelineParallelPlan,
        loss_fn: Callable,
        device_mesh=None,
    ):
        self.module = module
        self.plan = plan
        self.loss_fn = loss_fn  # loss_fn(last_stage_output, target_microbatch)
        self.mesh = device_mesh
        # optional (instruction, seconds) callback; when set, the card is
        # synchronized around each instruction so the wall time is the
        # instruction's own (profiling mode — see profile_costs)
        self.on_instruction: Optional[Callable] = None
        # optional instruction -> context manager entered around each
        # instruction's run (e.g. a graph_split.OpRecorder for the dgrads)
        self.instruction_context: Optional[Callable] = None

    # ----------------------------------------------------------- helpers
    def _split_microbatches(self, batch, num_microbatches: int):
        out = [dict() for _ in range(num_microbatches)]
        for k, x in batch.items():
            if x.shape[0] % num_microbatches != 0:
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by {num_microbatches} microbatches"
                )
            for m, piece in enumerate(torch.split(x, x.shape[0] // num_microbatches, dim=0)):
                out[m][k] = piece
        return out

    def _check_stage_boundaries(self, micro) -> None:
        """Audit the plan's declared cross-stage layouts once, before the
        first microbatch runs, through ``PipelineParallelPlan.boundary_report``
        (``analysis/shardcheck``), the report routed by
        ``VESCALE_SHARDCHECK`` (warn or raise); the p2p shape is the plan's
        ``p2p_tensor_shapes`` when declared, else the first microbatch
        leaf's.  With none declared, or no mesh, it does nothing."""
        if getattr(self, "_boundaries_checked", False):
            return
        self._boundaries_checked = True
        if self.mesh is None or getattr(self.plan, "stage_out_placements", None) is None:
            return
        from .. import analysis

        if not analysis.enabled():
            return
        shapes = self.plan.p2p_tensor_shapes
        if shapes:
            shape = shapes[0] if isinstance(shapes[0], (tuple, list)) else shapes
        else:
            leaves = _leaves(micro[0]) if micro else []
            if not leaves:
                return
            shape = leaves[0].shape
        analysis.dispatch_report(self.plan.boundary_report(self.mesh, tuple(shape)),
                                 stacklevel=4)

    # ------------------------------------------------------------- main
    def forward_backward(
        self,
        params_per_group: List[Dict[str, Any]],
        minibatch: Dict[str, Any],
        num_microbatches: Optional[int] = None,
        forward_only: bool = False,
    ):
        """Run the configured schedule over the minibatch.

        Returns (mean_loss, grads_per_group) — grads aligned with
        ``params_per_group`` and shared-group grads already synced
        (reference engine/pipe.py:138 forward_backward).  In
        ``forward_only`` mode returns (mean_loss_or_None,
        last_stage_outputs) and 'target' may be omitted from the
        minibatch."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise RuntimeError(
                "PipeEngine is the single-controller EAGER semantics engine "
                "(activations flow through Python tables on this process); "
                "a multi-process run would silently not scale.  Use the "
                "compiled pipeline — pipe/spmd.py pipeline_blocks / "
                "pipeline_blocks_zb — for multi-rank training."
            )
        M = num_microbatches or 1
        G = self.module.num_groups
        micro = self._split_microbatches(
            {k: v for k, v in minibatch.items() if k != "target"}, M
        )
        self._check_stage_boundaries(micro)
        has_target = "target" in minibatch
        if not has_target and not forward_only:
            raise ValueError("training forward_backward requires a 'target' in the minibatch")
        targets = (
            self._split_microbatches({"target": minibatch["target"]}, M) if has_target else None
        )
        schedule = build_schedule(self.plan, M)
        if forward_only:
            schedule = [
                [i for i in stage_ins if i.kind == InstructionKind.FORWARD]
                for stage_ins in schedule
            ]

        acts: Dict[Tuple[int, int], Any] = {}       # (g, m) -> output, for group g+1
        records: Dict[Tuple[int, int], Any] = {}    # (g, m) -> (outputs, tree, params, x)
        cotangents: Dict[Tuple[int, int], Any] = {}  # (g, m) -> dy for group g
        wgrad_stash: Dict[Tuple[int, int], PendingWgrad] = {}
        losses: Dict[int, Any] = {}
        outputs: Dict[int, Any] = {}  # forward-only: last-group outputs per microbatch
        grads: List[Optional[Dict[str, Any]]] = [None] * G

        def ready(ins: Instruction) -> bool:
            g = self.module.group_index(ins.stage, ins.chunk)
            m = ins.microbatch
            if ins.kind == InstructionKind.FORWARD:
                return g == 0 or (g - 1, m) in acts
            if ins.kind in (InstructionKind.BACKWARD, InstructionKind.BACKWARD_DGRAD):
                if (g, m) not in records:
                    return False
                return g == G - 1 or (g, m) in cotangents
            if ins.kind == InstructionKind.BACKWARD_WGRAD:
                return (g, m) in wgrad_stash
            return False

        def seed_dy(m):
            loss = losses[m]
            return [torch.full((), 1.0 / M, dtype=loss.dtype, device=loss.device)]

        def run(ins: Instruction):
            """Execute one instruction; returns what it produced."""
            g = self.module.group_index(ins.stage, ins.chunk)
            m = ins.microbatch
            if ins.kind == InstructionKind.FORWARD:
                # the producing entry is consumed exactly once: evict so peak
                # memory under 1F1B stays O(stages), not O(stages*microbatches)
                x = micro[m]["input"] if g == 0 else acts.pop((g - 1, m))
                fwd = self.module.group_forward(g)
                if forward_only:
                    with torch.no_grad():
                        y = fwd(params_per_group[g], x)
                        if g == G - 1:
                            outputs[m] = y
                            if targets is not None:
                                losses[m] = self.loss_fn(y, targets[m]["target"])
                    acts[(g, m)] = _memtrack.tag_tree(y, "activation_stash")
                    return y
                names = params_per_group[g]  # the tree's nesting
                leaves = [t.detach().requires_grad_(t.is_floating_point())
                          for t in _tree_leaves(names)]
                x_in = x if g == 0 else _as_input(x)
                with torch.enable_grad():
                    y = fwd(_tree_build(names, leaves), x_in)
                    if g == G - 1:
                        y = self.loss_fn(y, targets[m]["target"])
                records[(g, m)] = (_leaves(y), names, leaves, x_in)
                if g == G - 1:
                    losses[m] = y.detach()
                else:
                    # the stash IS the 1F1B memory cost — owner-tag it so an
                    # OOM census shows how many microbatches were in flight
                    acts[(g, m)] = _memtrack.tag_tree(
                        _rebuild(y, [t.detach() for t in _leaves(y)]), "activation_stash")
                return y
            if ins.kind == InstructionKind.BACKWARD:
                outs, names, leaves, x_in = records.pop((g, m))
                dy = seed_dy(m) if g == G - 1 else _leaves(cotangents.pop((g, m)))
                xs = [t for t in _leaves(x_in) if t.requires_grad] if g > 0 else []
                got = _grads(outs, dy, leaves + xs, retain=False)
                dparams = _tree_build(names, got[:len(leaves)])
                if g > 0:
                    cotangents[(g - 1, m)] = _cotangent(x_in, got[len(leaves):])
                _accumulate(grads, g, dparams)
                return got
            if ins.kind == InstructionKind.BACKWARD_DGRAD:
                outs, names, leaves, x_in = records.pop((g, m))
                dy = seed_dy(m) if g == G - 1 else _leaves(cotangents.pop((g, m)))
                dx = None
                if g > 0:
                    # input-grad only: no parameter is asked for, so autograd
                    # runs no weight-grad matmul
                    xs = [t for t in _leaves(x_in) if t.requires_grad]
                    dx = _grads(outs, dy, xs, retain=True)
                    cotangents[(g - 1, m)] = _cotangent(x_in, dx)
                # deferred-wgrad residual held into the bubble slots — part
                # of the activation stash for attribution purposes
                wgrad_stash[(g, m)] = PendingWgrad(
                    outs, _memtrack.tag_tree(dy, "activation_stash"), names, leaves
                )
                return dx
            if ins.kind == InstructionKind.BACKWARD_WGRAD:
                dp = wgrad_stash.pop((g, m)).compute()
                _accumulate(grads, g, dp)
                return dp
            return None

        # round-robin clock over stages, dependency-driven (the reference's
        # per-rank executors run concurrently; single-controller execution
        # needs only the dependency order)
        from .. import telemetry as _tel
        from ..ndtimeline import predefined as _metrics
        from ..ndtimeline.api import is_active

        _nd_active = is_active()  # snapshot: a dormant profiler costs nothing
        _tel_active = _tel.is_active()  # same gate for the metrics registry
        _t_sched0 = time.perf_counter() if _tel_active else 0.0
        _metric_of = {
            InstructionKind.FORWARD: _metrics.FORWARD_COMPUTE,
            InstructionKind.BACKWARD: _metrics.BACKWARD_COMPUTE,
            InstructionKind.BACKWARD_DGRAD: _metrics.BACKWARD_COMPUTE,
            InstructionKind.BACKWARD_WGRAD: _metrics.WGRAD_COMPUTE,
        }
        timer = self.on_instruction
        queues = [list(s) for s in schedule]
        pos = [0] * len(queues)
        try:
            self._run_schedule(queues, pos, ready, run, timer, _nd_active,
                               _tel_active, _metric_of)
        except BaseException as e:
            # OOM forensics: the stash tables above are exactly what an
            # OOM census needs to attribute — dump before unwinding them
            _memtrack.maybe_dump_oom(e)
            raise

        if _tel_active:
            # un-synchronized instructions are async launches, so the honest
            # whole-schedule signal is the pass duration + instruction count
            _tel.count("pipe_forward_backward_total")
            _tel.count("pipe_instructions_total", sum(len(q) for q in queues))
            _tel.set_gauge("pipe_num_microbatches", M)
            _tel.observe(
                "pipe_forward_backward_seconds", time.perf_counter() - _t_sched0
            )
        mean_loss = sum(losses.values()) / M if losses else None
        if forward_only:
            outs = torch.cat([outputs[m] for m in range(M)], dim=0) if outputs else None
            return mean_loss, outs
        grads = self.module.sync_shared_params_grads([g if g is not None else {} for g in grads])
        return mean_loss, _memtrack.tag_tree(grads, "grads")

    def _run_schedule(self, queues, pos, ready, run, timer, _nd_active,
                      _tel_active, _metric_of):
        """Dependency-driven round-robin clock over the stage queues."""
        from .. import telemetry as _tel
        from ..ndtimeline.api import ndtimeit

        ctx_of = self.instruction_context
        while any(p < len(q) for p, q in zip(pos, queues)):
            progressed = False
            for s, q in enumerate(queues):
                if pos[s] < len(q) and ready(q[pos[s]]):
                    ins = q[pos[s]]
                    # every instruction emits an ndtimeline span tagged
                    # (stage, chunk, microbatch) when the profiler is
                    # initialized.  A host-side region: it brackets the
                    # launches (async) unless profiling mode synchronizes.
                    span = (
                        ndtimeit(
                            _metric_of.get(ins.kind, str(ins.kind)),
                            tags={
                                "stage": ins.stage,
                                "chunk": ins.chunk,
                                "microbatch": ins.microbatch,
                                "dgrad": ins.kind == InstructionKind.BACKWARD_DGRAD,
                                "timing": "host-dispatch" if timer is None else "blocked",
                            },
                        )
                        if _nd_active
                        else contextlib.nullcontext()
                    )
                    extra = ctx_of(ins) if ctx_of is not None else contextlib.nullcontext()
                    if timer is None:
                        with span, extra:
                            run(ins)
                    else:
                        # every profiled instruction is synchronized, so the
                        # card's queue is empty at start: wall == own duration
                        _sync()
                        t0 = time.perf_counter()
                        with span, extra:
                            run(ins)
                            _sync()
                        dt = time.perf_counter() - t0
                        if _tel_active:
                            _tel.observe(
                                f"pipe_instr_{ins.kind.name.lower()}_seconds", dt
                            )
                        timer(ins, dt)
                    pos[s] += 1
                    progressed = True
            if not progressed:
                stuck = [q[p] for p, q in zip(pos, queues) if p < len(q)]
                raise RuntimeError(f"pipeline schedule deadlock; waiting on {stuck[:8]}")

    def forward_only(self, params_per_group, minibatch, num_microbatches=None):
        return self.forward_backward(
            params_per_group, minibatch, num_microbatches, forward_only=True
        )

    def _timed_pass(self, params_per_group, minibatch, num_microbatches, warmup: int):
        """One wall-timed schedule pass (after ``warmup`` untimed passes);
        returns {(kind, stage): [durations]}."""
        times: Dict[Tuple[Any, int], List[float]] = {}

        def cb(ins, dt):
            times.setdefault((ins.kind, ins.stage), []).append(dt)

        old = self.on_instruction
        self.on_instruction = cb
        try:
            for _ in range(warmup):
                self.forward_backward(params_per_group, minibatch, num_microbatches)
            times.clear()  # keep only the post-warmup pass
            self.forward_backward(params_per_group, minibatch, num_microbatches)
        finally:
            self.on_instruction = old
        return times

    def profile_costs(self, params_per_group, minibatch, num_microbatches=None,
                      warmup: int = 1, comm: float = 0.0,
                      calibrate_host_overhead: bool = False):
        """Measured per-stage instruction durations -> ``StageCosts`` (the
        reference CostGraph's *profiled* inputs, zero_bubble_v.py:198).

        Runs ``warmup + 1`` passes of the configured schedule with the card
        synchronized around each instruction; the last pass's median
        duration per (kind, stage) becomes the cost.  Fused BACKWARD
        timings split evenly into bd/w.  V=1 only (cost schedules model
        one chunk per stage).

        ``calibrate_host_overhead``: each eager instruction pays a host
        cost (Python dispatch, table bookkeeping) that is roughly
        size-independent, while the device work scales with the
        microbatch — raw wall times flatten the stage ratios the scheduler
        cares about.  Calibration re-profiles on a sequence-decimated copy
        of the minibatch (8 positions) and subtracts the per-(kind, stage)
        medians.  Costs are clamped at a tenth of the raw measurement so a
        noisy calibration can never zero a stage out."""
        from .schedules import StageCosts

        if self.module.num_groups != self.plan.num_stages:
            raise ValueError("profile_costs needs one group per stage (V=1)")
        S = self.plan.num_stages
        times = self._timed_pass(params_per_group, minibatch, num_microbatches, warmup)

        base: Dict[Tuple[Any, int], List[float]] = {}
        if calibrate_host_overhead:
            tiny = {
                k: (v[:, :8] if v.dim() >= 2 and v.shape[1] > 8 else v)
                for k, v in minibatch.items()
            }
            base = self._timed_pass(params_per_group, tiny, num_microbatches, warmup)

        def med(table, kind, s, default=0.0):
            v = table.get((kind, s))
            return statistics.median(v) if v else default

        def cost(kind, s):
            raw = med(times, kind, s)
            if not calibrate_host_overhead:
                return raw
            return max(raw - med(base, kind, s), raw * 0.1)

        F, B = InstructionKind.FORWARD, InstructionKind.BACKWARD
        Bd, W = InstructionKind.BACKWARD_DGRAD, InstructionKind.BACKWARD_WGRAD
        f = tuple(cost(F, s) for s in range(S))
        if any((Bd, s) in times for s in range(S)):
            bd = tuple(cost(Bd, s) for s in range(S))
            w = tuple(cost(W, s) for s in range(S))
        else:  # fused-backward schedule: split the measurement evenly
            bd = tuple(cost(B, s) / 2.0 for s in range(S))
            w = bd
        return StageCosts(f=f, bd=bd, w=w, comm=comm)

    __call__ = forward_backward


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _cotangent(x_in, dxs: List[torch.Tensor]):
    """The cotangent of a stage input, in its structure (None for integer
    leaves)."""
    it = iter(dxs)
    return _rebuild(x_in, [next(it) if t.requires_grad else None for t in _leaves(x_in)])


def _accumulate(grads: List, g: int, dparams) -> None:
    if grads[g] is None:
        grads[g] = dparams
    else:
        grads[g] = tree_add(grads[g], dparams)
