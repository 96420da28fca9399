"""run_resilient — the auto-recovering train loop.

The port of ``vescale_tpu/resilience/loop.py``, branch for branch: the
layer that composes the fault-tolerance ingredients into a run that
survives: commit-protocol checkpoints (checkpoint/manager.py), sample-exact
loader resume (data/loader.py ``state``/``load_state``), retry/backoff
I/O (resilience/retry.py), preemption handling (resilience/preempt.py),
the optimizer's skip-on-nonfinite signal, and the OOM flight recorder
(telemetry/memtrack.py).  Failure playbook:

  crash / restart        auto-resume from the newest COMMITTED checkpoint:
                         params, optimizer state, RNG stream, loader
                         position, step counter — all one unit.
  corrupt latest ckpt    quarantined (``step_N.corrupt``) and the
                         next-older committed step is tried — a bad disk
                         block costs one checkpoint interval, not the run.
  SIGTERM / SIGINT       stop flag checked at the step boundary: drain
                         in-flight async saves, one emergency SYNCHRONOUS
                         save, clean return (status="preempted").
  capacity change        the faultsim "resize" kind (OR-agreed across
                         ranks in coordinated mode) drains and
                         emergency-saves exactly like a preemption but
                         returns status="resized"; the relaunched run may
                         come back with a DIFFERENT process count/mesh —
                         restore reshards params AND optimizer state from
                         the saved chunks (the writer-mesh block in
                         meta.json routes the shape change to the chunk-box
                         reshard, VSC130) and the elastic loader re-splits
                         its global sample cursor, so the continuation is
                         bit-identical (tests/test_torch_multihost_resilience
                         holds 2->1).
  NaN / loss-spike burst after ``threshold`` consecutive anomalous steps
                         (non-finite loss, optimizer skip, or z-score
                         spike) roll back to the last good checkpoint and
                         REPLAY (transient faults vanish); if the same
                         window goes bad twice, skip its data (bad batch).
  step exception         (RESOURCE_EXHAUSTED, loader hard-failure, ...)
                         flight-record, back off, restore, retry — up to
                         ``max_restarts`` in-process restarts.

Multi-process (``distributed.process_count() > 1``) adds the coordinated layer — the
failures that dominate production SPMD runs are CROSS-rank (PAPER.md /
arXiv:1811.02084-scale: one stuck rank stalls every healthy one forever;
arXiv:2004.13336's sharded state lets one divergent rank poison a
checkpoint that looks committed):

  hang                   per-host watchdog (resilience/watchdog.py): no
                         step progress within the deadline -> all-thread
                         stack dump + flight record + (optional) abort so
                         the external restart path takes over; barriers
                         and votes carry ``VESCALE_BARRIER_TIMEOUT`` so a
                         dead peer raises ``BarrierTimeout`` instead of
                         blocking.
  desync                 per-step control-plane exchange (one tiny
                         allgather: step counter, preempt flag, anomaly
                         streak) plus a cadenced consistency fingerprint
                         (resilience/consistency.py: RNG seed, loader
                         position, replicated-param sample, tree/mesh
                         structure) — any mismatch raises ``DesyncError``
                         on EVERY rank before the next save can commit
                         divergent state.
  torn commit            two-phase: every rank votes on its shard writes
                         (``all_processes_ok``) before process 0 writes
                         ``meta.json`` or rotation prunes anything; an
                         async save is committed at the NEXT step boundary
                         (one step of write/compute overlap).  A failed
                         vote means the step is committed NOWHERE and the
                         run continues to the next save.
  partial preemption     any rank's preemption flag is agreed via the
                         control exchange: all ranks drain, emergency-save
                         (two-phase), and exit "preempted" together.
  rollback agreement     restore targets come from
                         ``CheckpointManager.latest_common_step`` (the
                         newest step committed on ALL ranks), so ranks can
                         never roll back to different steps; a step
                         exception is fatal in coordinated mode (peers may
                         be wedged mid-collective — only a process-level
                         restart is safe, and auto-resume makes it cheap).

Every recovery event surfaces as a ``resilience_*`` counter in the
telemetry registry (exporters render them as the ``resilience:`` dashboard
block) and as an event line in ``steps.jsonl``.

Determinism contract: with a seeded loader (or a pure ``batch_fn``) and a
deterministic step, a run that suffers any schedule of transient faults
finishes BIT-IDENTICAL to an uninterrupted run: replay recomputes the
same step on the same data from checkpoint-roundtripped state.  The
port's train step updates the module in place; ``train.FunctionalStep``
gives it the functional signature this loop drives and copies a restored
state back into the live module and optimizer.  A CUDA out-of-memory
error rides the restart path like any step exception (the flight record
is written first).  Any other CUDA error propagates from the step: a
sticky one (an illegal address) leaves the context unusable, so no
restore could follow it.  A CUDA error or an out-of-memory error raised
by a restore propagates too, and quarantines nothing: it is the card's
fault, not the checkpoint's.

Checkpoints hold ``{"model", "optimizer", "extra"}`` in the reference's
layout, so a checkpoint of the JAX package's loop resumes here.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from .. import config as _config
from .. import distributed as _dist
from .. import random as _random
from . import consistency as _cons
from . import faultsim as _fs
from .preempt import PreemptionHandler
from .watchdog import Watchdog

__all__ = ["AnomalyPolicy", "RunResult", "run_resilient"]

# control-plane vector: [magic, step, preempt, resize, bad_streak,
# rollbacks, fp_due, <consistency fingerprint fields when fp_due>].
# Exchanged every step in coordinated mode; preempt and resize are ORs,
# everything else must agree.
_COORD_MAGIC = 0x7E5C0
_COORD_FIELDS = ("coord_magic", "step", "preempt", "resize", "bad_streak", "rollbacks", "fp_due")

# what the CUDA runtime, cuBLAS, cuDNN and the kernels' launchers say in the
# messages of the errors they raise
_CUDA_ERROR_MARKS = ("CUDA error", "CUDA out of memory", "cudaError", "CUBLAS_STATUS_",
                     "CUDNN_STATUS_", "cuDNN error", "device-side assert")


def _device_error(e: BaseException) -> bool:
    """Did ``e`` come from the card (an out-of-memory or a CUDA runtime
    error) rather than from storage, decoding or the step's own logic?"""
    accel = getattr(torch, "AcceleratorError", None)  # torch >= 2.8
    if isinstance(e, torch.cuda.OutOfMemoryError) or (accel is not None and isinstance(e, accel)):
        return True
    return isinstance(e, RuntimeError) and any(m in str(e) for m in _CUDA_ERROR_MARKS)


@dataclass
class AnomalyPolicy:
    """When does a sequence of suspicious steps become a rollback?

    A step is ANOMALOUS when its loss is non-finite, the optimizer's
    dynamic-loss-scale machinery skipped it (``skip_count`` > 0 in the
    opt state), or its loss z-scores beyond ``zscore`` against the rolling
    window of the last ``window`` clean losses (only once ``min_history``
    of them exist — early training is spiky by nature).  ``threshold``
    consecutive anomalous steps trigger the rollback."""

    threshold: int = 3
    zscore: float = 0.0  # 0 disables spike detection (NaN/skip still armed)
    window: int = 64
    min_history: int = 16
    max_rollbacks: int = 8


@dataclass
class RunResult:
    params: Any
    opt_state: Any
    step: int  # last COMPLETED step (-1: none)
    status: str  # "completed" | "preempted" | "resized"
    restarts: int = 0
    rollbacks: int = 0
    quarantined: int = 0
    anomaly_steps: int = 0
    emergency_save_step: Optional[int] = None
    losses: Dict[int, float] = field(default_factory=dict)  # last-run window


def _skip_count(opt_state) -> int:
    """The optimizer's consecutive-skipped-step counter, when it has one
    (DistributedOptimizer with loss_scale='dynamic'); 0 otherwise."""
    if isinstance(opt_state, dict):
        ls = opt_state.get("loss_scale")
        if isinstance(ls, dict) and "skip_count" in ls:
            try:
                return int(ls["skip_count"])
            except (TypeError, ValueError):
                return 0
    return 0


def run_resilient(
    *,
    step_fn: Callable,
    params: Any,
    opt_state: Any,
    manager,
    total_steps: int,
    loader=None,
    batch_fn: Optional[Callable[[int], Any]] = None,
    save_every: int = 100,
    async_save: bool = True,
    rng_seed: Optional[int] = None,
    anomaly: Optional[AnomalyPolicy] = None,
    max_restarts: int = 3,
    restart_backoff: float = 0.5,
    preemption: Optional[PreemptionHandler] = None,
    install_signal_handlers: bool = True,
    on_step: Optional[Callable[[int, float], None]] = None,
    watchdog: Optional[Watchdog] = None,
    watchdog_timeout_s: Optional[float] = None,
    consistency: Optional[_cons.ConsistencyChecker] = None,
    consistency_every: Optional[int] = None,
    coordinate: Optional[bool] = None,
    barrier_timeout_s: Optional[float] = None,
) -> RunResult:
    """Run ``total_steps`` training steps with automatic recovery.

    ``step_fn(params, opt_state, batch[, step_key]) -> (params, opt_state,
    loss, ...)`` — a ``make_train_step`` product or anything
    signature-compatible.  Data comes from ``loader`` (a ``TokenDataLoader``
    or anything with ``next()``/``state()``/``load_state()``) or from a pure
    ``batch_fn(batch_index)``; exactly one must be given.  Batch index i
    feeds step i until an escalated anomaly rollback skips a bad window
    (the loop then rides the data cursor forward of the step counter —
    both are checkpointed, so resume stays sample-exact either way).

    ``rng_seed`` (optional) derives ``step_key = random.fold_in(
    random.key(seed), step)`` per step (the port's threefry, bitwise
    ``jax.random``'s): replay-stable and checkpointed.

    Resumes automatically from ``manager``'s newest committed checkpoint;
    a checkpoint that commits but fails to restore is quarantined
    (``step_N.corrupt``) and the next-older one is tried.  A run that
    never saved CANNOT be restarted in-process after a step exception
    (the pre-step state is gone once the step ran) — save early.

    Multi-process: with ``distributed.process_count() > 1`` (or
    ``coordinate=True``)
    the loop runs the coordinated protocol described in the module
    docstring — per-step control exchange, agreed preemption, common
    restore targets, next-boundary two-phase commits, consistency checks
    every ``consistency_every`` steps (env ``VESCALE_CONSISTENCY_EVERY``,
    default 32), and NO in-process step-exception restarts (a peer may be
    wedged mid-collective; abort and auto-resume instead).  ``watchdog``/
    ``watchdog_timeout_s`` (env ``VESCALE_WATCHDOG_TIMEOUT``) arm the hang
    watchdog; ``barrier_timeout_s`` (env ``VESCALE_BARRIER_TIMEOUT``)
    bounds every coordination collective.

    NOTE: the anomaly guard reads the loss on the host every step (the
    same sync ``telemetry.record_step`` opts into): the one sync this loop
    adds to a step."""
    if (loader is None) == (batch_fn is None):
        raise ValueError("exactly one of loader / batch_fn is required")
    if total_steps <= 0:
        raise ValueError("total_steps must be positive")
    from .. import telemetry as _tel
    from ..checkpoint import LAST_LOAD_STATS as _load_stats
    from ..checkpoint.elastic import ElasticMismatchError as _ElasticMismatch
    from ..telemetry import memtrack as _memtrack

    if not _fs.is_armed():
        _fs.arm_from_env()  # VESCALE_FAULTSIM schedules for scripted runs
    pol = anomaly or AnomalyPolicy()
    handler = preemption or PreemptionHandler()
    own_handler = preemption is None
    if own_handler and install_signal_handlers:
        handler.install()

    coord = (_dist.process_count() > 1) if coordinate is None else bool(coordinate)

    # ------------------------------------------------- watchdog arming
    own_wd = False
    wd = watchdog
    if wd is None:
        # param deadline overrides the env one (0 = explicit off);
        # abort/exit-code always come from the env (one parser: from_env)
        wd = Watchdog.from_env(timeout_s=watchdog_timeout_s)
        own_wd = wd is not None
    if own_wd:
        wd.start()

    def _beat(at_step: int, phase: str = "step") -> None:
        if wd is not None:
            wd.beat(at_step, phase=phase)

    # ---------------------------------------------- consistency arming
    checker = consistency
    if checker is None:
        env_every = _config.get_int("VESCALE_CONSISTENCY_EVERY")
        n = consistency_every if consistency_every is not None else (
            int(env_every) if env_every else 32
        )
        # single-process fingerprints detect nothing (there is no peer to
        # disagree with) — armed by default only when coordinating, or on
        # explicit request (param / env), so bare runs pay zero
        if n > 0 and (coord or consistency_every is not None or env_every):
            checker = _cons.ConsistencyChecker(every=n, timeout_s=barrier_timeout_s)

    base_key = _random.key(rng_seed) if rng_seed is not None else None

    # ---------------------------------------------------------------- state
    result = RunResult(params=params, opt_state=opt_state, step=-1, status="completed")
    step = 0  # next step to run
    data_cursor = 0  # next batch index (>= step after an escalated skip)
    loss_window: deque = deque(maxlen=max(2, pol.window))
    bad_streak = 0
    restart_attempts = 0
    last_rollback_target: Optional[int] = None
    escalate_skip = False
    resize_requested = False  # faultsim "resize": simulated capacity change

    def _extra_state(completed_step: int) -> Dict[str, Any]:
        # `completed_step` is the step whose output result.params holds;
        # data_cursor / loader position already point at the NEXT batch
        return {
            "step": int(completed_step),
            "rng_seed": int(rng_seed) if rng_seed is not None else -1,
            "data_cursor": int(data_cursor),
            "loader": loader.state() if loader is not None else {},
        }

    def _ckpt_state(completed_step: int) -> Dict[str, Any]:
        return {
            "model": result.params,
            "optimizer": result.opt_state,
            "extra": _extra_state(completed_step),
        }

    def _event(kind: str, **fields) -> None:
        _tel.record_event(f"resilience_{kind}", **fields)

    def _latest() -> Optional[int]:
        """The newest restorable step: committed on ALL ranks when
        coordinating (ranks restoring different steps is a guaranteed
        desync), plain latest otherwise."""
        if coord:
            return manager.latest_common_step(timeout_s=barrier_timeout_s)
        return manager.latest_step()

    def _coordinate() -> tuple:
        """One control-plane allgather: agree on preemption and resize,
        verify the ranks are marching in lockstep, and (on the consistency
        cadence) compare state fingerprints.  Returns the AGREED
        ``(preempt, resize)`` flags (both ORs — any rank's capacity event
        drains everyone); raises ``DesyncError`` on any disagreement —
        symmetric on every rank, and always BEFORE the next save could
        commit divergent state."""
        fp = None
        if checker is not None and checker.due(step):
            checker.checks += 1
            fp = checker.fingerprint(
                step,
                data_cursor=data_cursor,
                rng_seed=rng_seed,
                loader_state=loader.state() if loader is not None else None,
                params=result.params,
                opt_state=result.opt_state,
            )
        vec = [
            _COORD_MAGIC,
            step,
            1 if handler.requested() else 0,
            1 if resize_requested else 0,
            bad_streak,
            result.rollbacks,
            0 if fp is None else 1,
        ]
        # FIXED width always: ranks disagreeing on the fingerprint cadence
        # (the desync case itself) must exchange same-shape rows so the
        # mismatch surfaces as a named DesyncError on fp_due/step, not as
        # an opaque shape error inside the collective
        vec.extend(int(v) for v in fp) if fp is not None else vec.extend(
            [0] * len(_cons.FIELDS)
        )
        rows = _dist.allgather_ints(vec, tag="resilience_coord", timeout_s=barrier_timeout_s)
        if rows.shape[0] == 1:
            # coordinate=True on one process (tests, bench): a single row
            # cannot mismatch — skip the compares, keep the counters honest
            if fp is not None:
                _tel.count("consistency_checks_total")
            return bool(vec[2]), bool(vec[3])
        preempt_any = bool(rows[:, 2].any())
        resize_any = bool(rows[:, 3].any())
        mismatched = _cons.compare_rows(rows[:, : len(_COORD_FIELDS)], _COORD_FIELDS)
        mismatched.pop("preempt", None)  # an OR, not an agreement
        mismatched.pop("resize", None)  # likewise
        if not mismatched and fp is not None:
            _tel.count("consistency_checks_total")
            mismatched = _cons.compare_rows(rows[:, len(_COORD_FIELDS) :], _cons.FIELDS)
        if mismatched:
            _tel.count("consistency_mismatches_total")
            _event("desync", at_step=step, fields=sorted(mismatched))
            _memtrack.dump_now(reason=f"desync@step{step}")
            # quarantine the run: raising here (on every rank — the
            # gathered matrix is identical everywhere) guarantees no
            # further save can commit divergent state
            raise _cons.DesyncError(mismatched, rows)
        if preempt_any and not handler.requested():
            handler.request()  # a PEER was preempted; we drain with it
        return preempt_any, resize_any

    def _restore_latest() -> Optional[int]:
        """Restore the newest committed checkpoint, quarantining any that
        commit but will not load.  Returns the restored step or None.
        Mutates result.params/opt_state, step, data_cursor, loader.
        Coordinated mode: the target comes from ``latest_common_step`` and
        per-target restore success is VOTED, so a rank-local read failure
        quarantines the step on every rank together (ranks falling back to
        different steps would desync)."""
        nonlocal step, data_cursor
        while True:
            target = _latest()
            if target is None:
                return None
            template = _ckpt_state(0)
            restore_err: Optional[Exception] = None
            t_restore = time.perf_counter()
            try:
                restored = manager.restore(template, step=target)
            except KeyError as e:
                # missing array key = STRUCTURAL mismatch (e.g. a manual-loop
                # checkpoint without the 'extra' tree, or a renamed state
                # field) — deterministic across every checkpoint, so
                # quarantining would sideline all the good saves and
                # silently restart from scratch.  Refuse instead.
                raise RuntimeError(
                    f"checkpoint step {target} does not match run_resilient's "
                    f"state schema ({e}); refusing to quarantine a "
                    "structurally incompatible (not corrupt) checkpoint — "
                    "restore it manually or resume with matching state"
                ) from e
            except _ElasticMismatch as e:
                # CODED verdict (VSC131/VSC132) from the pre-read preflight:
                # the checkpoint is fine, the worlds are incompatible — a
                # deterministic property of every committed step, so (like
                # the schema case above) quarantining would sideline all
                # the good saves.  A pure mesh/world change never lands
                # here: the writer block routes it to reshard-on-load.
                raise RuntimeError(
                    f"checkpoint step {target} cannot be restored into this "
                    f"run's world ({e}); refusing to quarantine a "
                    "structurally incompatible (not corrupt) checkpoint"
                ) from e
            except Exception as e:  # corrupt-but-committed on THIS rank
                if _device_error(e):
                    # the card failed (an OOM beside the live state, or a
                    # sticky CUDA error from the step before), not the
                    # checkpoint: every older step would fail the same way,
                    # so quarantining would sideline them all.  In
                    # coordinated mode the peers' restore vote then times
                    # out and they abort too.
                    raise
                restore_err = e
                restored = None
            ok = restore_err is None
            if coord:
                # restore success is voted: a rank-local read failure must
                # quarantine the step EVERYWHERE (the healthy ranks discard
                # their successful load) or ranks would restore different
                # steps — the desync this whole layer exists to prevent
                ok = _dist.all_processes_ok(
                    ok, tag=f"resilience_restore:{target}", timeout_s=barrier_timeout_s
                )
            if not ok:
                err = repr(restore_err) if restore_err is not None else "peer restore failure"
                result.quarantined += 1
                dst = manager.quarantine(target)
                if dst is None:
                    # rename failed (read-only root?): without it the same
                    # step stays newest-committed and this loop would spin
                    raise RuntimeError(
                        f"checkpoint step {target} is unloadable ({err}) and "
                        "could not be quarantined; aborting restore"
                    ) from restore_err
                _event("quarantine", ckpt_step=target, path=dst, error=err)
                import warnings

                warnings.warn(
                    f"checkpoint step {target} is committed but unloadable "
                    f"({err}); quarantined to {dst} — trying the next-older "
                    "committed step",
                    stacklevel=2,
                )
                continue
            result.params = restored["model"]
            result.opt_state = restored["optimizer"]
            extra = restored["extra"]
            result.step = int(extra["step"])
            step = int(extra["step"]) + 1
            data_cursor = int(extra["data_cursor"])  # already next-batch index
            if _load_stats.get("elastic"):
                # the checkpoint's writer world differed: this restore WAS
                # the cross-world reshard (VSC130); load() already counted
                # resilience_elastic_restores_total / reshard_seconds
                wm = manager.writer_meta(target) if hasattr(manager, "writer_meta") else None
                _event(
                    "elastic_restore",
                    ckpt_step=target,
                    writer=wm,
                    reshard_seconds=time.perf_counter() - t_restore,
                )
            if loader is not None:
                loader.load_state({k: int(v) for k, v in extra["loader"].items()})
            saved_seed = int(extra["rng_seed"])
            if rng_seed is not None and saved_seed not in (-1, int(rng_seed)):
                raise ValueError(
                    f"checkpoint was written with rng_seed={saved_seed}, this "
                    f"run uses {rng_seed} — resuming would fork the RNG stream"
                )
            return target

    def _next_batch():
        nonlocal data_cursor
        batch = loader.next() if loader is not None else batch_fn(data_cursor)
        data_cursor += 1
        return batch

    def _save(at_step: int, sync: bool = False) -> None:
        manager.save(
            at_step,
            _ckpt_state(at_step),
            async_checkpoint=async_save and not sync,
        )

    # -------------------------------------------------------------- resume
    resumed = _restore_latest()
    if resumed is not None:
        _tel.count("resilience_resumes_total")
        _event("resume", ckpt_step=resumed)

    commit_due = False  # coordinated mode: an async save awaiting its vote
    try:
        while True:
            # ---------------------------------------------- step-boundary gate
            _fs.set_step(step)
            _beat(step)
            if _fs.fires("hang", ctx=f"step{step}"):
                # simulated wedged collective: stall far past any deadline —
                # the watchdog's detect/dump/abort path is the way out
                time.sleep(_config.get_float("VESCALE_FAULTSIM_HANG_S"))
            if _fs.fires("preempt", ctx=f"step{step}"):
                handler.request()
            if _fs.fires("resize", ctx=f"step{step}"):
                resize_requested = True  # simulated capacity change: drain
                # and exit "resized" so a supervisor relaunches on the new
                # world size and elastic auto-resume takes over
            # coordinated mode: one control-plane allgather — agreed
            # preemption/resize, lockstep verification, cadenced fingerprints
            if coord:
                preempt_now, resize_now = _coordinate()
            else:
                # an explicitly-armed checker still runs its cadence
                # (trivially consistent alone, but the counters stay honest
                # and the fingerprint computation is validated)
                if checker is not None and checker.due(step):
                    checker.maybe_check(
                        step,
                        data_cursor=data_cursor,
                        rng_seed=rng_seed,
                        loader_state=loader.state() if loader is not None else None,
                        params=result.params,
                        opt_state=result.opt_state,
                    )
                preempt_now = handler.requested()
                resize_now = resize_requested
            if preempt_now or resize_now:
                # preemption wins when both fire in the same boundary (the
                # SIGTERM deadline is the harder constraint); the drain +
                # emergency-save choreography is identical either way
                result.status = "preempted" if preempt_now else "resized"
                _tel.count(
                    "resilience_preemptions_total" if preempt_now
                    else "resilience_resizes_total"
                )
                # no emergency save mid-anomaly-streak: result.params may be
                # poisoned, and a preemption must not promote them to the
                # newest committed checkpoint (resume replays from the last
                # good one instead — same rule as the periodic save)
                if result.step >= 0 and bad_streak == 0:
                    manager.wait_pending()  # drain in-flight async saves
                    if _latest() != result.step:
                        _beat(step, "emergency_save")
                        _save(result.step, sync=True)
                        _tel.count("resilience_emergency_saves_total")
                        result.emergency_save_step = result.step
                _event(
                    result.status,
                    at_step=result.step,
                    signum=handler.signum if preempt_now else None,
                    emergency_save=result.emergency_save_step,
                )
                return result
            if step >= total_steps:
                manager.wait_pending()  # the final async save must commit
                result.status = "completed"
                return result
            if commit_due:
                # two-phase commit of the previous boundary's async save:
                # handle.wait() runs the all-rank vote + meta.json write on
                # this thread — one step of write/compute overlap, and a
                # failed vote means the step committed NOWHERE (the run
                # continues to the next save)
                manager.wait_pending()
                commit_due = False
                _beat(step, "commit")

            # ------------------------------------------------- run one step
            cursor_before = data_cursor
            try:
                # batch fetch INSIDE the try: a loader hard failure (retries
                # exhausted) rides the same restart path as a step exception
                batch = _next_batch()
                _fs.check("oom", ctx=f"step{step}")
                if base_key is not None:
                    out = step_fn(
                        result.params,
                        result.opt_state,
                        batch,
                        _random.fold_in(base_key, step),
                    )
                else:
                    out = step_fn(result.params, result.opt_state, batch)
            except KeyboardInterrupt:
                # a fetched-but-never-trained batch must not stay consumed:
                # rewind the stream so the emergency save's cursor matches
                # result.step (otherwise resume silently skips a sample).
                # Only if the fetch actually advanced the cursor — a Ctrl-C
                # inside the fetch itself advanced nothing.
                if data_cursor > cursor_before:
                    data_cursor = cursor_before
                    if loader is not None:
                        st = loader.state()
                        st["batches_served"] = int(st["batches_served"]) - 1
                        loader.load_state(st)
                handler.request()
                continue
            except Exception as e:
                _memtrack.maybe_dump_oom(e)
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    # the context survives an allocation failure: hand the
                    # cached blocks back before the restore allocates
                    torch.cuda.empty_cache()
                elif _device_error(e):
                    # any other CUDA error may be sticky (an illegal
                    # address poisons the context): no in-process restore
                    # can follow it, only a new process
                    _event("fatal_step_error", at_step=step, error=repr(e))
                    raise
                if coord:
                    # multi-host: peers may be wedged inside the failed
                    # step's collective — no Python-level restore here can
                    # reach them, so an in-process restart would desync.
                    # Abort; the supervisor restarts every rank and
                    # auto-resume makes it one checkpoint interval cheap.
                    _event("fatal_step_error", at_step=step, error=repr(e))
                    raise
                # in-process restart path: flight-record, back off, restore
                restart_attempts += 1
                result.restarts += 1
                _tel.count("resilience_restarts_total")
                _event("restart", at_step=step, attempt=restart_attempts, error=repr(e))
                if restart_attempts > max_restarts:
                    raise
                if manager.latest_step() is None:
                    raise  # nothing to restore from: the failure is fatal
                time.sleep(restart_backoff * (2.0 ** (restart_attempts - 1)))
                if _restore_latest() is None:
                    # every committed step was quarantined during restore:
                    # params/step/cursor were never rewound — retrying would
                    # train on from post-exception state with no way back
                    raise RuntimeError(
                        f"restart after step-{step} failure: no checkpoint "
                        "survived restore (all quarantined)"
                    ) from e
                bad_streak = 0
                loss_window.clear()
                continue

            new_params, new_opt_state, loss = out[0], out[1], out[2]
            loss_val = float(loss)
            if _fs.fires("nonfinite_loss", ctx=f"step{step}"):
                loss_val = float("nan")  # observation-level injection: the
                # compiled step is untouched; the guard sees a NaN burst

            # ------------------------------------------------ anomaly guard
            anomalous = not math.isfinite(loss_val) or _skip_count(new_opt_state) > 0
            if (
                not anomalous
                and pol.zscore > 0
                and len(loss_window) >= max(2, pol.min_history)
            ):
                mean = sum(loss_window) / len(loss_window)
                var = sum((v - mean) ** 2 for v in loss_window) / len(loss_window)
                std = var**0.5
                if std > 0 and abs(loss_val - mean) > pol.zscore * std:
                    anomalous = True
            if anomalous:
                bad_streak += 1
                result.anomaly_steps += 1
                _tel.count("resilience_anomaly_steps_total")
            else:
                bad_streak = 0
                loss_window.append(loss_val)

            if anomalous and bad_streak >= pol.threshold:
                # ------------------------------------------------- rollback
                result.rollbacks += 1
                _tel.count("resilience_rollbacks_total")
                _memtrack.dump_now(reason=f"anomaly_rollback@step{step}")
                if result.rollbacks > pol.max_rollbacks:
                    raise RuntimeError(
                        f"anomaly guard: {result.rollbacks} rollbacks exceed "
                        f"max_rollbacks={pol.max_rollbacks}; giving up"
                    )
                bad_step = step  # last (anomalous) step that ran
                if not coord and manager.latest_step() is None:
                    raise RuntimeError(
                        f"anomaly at step {step} but no committed checkpoint "
                        "to roll back to (save_every too large?)"
                    )
                manager.wait_pending()  # a pending save may hold a bad step
                if coord and _latest() is None:
                    # checked AFTER the drain (the drained commit may be the
                    # only checkpoint) and via the all-rank intersection so
                    # every rank raises together
                    raise RuntimeError(
                        f"anomaly at step {step} but no committed checkpoint "
                        "to roll back to (save_every too large?)"
                    )
                target = _restore_latest()
                if target is None:
                    # every committed step was quarantined during restore:
                    # params/step were never rewound — continuing would
                    # train on from the anomalous state with no way back
                    raise RuntimeError(
                        f"anomaly at step {bad_step}: no checkpoint survived "
                        "restore (all quarantined); cannot roll back"
                    )
                escalate_skip = last_rollback_target == target
                if escalate_skip and loader is not None:
                    # the SAME window went bad after a clean replay: its
                    # data is the problem — advance the stream past it
                    st = loader.state()
                    st["batches_served"] = bad_step + 1 - step + int(st["batches_served"])
                    loader.load_state(st)
                    data_cursor += bad_step + 1 - step
                elif escalate_skip:
                    data_cursor += bad_step + 1 - step
                _tel.count("resilience_rollback_data_skips_total" if escalate_skip else "resilience_rollback_replays_total")
                _event(
                    "rollback",
                    bad_step=bad_step,
                    restored_step=target,
                    data_skipped=escalate_skip,
                )
                last_rollback_target = target
                bad_streak = 0
                loss_window.clear()
                continue

            # ------------------------------------------------- commit step
            result.params, result.opt_state = new_params, new_opt_state
            result.step = step
            result.losses[step] = loss_val
            if on_step is not None:
                on_step(step, loss_val)
            # periodic save — but NEVER mid-anomaly-streak: a checkpoint of
            # possibly-poisoned params must not become the rollback target
            if bad_streak == 0 and (
                (step + 1) % max(1, save_every) == 0 or step == total_steps - 1
            ):
                _beat(step, "save")
                _save(step)
                if coord and async_save:
                    commit_due = True  # voted at the next step boundary
                last_rollback_target = None  # clean committed progress:
                # the next rollback (if any) restores a NEWER step, so
                # re-arm replay-first semantics
            step += 1
    finally:
        if own_wd:
            wd.stop()
        if own_handler and install_signal_handlers:
            handler.uninstall()
