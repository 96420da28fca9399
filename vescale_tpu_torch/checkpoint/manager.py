"""CheckpointManager: step-indexed save, rotation and resume.

The port of ``vescale_tpu/checkpoint/manager.py`` (the reference
VeScaleCheckpointer, legacy ``api/vescale_checkpointer.py:71``): names
checkpoints by step (``root/step_<N>/``), keeps the last K, and on restart
finds the newest COMMITTED one (a directory whose ``meta.json`` is present
and parses; a torn save from a crashed run is invisible).  Re-saving a
step, and saving below a step already saved (a rollback: everything newer
is divergent history), are handled synchronously before the new save
starts.  Across processes, process 0 renames and deletes, and every
process meets at ``distributed.barrier`` or ``all_processes_ok`` around it.

One manager owns a root a process: saves behind its back (a second
instance, a direct ``checkpoint.save`` into the root) cannot be tracked.
A quarantine counts ``resilience_quarantined_total``; a failed async
commit prints one line on stderr, counts
``resilience_commit_failures_total`` and records a
``resilience_commit_failed`` event (the telemetry API's no-ops while
telemetry is off).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
from typing import Any, Dict, List, Optional

from .. import distributed as _dist
from .. import telemetry as _tel
from . import CheckpointHandle, load, save

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        if root.startswith(("mem://", "memsvr://")):
            raise ValueError(
                "CheckpointManager rotates directories; use a filesystem root "
                "(memory stores are flat namespaces — save to them directly)"
            )
        self.root = root
        self.keep = int(keep)
        os.makedirs(root, exist_ok=True)
        # meta.json validation cache: (size, mtime_ns) of metas that parsed
        # (committed metas are immutable; resave/uncommit delete the file,
        # changing the key) — _committed_steps runs per save for rotation
        # and must not re-parse every meta every time
        self._meta_ok: Dict[str, tuple] = {}
        # highest step save() was ever asked for, seeded from disk so a
        # RESTARTED process that resumes from an older step still recognizes
        # the on-disk newer steps as stale futures when it next saves
        committed = self._committed_steps()
        self._max_requested = committed[-1] if committed else -1
        # deterministic step history: committed on disk at construction +
        # every step requested through this manager since.  Identical on
        # every process (same disk seed, same save-call sequence), so the
        # re-save/rollback cleanup decisions below never depend on racy
        # filesystem state.
        self._known_steps = set(committed)
        self._pending: Dict[int, CheckpointHandle] = {}  # in-flight async saves

    # ------------------------------------------------------------- paths
    def step_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def _meta_committed(self, meta_path: str) -> bool:
        """True iff the commit marker is a real one: present, non-empty AND
        JSON-parseable.  A crash mid-commit-write (non-atomic storage, power
        loss before the data hit disk) can leave a zero-byte or truncated
        meta.json — counting that as committed makes restore() fail on a
        checkpoint that never finished (the torn-commit false positive)."""
        try:
            st = os.stat(meta_path)
        except OSError:
            return False
        if st.st_size == 0:
            return False
        key = (st.st_size, st.st_mtime_ns)
        if self._meta_ok.get(meta_path) == key:
            return True
        try:
            with open(meta_path, "rb") as f:
                json.loads(f.read().decode())
        except (OSError, ValueError, UnicodeDecodeError):
            return False
        self._meta_ok[meta_path] = key
        return True

    def _committed_steps(self) -> List[int]:
        out = []
        try:
            entries = os.listdir(self.root)
        except OSError:
            return out
        for e in entries:
            m = _STEP_RE.match(e)
            if m and self._meta_committed(os.path.join(self.root, e, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    @staticmethod
    def _fsync_dir(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _uncommit(self, step: int) -> None:
        """Make ``step`` torn-invisible, then clear its dir (process 0 only;
        callers barrier afterwards in multi-process runs).  The meta.json
        unlink is fsynced before the dir is cleared: to the same power-loss
        standard the commit path holds (storage.py fsyncs file + parent
        dir), or a replayed journal could resurrect the OLD meta.json over
        the NEW chunk files the next save writes under the same names."""
        if _dist.process_index() != 0:
            return
        step_dir = self.step_path(step)
        self._meta_ok.pop(os.path.join(step_dir, "meta.json"), None)
        try:
            os.remove(os.path.join(step_dir, "meta.json"))
        except OSError:
            pass
        self._fsync_dir(step_dir)
        shutil.rmtree(step_dir, ignore_errors=True)
        self._fsync_dir(self.root)

    def latest_step(self) -> Optional[int]:
        """Newest step with a COMMITTED checkpoint (meta.json present and
        parseable); None if nothing is restorable."""
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def latest_common_step(self, timeout_s: Optional[float] = None) -> Optional[int]:
        """Newest step committed AS SEEN BY EVERY process — the only safe
        restore target in a multi-host run.  Each process's local directory
        listing can disagree (a shared filesystem propagating a commit, a
        straggler that missed a prune), and ranks restoring DIFFERENT steps
        is a guaranteed desync; the intersection-of-committed-sets makes the
        choice identical everywhere by construction.

        Elastic join/leave: a rank with NO committed steps at all (a
        freshly joined replacement after a capacity change, an empty
        scratch dir) ABSTAINS instead of vetoing — it adopts whatever the
        populated ranks agree on and restores that step from the shared
        root.  Only when every rank is empty is there nothing to restore.
        Single-process: ``latest_step``.  ``timeout_s`` as in
        ``distributed.barrier``."""
        if _dist.process_count() == 1:
            return self.latest_step()
        # fixed-width exchange: newest K steps padded with -1 (allgather
        # needs same-shape rows); K=16 >> keep, so the intersection can
        # only miss steps rotation already pruned somewhere
        K = 16
        mine = self._committed_steps()[-K:]
        row = [-1] * (K - len(mine)) + mine
        rows = _dist.allgather_ints(row, tag="ckpt_latest_common", timeout_s=timeout_s)
        return self._common_from_rows(rows)

    @staticmethod
    def _common_from_rows(rows) -> Optional[int]:
        """Newest step in the intersection of every NON-EMPTY row (-1 pads;
        an all--1 row is a joining rank with no local state and abstains).
        Factored out so the join/leave policy is unit-testable without a
        process rig."""
        common: Optional[set] = None
        for r in rows:
            steps = {int(v) for v in r if v >= 0}
            if not steps:
                continue  # joining rank: adopt, don't veto
            common = steps if common is None else common & steps
        return max(common) if common else None

    def writer_meta(self, step: int) -> Optional[Dict[str, Any]]:
        """The ``step``'s recorded writer world (see
        ``checkpoint.read_writer_meta``): process/device counts + mesh
        descriptors — what the resilience loop compares against its own
        world to tell an elastic (cross-world) resume from a same-shape
        one.  None for pre-elastic checkpoints or unreadable meta."""
        from . import read_writer_meta

        try:
            return read_writer_meta(self.step_path(step))
        except (OSError, ValueError):
            return None

    def quarantine(self, step: int) -> Optional[str]:
        """Sideline a committed-but-unloadable step: rename its dir to
        ``step_<N>.corrupt`` so ``latest_step`` skips it (the restore-time
        fallback of resilience/loop.py retries the next-older committed
        step) while the bytes stay on disk for forensics.  Returns the
        quarantine path, or None when the dir is already gone.  Process 0
        renames; in multi-process runs the built-in barrier holds everyone
        until the rename landed (all processes must call this on the
        shared restore failure)."""
        step_dir = self.step_path(step)
        dst = step_dir + ".corrupt"
        self._meta_ok.pop(os.path.join(step_dir, "meta.json"), None)
        self._known_steps.discard(step)
        renamed = True
        if _dist.process_index() == 0:
            if os.path.exists(dst):  # a previous quarantine of this step
                shutil.rmtree(dst, ignore_errors=True)
            try:
                os.rename(step_dir, dst)
            except OSError:
                renamed = False
            self._fsync_dir(self.root)
        if _dist.process_count() > 1:
            # every process calls quarantine on the shared restore failure;
            # nobody may re-list the root (and retry the same step, issuing
            # mismatched collective loads) until process 0's rename landed.
            # The sync doubles as a VOTE on the rename so a failure on
            # process 0 aborts every rank together (asymmetric knowledge of
            # a failed quarantine would leave rank 0 raising while the
            # others retry the same step — a guaranteed desync)
            renamed = _dist.all_processes_ok(renamed, f"ckpt_quarantine:{step}")
        if not renamed:
            return None
        _tel.count("resilience_quarantined_total")
        return dst

    def wait_pending(self) -> None:
        """Drain every in-flight async save: failed ones are joined without
        committing, live ones are ``wait()``ed (committing them).  The
        preemption path calls this before the emergency synchronous save so
        no io worker is still writing when the process exits."""
        pending, self._pending = self._pending, {}
        for s in sorted(pending):
            h = pending[s]
            if h.failed:
                self._commit_failed(s, h.error)
                h.drain()
                continue
            try:
                h.wait()
            except Exception as e:
                # the failed step never commits anywhere (the commit vote
                # already erred on every process); surface it and move on —
                # the emergency save / next periodic save is what matters
                self._commit_failed(s, e)
            h.drain()

    @staticmethod
    def _commit_failed(step: int, error) -> None:
        print(f"[checkpoint] step {step} was not committed: {error!r}", file=sys.stderr)
        _tel.count("resilience_commit_failures_total")
        _tel.record_event("resilience_commit_failed", ckpt_step=step, error=repr(error))

    # -------------------------------------------------------------- save
    def save(
        self,
        step: int,
        checkpoint_state: Dict[str, Any],
        async_checkpoint: bool = False,
    ) -> Optional[CheckpointHandle]:
        """Save under ``root/step_<N>/`` and prune old committed steps down
        to ``keep`` (rotation runs on process 0 after the save commits)."""
        # Rollback (saving a step below one already requested: the run
        # resumed from an older step; everything newer is divergent
        # history) is handled ENTIRELY synchronously, before the new save
        # starts.  Every previous attempt to defer the stale-future pruning
        # to commit time raced some interleaving of concurrent async saves
        # (late-firing rotations re-evaluating "committed > step", reused
        # step numbers, ascending keep-cuts counting doomed dirs).  The
        # synchronous design has no deferred deletions at all: by the time
        # any later save is requested, the stale dirs are gone.
        rollback = step < self._max_requested
        # prune finished saves: wait()ed handles, FAILED fire-and-forget
        # saves (their step never commits — surfaced on stderr by save()),
        # and ones whose commit marker already landed.  A failed save is
        # DRAINED before it is dropped: its surviving io workers could
        # otherwise keep writing stale chunks into a dir a later save of
        # the same step is about to clear and refill.
        pending: Dict[int, CheckpointHandle] = {}
        for s, h in self._pending.items():
            if h.failed:
                h.drain()
                continue
            if h._done or os.path.exists(os.path.join(self.step_path(s), "meta.json")):
                continue
            pending[s] = h
        self._pending = pending
        # Same-step re-save detection rides ONLY on deterministic manager
        # history (`_known_steps`: committed on disk at init, or requested
        # through this manager since) — never on raw dir existence.  In a
        # multi-process run the step dir appears the moment ANOTHER
        # process's writers start on the same (first) save, and checking
        # existence would also race process 0's cleanup rmtree below,
        # leaving a slow process outside the resave barrier (deadlock).
        if not rollback and step in self._known_steps:
            # re-saving the SAME step — in flight or already on disk.  Two
            # writers interleaving chunk files in one step_N dir (or new
            # chunks landing under a LIVE old meta.json) would let a crash
            # mid-save read as a committed checkpoint with mixed content.
            # Drain any in-flight save, un-commit (meta.json goes first, so
            # the dir is torn-invisible from here on), clear the dir on one
            # process, and sync before any new writer starts.
            if step in self._pending:
                # drain WITHOUT committing: the in-flight save is doomed
                # (its dir is cleared next), and actively committing it
                # would fire on_commit rotation — pruning an old step on
                # the strength of a checkpoint about to be deleted
                self._pending.pop(step).drain()
            self._uncommit(step)
            if _dist.process_count() > 1:
                _dist.barrier(f"ckpt_resave:{step}")
        if rollback:
            # in-flight async saves could still be writing into dirs about
            # to be pruned (their late writers would resurrect them): wait
            # every pending save out, then prune the stale futures NOW
            for s in sorted(self._pending):
                h = self._pending.pop(s)
                if s > step:
                    # doomed stale future: join its writers, never commit it
                    # (a commit would fire rotation against a dir pruned on
                    # the next line)
                    h.drain()
                    continue
                try:
                    h.wait()  # a real checkpoint below the rollback point:
                except Exception:  # commit it before the timeline restarts
                    pass
                h.drain()  # wait() raises on first error; join stragglers
            if _dist.process_index() == 0:
                for s in self._committed_steps():
                    if s > step:
                        shutil.rmtree(self.step_path(s), ignore_errors=True)
            # a rollback can land ON a previously committed step number
            # (same save cadence after resume): its dir must be un-committed
            # too, or the new chunks write under the LIVE old meta.json and
            # a crash mid-save restores silently mixed timelines
            if step in self._known_steps:
                self._uncommit(step)
            if _dist.process_count() > 1:
                _dist.barrier(f"ckpt_rollback:{step}")
            # the timeline restarts here (NOT a dead store: without the
            # reset, later ascending saves would keep reading as rollbacks
            # against the old watermark); rollbacks are rare, so committing
            # synchronously removes the slow-async-rollback-commit race
            # class
            self._max_requested = step
            self._known_steps = {s for s in self._known_steps if s < step}
            async_checkpoint = False
        else:
            self._max_requested = max(self._max_requested, step)
        self._known_steps.add(step)

        def _rotate():
            # pure oldest-first keep-K cut: never touches the newest steps,
            # so late-firing rotations of concurrent ascending saves are
            # harmless in any interleaving
            if _dist.process_index() != 0:
                return
            steps = self._committed_steps()
            for s in steps[: max(0, len(steps) - self.keep)]:
                shutil.rmtree(self.step_path(s), ignore_errors=True)

        # on_commit runs exactly when meta.json lands — on this thread for
        # sync saves, on the io pool for fire-and-forget async saves, and
        # inside wait() for multi-process async saves
        handle = save(
            self.step_path(step),
            checkpoint_state,
            async_checkpoint=async_checkpoint,
            on_commit=_rotate,
        )
        if handle is not None:
            self._pending[step] = handle
        return handle

    # ----------------------------------------------------------- restore
    def restore(
        self,
        checkpoint_state: Dict[str, Any],
        step: Optional[int] = None,
        strict: bool = True,
    ) -> Dict[str, Any]:
        """Load the given (default: latest committed) step into the
        template's layout — the reshard-on-load path of ``load``.
        ``strict=False`` keeps template values for keys the checkpoint
        predates (see ``load``)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint under {self.root}")
        return load(self.step_path(step), checkpoint_state, strict=strict)
