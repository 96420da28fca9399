"""Durable fleet journal: the router's write-ahead log plus the fenced
leader lease that make crash recovery and warm-standby takeover safe.

The port of ``vescale_tpu/serve/journal.py``, byte-compatible with it: a
journal either package writes replays in the other.  A replica's death
is survivable by failover alone, but the router's own state (the
:class:`~.router.FleetLedger`, the affinity ring, the breaker states,
the autoscaler's hold and cooldown clocks, a half-committed rollout)
lives in its memory.  This module makes that state reconstructible from
what was already durably written.

Design:

  * **CRC-framed JSONL records.**  Each record is one line,
    ``<crc32 hex8> <compact json>\\n`` — torn tails are detectable
    (the LAST line of the LAST segment failing to parse is tolerated
    and counted ``torn``), and any OTHER bad line is **quarantined**
    with a counter instead of aborting replay (a flipped bit loses one
    record, never the journal).
  * **Ledger transitions as records.**  ``submit`` / ``dispatch``
    (kind: dispatch / redispatch / failover / hedge) / ``drop`` (a rid
    leaving a replica without a terminal — shed spill-over, failover) /
    ``terminal`` / ``open`` (a leader generation began) — enough to
    rebuild every pending rid WITH its per-replica dispatch tags, so a
    recovered router can harvest already-finished outcomes idempotently
    (exact tag match) and re-drive only what was truly never placed.
  * **Writer-side reduction.**  The journal folds every appended record
    into a reduced state dict as it buffers it; a **snapshot** record is
    that state serialized verbatim.  Snapshot+tail replay is therefore
    *equal by construction* to full replay (the recovery-matrix property
    test pins it), and snapshots also carry the non-replayable extras:
    ring membership, breaker states, autoscaler clocks, rollout stage.
  * **Buffered O(1) appends.**  ``append()`` is a dict build + a list
    push; framing (json+crc) and IO happen at ``flush()``.  The router
    flushes at poll boundaries, after every successful placement (the
    WAL barrier: a replica-accepted dispatch is journaled before the
    router acts on it further), and ALWAYS before a terminal outcome is
    acked into the ledger — ``VESCALE_FLEET_JOURNAL_FSYNC`` picks the
    durability floor (``none`` | ``flush`` = OS page cache, survives
    ``kill -9``; ``always`` = fsync, survives host crash).
  * **Rotation + compaction.**  When the active segment exceeds
    ``VESCALE_FLEET_JOURNAL_ROTATE_BYTES`` the next snapshot starts a
    fresh segment (snapshot-first, so the new segment replays alone)
    and older segments are pruned.
  * **Fenced leader lease.**  :class:`LeaderLease` is an atomically
    rewritten lease file ``{epoch, holder, expires_at}``: acquiring an
    expired lease bumps the **epoch**, and every journal flush checks
    the fence — a deposed leader (file epoch > writer epoch) gets
    :class:`FencedEpochError` instead of a write, so a stale leader can
    never ack an outcome (dual-leader writes are refused at the
    durability barrier, not by convention).  The epoch is also encoded
    into every dispatch tag (``tag = epoch << 40 | counter``), so a
    deposed leader's stale placements can never tag-match a recovered
    router's expectations.

Known window (documented, not hidden): a real ``kill -9`` landing in
the microseconds between a replica accepting a submit and the router's
placement-barrier flush can lose that dispatch record; recovery then
re-drives the rid and the replica rejects the duplicate while serving
the original under the old tag.  The faultsim ``router_kill`` kind
fires at the pump boundary (journal consistent), and a wall deadline
bounds the residual real-world case to an honest ``timed_out``.

Used by :class:`~.router.FleetRouter` (``journal=`` / ``lease=``, or the
``VESCALE_FLEET_JOURNAL_DIR`` / ``VESCALE_FLEET_LEASE_PATH`` knobs),
``FleetRouter.recover_from_journal`` and :class:`~.router.StandbyRouter`.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import config as _config
__all__ = [
    "FencedEpochError",
    "FleetJournal",
    "LeaderLease",
    "EPOCH_SHIFT",
    "make_tag",
    "tag_epoch",
    "empty_state",
    "reduce_record",
    "frame_record",
    "parse_frame",
    "replay_dir",
    "slim_outcome",
]


class FencedEpochError(RuntimeError):
    """The leader lease names a NEWER epoch than this writer: the caller
    was deposed.  Raised instead of writing (dual-leader refusal) and on
    lease renewal by a stale holder."""


# ------------------------------------------------------------- epoch tags
# tag = (epoch << EPOCH_SHIFT) | counter: the dispatch-attempt token the
# replica echoes back carries the leader generation that issued it, so a
# deposed leader's placements can never tag-match a recovered router.
EPOCH_SHIFT = 40
TAG_COUNTER_MASK = (1 << EPOCH_SHIFT) - 1


def make_tag(epoch: int, counter: int) -> int:
    return (int(epoch) << EPOCH_SHIFT) | (int(counter) & TAG_COUNTER_MASK)


def tag_epoch(tag: int) -> int:
    return int(tag) >> EPOCH_SHIFT


# ------------------------------------------------------------ leader lease
class LeaderLease:
    """File-based fenced lease: ``{epoch, holder, expires_at}`` rewritten
    atomically (tmp + rename).  Epochs only ever grow — taking over an
    expired lease bumps the epoch, and :meth:`check_fenced` is the write
    fence the journal consults at every flush.  ``now_fn`` defaults to
    WALL time (``time.time``) because expiry must compare across
    processes; tests inject a fake clock."""

    def __init__(
        self,
        path: str,
        holder: str,
        *,
        ttl_s: Optional[float] = None,
        now_fn: Callable[[], float] = time.time,
    ):
        self.path = path
        self.holder = holder
        self.ttl_s = float(
            ttl_s if ttl_s is not None else _config.get_float("VESCALE_FLEET_LEASE_TTL_S")
        )
        self._now = now_fn
        self.epoch = 0  # the epoch THIS holder owns (0 = never acquired)
        self._last_write_at = float("-inf")

    # ------------------------------------------------------------- file io
    def read(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                st = json.load(fh)
            return st if isinstance(st, dict) else None
        except (OSError, ValueError):
            return None

    def _write(self) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        st = {
            "epoch": self.epoch,
            "holder": self.holder,
            "expires_at": self._now() + self.ttl_s,
        }
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(st, fh)
        os.replace(tmp, self.path)
        self._last_write_at = self._now()

    # ----------------------------------------------------------- lifecycle
    def expired(self, st: Optional[Dict[str, Any]] = None) -> bool:
        st = st if st is not None else self.read()
        if st is None:
            return True
        return self._now() >= float(st.get("expires_at") or 0.0)

    def acquire(self) -> int:
        """Take (or renew) leadership.  Re-acquiring our own live lease
        keeps the epoch; taking over an absent/expired lease bumps it;
        a live foreign lease raises :class:`FencedEpochError`."""
        st = self.read()
        if st is not None and st.get("holder") == self.holder and not self.expired(st):
            self.epoch = int(st.get("epoch") or 0)
            self._write()
            return self.epoch
        if st is not None and not self.expired(st):
            raise FencedEpochError(
                f"lease {self.path} held by {st.get('holder')!r} "
                f"(epoch {st.get('epoch')}) until {st.get('expires_at')}"
            )
        self.epoch = (int(st.get("epoch") or 0) if st else 0) + 1
        self._write()
        return self.epoch

    def renew(self) -> None:
        """Extend our lease (rate-limited to ttl/3 rewrites).  A holder
        the file no longer names — or an epoch that moved past ours — is
        deposed and gets :class:`FencedEpochError`."""
        if self._now() - self._last_write_at < self.ttl_s / 3.0:
            return
        st = self.read()
        if (
            st is None
            or int(st.get("epoch") or 0) != self.epoch
            or st.get("holder") != self.holder
        ):
            raise FencedEpochError(
                f"lease {self.path} lost: now {st and st.get('holder')!r} "
                f"epoch {st and st.get('epoch')} (we held epoch {self.epoch})"
            )
        self._write()

    def check_fenced(self, epoch: int) -> None:
        """The write fence: raise if the lease file names a newer epoch
        than ``epoch`` (a standby took over — this writer is stale)."""
        st = self.read()
        if st is not None and int(st.get("epoch") or 0) > int(epoch):
            raise FencedEpochError(
                f"journal write fenced: lease epoch {st.get('epoch')} "
                f"(holder {st.get('holder')!r}) > writer epoch {epoch}"
            )

    def release(self) -> None:
        """Clean handoff: expire our own lease NOW (a standby's takeover
        no longer has to wait out the ttl).  No-op if already deposed."""
        st = self.read()
        if st is None or st.get("holder") != self.holder:
            return
        if int(st.get("epoch") or 0) != self.epoch:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        st["expires_at"] = self._now()
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(st, fh)
        os.replace(tmp, self.path)


# ---------------------------------------------------------------- framing
def frame_record(rec: Dict[str, Any]) -> bytes:
    """One journal line: crc32 (hex8, over the compact-json payload, no
    newline) + space + payload + newline."""
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True).encode()
    return b"%08x %s\n" % (zlib.crc32(payload) & 0xFFFFFFFF, payload)


def parse_frame(line: bytes) -> Optional[Dict[str, Any]]:
    """Parse one line back; None on ANY defect (short, bad crc, bad
    json) — the caller decides torn-vs-quarantined by position."""
    line = line.rstrip(b"\r\n")
    if len(line) < 10 or line[8:9] != b" ":
        return None
    crc_hex, payload = line[:8], line[9:]
    try:
        if int(crc_hex, 16) != zlib.crc32(payload) & 0xFFFFFFFF:
            return None
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def slim_outcome(out: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The journaled subset of a terminal outcome row — enough for the
    bit-identity contract (tokens) and the router's bookkeeping, without
    dragging arbitrary replica-side fields into the WAL."""
    if not out:
        return None
    return {
        k: out[k]
        for k in ("status", "tokens", "replays", "reason", "retry_after_s", "tag")
        if k in out
    }


# ---------------------------------------------------------------- reducer
# mirrors FleetLedger.counts exactly (fleet_ledger_check balances on the
# recovered ledger because recovery copies these verbatim)
LEDGER_COUNT_KEYS = (
    "submitted",
    "dispatched",
    "resubmitted",
    "redispatched",
    "failovers",
    "hedges",
    "completed",
    "shed",
    "timed_out",
    "preempted_requeue",
)


def empty_state() -> Dict[str, Any]:
    return {
        "epoch": 0,
        "tag_counter": 0,
        "counts": {k: 0 for k in LEDGER_COUNT_KEYS},
        "pending": {},  # rid(str) -> {req, deadline_wall, tags, live_on, ...}
        "resolved": {},  # rid(str) -> {status, replica, outcome, req, ...}
        "extras": {},  # snapshot-only: ring / breakers / autoscale / rollout
    }


def reduce_record(state: Dict[str, Any], rec: Dict[str, Any]) -> Dict[str, Any]:
    """Fold ONE journal record into the reduced state — the single
    source of replay semantics (the writer reduces as it appends, so a
    snapshot is this function's fixpoint by construction)."""
    k = rec.get("k")
    c = state["counts"]
    if k == "open":
        state["epoch"] = max(int(state.get("epoch") or 0), int(rec.get("e") or 0))
    elif k == "submit":
        rid = str(rec.get("rid"))
        if rid in state["resolved"] or rid in state["pending"]:
            c["resubmitted"] += 1
        c["submitted"] += 1
        state["resolved"].pop(rid, None)
        state["pending"][rid] = {
            "req": rec.get("req") or {},
            "deadline_wall": rec.get("deadline_wall"),
            "tags": {},
            "live_on": [],
            "attempts": [],
            "resubmissions": 0,
            "failovers": 0,
            "hedged": False,
        }
    elif k == "dispatch":
        rid = str(rec.get("rid"))
        kind = rec.get("kind") or "dispatch"
        tag = int(rec.get("tag") or 0)
        state["tag_counter"] = max(
            int(state.get("tag_counter") or 0), tag & TAG_COUNTER_MASK
        )
        c["dispatched"] += 1
        if kind != "dispatch":
            c["redispatched"] += 1
        if kind == "failover":
            c["failovers"] += 1
        elif kind == "hedge":
            c["hedges"] += 1
        p = state["pending"].get(rid)
        if p is not None:
            rep = str(rec.get("replica"))
            p["tags"][rep] = tag
            if rep not in p["live_on"]:
                p["live_on"].append(rep)
            p["attempts"].append(rep)
            if kind != "dispatch":
                p["resubmissions"] += 1
            if kind == "failover":
                p["failovers"] += 1
            elif kind == "hedge":
                p["hedged"] = True
    elif k == "drop":
        p = state["pending"].get(str(rec.get("rid")))
        if p is not None:
            rep = str(rec.get("replica"))
            if rep in p["live_on"]:
                p["live_on"].remove(rep)
    elif k == "terminal":
        rid = str(rec.get("rid"))
        status = rec.get("status")
        if status in c:
            c[status] += 1
        p = state["pending"].pop(rid, None)
        state["resolved"][rid] = {
            "status": status,
            "replica": rec.get("replica"),
            "outcome": rec.get("outcome"),
            "req": (p or {}).get("req"),
            "failovers": (p or {}).get("failovers", 0),
            "resubmissions": (p or {}).get("resubmissions", 0),
            "hedged": (p or {}).get("hedged", False),
        }
    # unknown kinds are skipped (forward compatibility: an older standby
    # tailing a newer leader's journal must not crash on new record kinds)
    return state


# ----------------------------------------------------------------- replay
def _segments(dirpath: str) -> List[str]:
    try:
        names = sorted(
            n for n in os.listdir(dirpath) if n.startswith("wal-") and n.endswith(".log")
        )
    except OSError:
        return []
    return [os.path.join(dirpath, n) for n in names]


def replay_dir(dirpath: str) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Replay every segment in order: snapshots REPLACE the state (they
    are the writer's reduced state verbatim), other records reduce onto
    it.  The last line of the last segment failing to parse is a **torn
    tail** (tolerated); any other bad line is **quarantined**."""
    state = empty_state()
    stats = {"records": 0, "snapshots": 0, "quarantined": 0, "torn": 0, "segments": 0}
    segs = _segments(dirpath)
    stats["segments"] = len(segs)
    for si, seg in enumerate(segs):
        try:
            with open(seg, "rb") as fh:
                data = fh.read()
        except OSError:
            continue
        lines = data.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        for li, line in enumerate(lines):
            if not line:
                continue
            rec = parse_frame(line)
            if rec is None:
                if si == len(segs) - 1 and li == len(lines) - 1:
                    stats["torn"] += 1  # a write died mid-record: tolerated
                else:
                    stats["quarantined"] += 1  # mid-file corruption: skipped
                continue
            stats["records"] += 1
            if rec.get("k") == "snapshot":
                snap = rec.get("state")
                if isinstance(snap, dict):
                    base = empty_state()
                    base.update(snap)
                    state = base
                    stats["snapshots"] += 1
            else:
                reduce_record(state, rec)
    return state, stats


# ---------------------------------------------------------------- journal
class FleetJournal:
    """The write-ahead log.  Opening replays what is already on disk
    (seeding the reduced state a recovered router rebuilds from) and
    appends to the newest segment.  Single-writer by design — the lease
    fence, not file locking, is what keeps two leaders from interleaving
    (the loser's flush raises before any bytes land)."""

    def __init__(
        self,
        dirpath: str,
        *,
        fsync: Optional[str] = None,
        rotate_bytes: Optional[int] = None,
        snapshot_every: Optional[int] = None,
        max_buffer: int = 512,
        lease: Optional[LeaderLease] = None,
    ):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.fsync_policy = (
            fsync if fsync is not None else _config.get_str("VESCALE_FLEET_JOURNAL_FSYNC")
        ) or "flush"
        if self.fsync_policy not in ("none", "flush", "always"):
            raise ValueError(f"unknown journal fsync policy {self.fsync_policy!r}")
        self.rotate_bytes = int(
            rotate_bytes
            if rotate_bytes is not None
            else _config.get_int("VESCALE_FLEET_JOURNAL_ROTATE_BYTES")
        )
        self.snapshot_every = int(
            snapshot_every
            if snapshot_every is not None
            else _config.get_int("VESCALE_FLEET_JOURNAL_SNAPSHOT_EVERY")
        )
        self.max_buffer = int(max_buffer)
        self.lease = lease
        self.writer_epoch = 0
        self._buf: List[Dict[str, Any]] = []
        self._since_snapshot = 0
        self.appends = 0
        self.flushes = 0
        self.snapshots_written = 0
        self.state, self.replay_stats = replay_dir(dirpath)
        self.last_epoch = int(self.state.get("epoch") or 0)
        segs = _segments(dirpath)
        if segs:
            self._seg_path = segs[-1]
            self._seg_index = int(os.path.basename(self._seg_path)[4:-4])
        else:
            self._seg_index = 1
            self._seg_path = os.path.join(dirpath, "wal-000001.log")
        self._fh = open(self._seg_path, "ab")

    # ----------------------------------------------------------- lifecycle
    def attach_lease(self, lease: Optional[LeaderLease]) -> None:
        self.lease = lease

    def begin_epoch(self, epoch: int) -> None:
        """Record a new leader generation (an ``open`` record, flushed):
        every epoch that ever wrote is recoverable from the journal even
        without a lease file."""
        self.writer_epoch = int(epoch)
        self.append("open", {"e": self.writer_epoch})
        self.flush()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._fh.close()

    # ------------------------------------------------------------- writing
    @property
    def buffered(self) -> int:
        return len(self._buf)

    def append(self, kind: str, data: Dict[str, Any]) -> None:
        """Buffered O(1) append: reduce + enqueue.  No IO here — flush()
        does the framing and the write (see the module docstring for the
        flush points the router guarantees)."""
        rec = {"k": kind}
        rec.update(data)
        reduce_record(self.state, rec)
        self._buf.append(rec)
        self.appends += 1
        self._since_snapshot += 1

    def flush(self) -> None:
        """Frame and write everything buffered.  The lease fence runs
        FIRST: a deposed writer raises with its records still buffered
        and nothing on disk (the dual-leader refusal)."""
        if not self._buf:
            return
        if self.lease is not None:
            self.lease.check_fenced(self.writer_epoch)
        lines = [frame_record(r) for r in self._buf]
        self._buf = []
        data = b"".join(lines)
        from ..resilience import faultsim as _fs

        if _fs.fires("journal_torn_write", ctx=self._seg_path):
            # crash-mid-write simulation: the LAST record's bytes stop
            # half way (no newline, no fsync) — exactly the torn tail
            # replay_dir tolerates.  The writer is left as a real torn
            # writer would be: whatever it writes next merges into the
            # broken line and quarantines (one record lost, counted).
            data = data[: len(data) - len(lines[-1]) + max(1, len(lines[-1]) // 2)]
            self._fh.write(data)
            self._fh.flush()
            self.flushes += 1
            return
        self._fh.write(data)
        if self.fsync_policy == "always":
            self._fh.flush()
            os.fsync(self._fh.fileno())
        elif self.fsync_policy == "flush":
            self._fh.flush()
        self.flushes += 1

    # ----------------------------------------------------------- snapshots
    def should_snapshot(self) -> bool:
        return self.snapshot_every > 0 and self._since_snapshot >= self.snapshot_every

    def write_snapshot(self, extras: Optional[Dict[str, Any]] = None) -> None:
        """Persist the compacted state (ledger reduction + extras).  If
        the active segment outgrew ``rotate_bytes`` the snapshot starts a
        FRESH segment first — the new segment replays standalone, so the
        old ones are pruned (rotation == compaction)."""
        if extras is not None:
            self.state["extras"] = extras
        self.flush()
        if self.rotate_bytes and self._size() > self.rotate_bytes:
            self._rotate()
        rec = {"k": "snapshot", "e": self.writer_epoch, "state": self.state}
        self._fh.write(frame_record(rec))
        if self.fsync_policy == "always":
            self._fh.flush()
            os.fsync(self._fh.fileno())
        elif self.fsync_policy == "flush":
            self._fh.flush()
        self.snapshots_written += 1
        self._since_snapshot = 0

    def _size(self) -> int:
        try:
            return self._fh.tell()
        except OSError:
            return 0

    def _rotate(self) -> None:
        self._fh.close()
        self._seg_index += 1
        self._seg_path = os.path.join(self.dir, f"wal-{self._seg_index:06d}.log")
        self._fh = open(self._seg_path, "ab")
        # prune: the snapshot about to land makes older segments dead
        # weight; keep one predecessor as a forensic margin
        segs = _segments(self.dir)
        for old in segs[:-2]:
            try:
                os.remove(old)
            except OSError:
                pass

    # ----------------------------------------------------------- reporting
    def stats(self) -> Dict[str, Any]:
        """The ``/fleet`` ``ha.journal`` block + the smoke's assertions."""
        return {
            "dir": self.dir,
            "epoch": self.writer_epoch,
            "fsync": self.fsync_policy,
            "segments": len(_segments(self.dir)),
            "appends": self.appends,
            "flushes": self.flushes,
            "buffered": len(self._buf),
            "snapshots": self.snapshots_written,
            "replayed_records": self.replay_stats["records"],
            "quarantined": self.replay_stats["quarantined"],
            "torn": self.replay_stats["torn"],
        }
