"""vescale_tpu_torch.checkpoint: sharded save and load with online reshard.

The port of ``vescale_tpu/checkpoint/`` (reference
``legacy/vescale/checkpoint/__init__.py:16,35``)::

    checkpoint.save(path, {"model": params, "optimizer": state})
    state = checkpoint.load(path, {"model": template, "optimizer": template})

A checkpoint is ``meta.json`` (the ``"arrays"`` manifest and the writer's
world) plus one ``.npy`` file a chunk under ``data/<top>/<key>/<i>.npy``:
the same layout and, for the same values, the same bytes as the JAX
package writes, so either package reads what the other wrote.

Save: each leaf's chunks are its spec's boxes, deduped across replicas
(``planner.py``).  Across processes (``torch.distributed``), each process
writes the chunks it holds, spread round-robin over the processes that
hold each one; after a vote that every write landed, process 0 writes
``meta.json``, the commit marker, so a reader never sees a torn
checkpoint; a failed write on any process fails the save everywhere.  A
``DArray`` whose mesh has more ranks than the world has processes holds
pieces this world does not have, and its save raises.  ``save`` copies a
tensor on the card to the host before it returns, async save included.

Load: the template's leaves say the layout (their values are ignored);
each leaf reads only the saved chunks that intersect the piece this
process needs (``LAST_LOAD_STATS``: ``bytes_read``, ``files_read``,
``elastic``), so the template's layout may differ freely from the
writer's: mesh shape, world size, dense or ragged.  A ``DArray`` comes back
with the template's spec and rank, on its mesh's device; a tensor template
on its own device (a ``meta`` template: on ``device``, default the card);
a numpy or scalar template on the host.

Roots: a directory, ``mem://<name>`` (this process's memory) or
``memsvr://<server>/<prefix>`` (``mem_server.py``).

While telemetry is on (``telemetry.init``), save and load count into it
as the reference does: ``checkpoint_saves_total`` with
``checkpoint_save_seconds`` (an async save's is its submit time, the copy
to the host included), ``checkpoint_bytes_written_total`` (this process's
chunks), ``checkpoint_commits_total`` with ``checkpoint_commit_seconds``,
``checkpoint_loads_total`` with ``checkpoint_load_seconds`` and
``checkpoint_bytes_read_total``; an elastic load counts
``resilience_elastic_restores_total`` and ``resilience_reshard_seconds``,
and memtrack tags what a load returns as ``checkpoint_buffers``.  While
ndtimeline is active, ``save`` (an async save's submit), the commit and
``load`` are ``CHECKPOINT_SAVE``, ``CHECKPOINT_COMMIT`` and
``CHECKPOINT_LOAD`` spans, tagged as the reference tags them.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import distributed as _dist
from .. import telemetry as _tel
from ..darray import DArray, distribute_tensor
from ..device import resolve_device
from .elastic import ElasticMismatchError, preflight, writer_meta
from .planner import (
    SavePlanner,
    array_plan,
    fetch_chunk,
    flatten_state,
    normalize_darray,
    unflatten_state,
)
from .reshard import Box, box_of_rank, fill_box_from_chunks, plain_load_spec
from .storage import (
    AsyncWriter,
    FileSystemStorage,
    MemoryStorage,
    Storage,
    bytes_to_array,
    host_dtype,
)

__all__ = [
    "CheckpointHandle",
    "ElasticMismatchError",
    "FileSystemStorage",
    "LAST_LOAD_STATS",
    "MemoryStorage",
    "load",
    "read_writer_meta",
    "save",
]

_PLANNER = SavePlanner()
_MEM_STORES: Dict[str, Storage] = {}

# the I/O of this process's most recent load: bytes_read is the bytes of
# the chunks the template's pieces intersect, never the whole state
LAST_LOAD_STATS: Dict[str, int] = {"bytes_read": 0, "files_read": 0, "elastic": 0}


def _storage_for(path: str) -> Storage:
    if path.startswith("mem://"):
        return _MEM_STORES.setdefault(path, MemoryStorage())
    if path.startswith("memsvr://"):
        # memsvr://<server-name>/<checkpoint-prefix>
        from .mem_server import RemoteMemoryStorage

        name, _, prefix = path[len("memsvr://"):].partition("/")
        key = f"memsvr://{name}/{prefix}"
        if key not in _MEM_STORES:
            _MEM_STORES[key] = RemoteMemoryStorage(name, prefix)
        return _MEM_STORES[key]
    return FileSystemStorage(path)


class CheckpointHandle:
    """The handle of an async save.

    ``wait()`` drains the I/O workers, then runs the commit (the vote and
    ``meta.json``) on the calling thread: a collective from an I/O thread
    could interleave with the main thread's collectives.  A failed save
    records its exception in ``error`` (and says so on stderr); ``wait()``
    raises it, and the save is never committed."""

    def __init__(self, writer: AsyncWriter, commit=None):
        self._writer = writer
        self._commit = commit
        self._done = False
        self._cancelled = False
        # orders drain's cancellation against the async commit: once drain
        # holds the gate, no commit can start
        self._commit_gate = threading.Lock()
        self.error: Optional[BaseException] = None

    @property
    def failed(self) -> bool:
        return self.error is not None

    def drain(self) -> None:
        """Join every I/O worker of this save, even a failed one, without
        committing: a doomed save drained during a rollback or re-save
        (``manager.py``) must not write ``meta.json`` or fire ``on_commit``.
        Never raises: a failed save's error is already in ``error``."""
        with self._commit_gate:
            self._cancelled = True
        for stop in (lambda: self._writer.pool.shutdown(wait=True, cancel_futures=True),
                     self._writer.drain_native, self._writer.close_native):
            try:
                stop()
            except Exception:  # noqa: BLE001 — recorded in error already
                pass

    def wait(self) -> None:
        if self._done:
            if self.error is not None:
                raise self.error
            return
        # a local write failure must not skip the commit: across processes
        # the commit holds the vote, and a process that skips it leaves the
        # others blocked in the collective.  Record, vote False, raise.
        try:
            self._writer.shutdown()
        except BaseException as e:  # noqa: BLE001 — raised below
            if self.error is None:
                self.error = e
        if self._commit is not None:
            with self._commit_gate:
                if not self._cancelled:
                    try:
                        self._commit(ok=self.error is None)
                    except BaseException as e:  # noqa: BLE001 — raised below
                        if self.error is None:
                            self.error = e
        self._done = True
        if self.error is not None:
            raise self.error


def _writer_process(leaf, owner, chunk_idx: int, nproc: int) -> int:
    """Which process writes a chunk: one of the processes holding it,
    round-robin by chunk index (the reference's dedup_plans load balance);
    every process computes the same answer."""
    if nproc == 1:
        return 0
    if isinstance(leaf, DArray):
        ranks = owner if isinstance(owner, tuple) else (owner,)
        flat = leaf.mesh.ranks.reshape(-1)
        procs = sorted({int(flat[r]) for r in ranks})
        return procs[chunk_idx % len(procs)]
    return chunk_idx % nproc  # host and tensor leaves: round-robin


def _check_world(key: str, leaf, nproc: int) -> None:
    if isinstance(leaf, DArray) and leaf.mesh.size() > nproc:
        raise ValueError(
            f"checkpoint save of {key!r}: its mesh has {leaf.mesh.size()} ranks and this world "
            f"{nproc} process(es), each holding one piece; the other pieces are not here. Save "
            "from a world with a process for every rank of the mesh")


def save(
    path: str,
    checkpoint_state: Dict[str, Any],
    async_checkpoint: bool = False,
    num_io_workers: int = 4,
    on_commit=None,
) -> Optional[CheckpointHandle]:
    """Save a dict of state trees (reference ``checkpoint/__init__.py:16``).

    Leaves may be ``DArray``, ``torch.Tensor``, numpy arrays or Python
    scalars.  With ``async_checkpoint=True`` the writes go on in the
    background and the returned handle's ``wait()`` commits; across
    processes it MUST be waited, because the commit's vote runs on the
    calling thread.  ``on_commit`` runs right after ``meta.json`` lands."""
    from ..ndtimeline.api import ndtimeit
    from ..ndtimeline.predefined import CHECKPOINT_SAVE

    t0 = time.perf_counter()
    with ndtimeit(CHECKPOINT_SAVE, tags={"path": path, "async": async_checkpoint}):
        out = _save_impl(path, checkpoint_state, async_checkpoint, num_io_workers, on_commit)
    if _tel.is_active():
        # an async save's submit time: the I/O workers keep writing, and
        # the commit's time lands on checkpoint_commit_seconds
        _tel.count("checkpoint_saves_total")
        _tel.observe("checkpoint_save_seconds", time.perf_counter() - t0)
    return out


def _save_impl(path, checkpoint_state, async_checkpoint, num_io_workers, on_commit):
    storage = _storage_for(path)
    me, nproc = _dist.process_index(), _dist.process_count()
    flats = {}
    for top_key, tree in checkpoint_state.items():
        flat = flatten_state(tree)
        for key, leaf in flat:
            _check_world(f"{top_key}/{key}", leaf, nproc)
        # normalize DArrays once up front: the redistribute is collective,
        # so every process runs it once per leaf in the same order
        flats[top_key] = [(k, normalize_darray(l) if isinstance(l, DArray) else l) for k, l in flat]
    # the writer block: a load onto another world compares it with the
    # template's and reshards (VSC130) instead of failing in the chunk loop
    meta: Dict[str, Any] = {"arrays": {}, "writer": writer_meta(checkpoint_state)}
    writer = AsyncWriter(storage, num_io_workers)
    bytes_submitted = 0  # this process's share of the chunks
    try:
        for top_key, flat in flats.items():
            sig = _PLANNER.plan_signature(flat)
            plans = _PLANNER.lookup(sig)
            if plans is None:
                plans = [(key, *array_plan(leaf)) for key, leaf in flat]
                _PLANNER.store(sig, plans)
            for (key, shape, dtype, chunk_plan), (_k, leaf) in zip(plans, flat):
                full_key = f"{top_key}/{key}"
                entry = {"shape": list(shape), "dtype": dtype, "chunks": []}
                for i, (box, owner) in enumerate(chunk_plan):
                    fname = f"data/{full_key}/{i}.npy"
                    entry["chunks"].append({**box.to_json(), "file": fname})
                    if _writer_process(leaf, owner, i, nproc) == me:
                        data = fetch_chunk(leaf, box, owner)
                        bytes_submitted += data.nbytes
                        writer.submit(fname, data)
                meta["arrays"][full_key] = entry
    except BaseException as e:
        writer.pool.shutdown(wait=False)
        writer.close_native()
        if nproc > 1 and isinstance(e, Exception):
            # a local failure still votes, or the peers would wait in theirs
            _dist.all_processes_ok(False, f"ckpt_save:{path}")
        raise
    if _tel.is_active():
        _tel.count("checkpoint_bytes_written_total", bytes_submitted)

    def _commit(ok: bool = True) -> None:
        from ..ndtimeline.api import ndtimeit
        from ..ndtimeline.predefined import CHECKPOINT_COMMIT

        t0 = time.perf_counter()
        with ndtimeit(CHECKPOINT_COMMIT, tags={"path": path}):
            _commit_impl(ok)
        if _tel.is_active():
            _tel.count("checkpoint_commits_total")
            _tel.observe("checkpoint_commit_seconds", time.perf_counter() - t0)

    def _commit_impl(ok: bool) -> None:
        if nproc > 1:
            # the vote doubles as the pre-commit barrier: every process
            # enters it even after a local failure, so a failed save errors
            # everywhere instead of hanging the healthy processes
            if not _dist.all_processes_ok(ok, f"ckpt_save:{path}"):
                raise RuntimeError(f"checkpoint save {path}: a process reported a write "
                                   "failure; not committing")
        elif not ok:
            raise RuntimeError(f"checkpoint save {path}: write failure; not committing")
        meta_err: Optional[BaseException] = None
        if me == 0:
            try:
                storage.write_bytes("meta.json", json.dumps(meta).encode())
            except BaseException as e:  # noqa: BLE001 — voted on below
                if nproc == 1:
                    raise
                meta_err = e
        if nproc > 1:
            # a vote on the meta write: when save returns on any process the
            # marker is durable, and a failure on process 0 errors everywhere
            if not _dist.all_processes_ok(meta_err is None, f"ckpt_commit_done:{path}"):
                raise RuntimeError(f"checkpoint save {path}: meta.json commit-marker write "
                                   "failed on process 0; step is not committed") from meta_err
        if on_commit is not None:
            on_commit()

    if nproc == 1:
        # one process: no vote, so the commit can chase the data futures on
        # the I/O pool, and a fire-and-forget async save stays durable even
        # if nobody waits on it
        data_futures = list(writer.futures)
        handle = CheckpointHandle(writer)

        def _finalize():
            try:
                for f in data_futures:
                    f.result()
                writer.drain_native()  # meta.json may only chase durable chunks
                with handle._commit_gate:
                    if handle._cancelled:
                        return  # drained mid-flight: the save is doomed
                    _commit()
            except BaseException as e:  # noqa: BLE001 — surfaced, never swallowed
                handle.error = e
                print(f"[checkpoint] async save of {path} FAILED: {e!r}", file=sys.stderr)
            finally:
                # fire-and-forget callers never wait(): release the threads
                # (wait=False: a worker cannot join its own pool)
                writer.close_native()
                writer.pool.shutdown(wait=False)

        writer.futures = writer.futures + [writer.pool.submit(_finalize)]
    else:
        handle = CheckpointHandle(writer, _commit)
    if async_checkpoint:
        return handle
    handle.wait()
    return None


class _ChunkReader:
    """Caching, byte-counting chunk reader.  The cache is cleared after
    each leaf, so the host holds one leaf's chunks at a time; a file is
    read at most once a leaf."""

    def __init__(self, storage: Storage):
        self._storage = storage
        self._cache: Dict[str, np.ndarray] = {}
        self.bytes_read = 0
        self.files_read = 0

    def read(self, fname: str) -> np.ndarray:
        if fname not in self._cache:
            data = self._storage.read_bytes(fname)
            self.bytes_read += len(data)
            self.files_read += 1
            self._cache[fname] = bytes_to_array(data)
        return self._cache[fname]

    def next_leaf(self) -> None:
        self._cache.clear()


def _saved(entry):
    return [(Box.from_json(c), c["file"]) for c in entry["chunks"]]


def _fill(entry, reader: _ChunkReader, box: Box) -> np.ndarray:
    return fill_box_from_chunks(box, tuple(entry["shape"]), host_dtype(entry["dtype"]),
                                _saved(entry), reader.read)


def _full(entry, reader: _ChunkReader) -> np.ndarray:
    """The whole logical value (host leaves, and the Partial fallback)."""
    shape = tuple(entry["shape"])
    return _fill(entry, reader, Box((0,) * len(shape), shape))


def _tensor(arr: np.ndarray, entry, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array of the entry's dtype as a tensor of ``dtype`` on
    ``device``, in memory of its own (the array may be a read-only view of
    a chunk's bytes)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # read-only arrays
        t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
    if entry["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    out = t.to(device=device, dtype=dtype)
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def _check_shape(entry, shape) -> None:
    if tuple(entry["shape"]) != tuple(shape):
        raise ValueError(f"shape mismatch: saved {tuple(entry['shape'])} vs template "
                         f"{tuple(shape)} (resharding changes layout, not logical shape)")


def _load_piece(entry, reader: _ChunkReader, spec, rank: int) -> DArray:
    """``rank``'s piece of ``spec``, filled from the saved chunks that
    intersect it and nothing else."""
    dev = spec.mesh.device
    if spec.has_partial() or spec.layout().interleaves:
        mid = plain_load_spec(spec)
        if mid is not None and spec.mesh.is_live:
            # InterleavedShard: the plain Shard piece, then redistribute
            # (collective) into the template's layout
            return _load_piece(entry, reader, mid, rank).redistribute(placements=spec.placements)
        # Partial templates, and interleaves off a live mesh: whole value
        full = _tensor(_full(entry, reader), entry, spec.dtype, dev)
        return distribute_tensor(full, spec.mesh, spec.placements, rank=rank)
    data = _fill(entry, reader, box_of_rank(spec, rank))
    local = _tensor(data, entry, spec.dtype, dev)
    return DArray(local.reshape(spec.local_shape(spec.mesh.coordinate_of_rank(rank))), spec, rank)


def _load_leaf(entry, reader: _ChunkReader, leaf, device):
    if isinstance(leaf, DArray):
        _check_shape(entry, leaf.shape)
        return _load_piece(entry, reader, leaf.spec, leaf.rank)
    if isinstance(leaf, torch.Tensor):
        _check_shape(entry, leaf.shape)
        dev = resolve_device(device) if leaf.device.type == "meta" else leaf.device
        return _tensor(_full(entry, reader), entry, leaf.dtype, dev)
    # numpy and scalar templates: the host value in the saved dtype
    if entry["dtype"] == "bfloat16":
        raise TypeError(f"{entry['chunks'][0]['file']}: a bfloat16 leaf loads into a tensor "
                        "template (numpy has no bfloat16)")
    arr = np.array(_full(entry, reader))
    if np.isscalar(leaf) or (hasattr(leaf, "ndim") and leaf.ndim == 0):
        return arr.reshape(()).item() if not hasattr(leaf, "dtype") else arr.reshape(())
    return arr


def load(path: str, checkpoint_state: Dict[str, Any], strict: bool = True,
         device=None) -> Dict[str, Any]:
    """Load into the layout the template ``checkpoint_state`` describes
    (reference ``checkpoint/__init__.py:35``; the online reshard of its
    README.md:37-41).  Returns new trees of the template's structure.

    ``strict=False`` keeps the template's value for keys the checkpoint
    lacks (a state field added after the checkpoint was written); under
    ``strict=True`` a missing key raises ``KeyError``.  ``device`` is where
    the leaves of ``meta`` tensor templates land (default: the card)."""
    from ..ndtimeline.api import ndtimeit
    from ..ndtimeline.predefined import CHECKPOINT_LOAD
    from ..telemetry import memtrack as _memtrack

    t0 = time.perf_counter()
    with ndtimeit(CHECKPOINT_LOAD, tags={"path": path}):
        out = _load_impl(path, checkpoint_state, strict, device)
    elapsed = time.perf_counter() - t0
    if LAST_LOAD_STATS.get("elastic"):
        # a cross-world reshard on load (VSC130): the elastic restore's cost
        _tel.count("resilience_elastic_restores_total")
        _tel.observe("resilience_reshard_seconds", elapsed)
        _tel.set_gauge("resilience_last_reshard_seconds", elapsed)
    if _tel.is_active():
        _tel.count("checkpoint_loads_total")
        _tel.count("checkpoint_bytes_read_total", LAST_LOAD_STATS["bytes_read"])
        _tel.observe("checkpoint_load_seconds", elapsed)
    # loaded tensors are checkpoint buffers until the runtime claims them
    return _memtrack.tag_tree(out, "checkpoint_buffers")


def _load_impl(path, checkpoint_state, strict, device):
    storage = _storage_for(path)
    LAST_LOAD_STATS.update(bytes_read=0, files_read=0, elastic=0)
    meta = json.loads(storage.read_bytes("meta.json").decode())
    # before any chunk byte: logical shapes and the writer's world are
    # judged up front as coded VSC13x findings
    _report, elastic = preflight(meta, checkpoint_state, path)
    reader = _ChunkReader(storage)
    out: Dict[str, Any] = {}
    for top_key, tree in checkpoint_state.items():

        def one(key, leaf, top_key=top_key):
            full_key = f"{top_key}/{key}"
            if full_key not in meta["arrays"]:
                if not strict:
                    return leaf
                raise KeyError(f"checkpoint at {path} has no array {full_key}")
            try:
                return _load_leaf(meta["arrays"][full_key], reader, leaf, device)
            finally:
                reader.next_leaf()

        out[top_key] = unflatten_state(tree, one)
    LAST_LOAD_STATS.update(bytes_read=reader.bytes_read, files_read=reader.files_read,
                           elastic=int(elastic))
    return out


def read_writer_meta(path: str) -> Optional[Dict[str, Any]]:
    """The checkpoint's ``writer`` block from ``meta.json`` alone (no chunk
    is read); None for a checkpoint without one."""
    meta = json.loads(_storage_for(path).read_bytes("meta.json").decode())
    return meta.get("writer")


# the step-indexed manager imports save, load and CheckpointHandle from here
from .manager import CheckpointManager  # noqa: E402

__all__.append("CheckpointManager")
