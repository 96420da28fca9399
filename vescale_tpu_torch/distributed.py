"""Process start-up and the cross-process control plane over
``torch.distributed``.

The port of ``vescale_tpu/distributed.py``: ``initialize`` /
``is_initialized`` (the default process group), ``hybrid_device_mesh``,
and the control plane ``allgather_ints``, ``all_processes_ok``,
``barrier`` and ``BarrierTimeout``.  The control plane moves small int64 vectors as CPU
tensors through gloo: the default process group when its backend is
gloo, else a gloo group made once over the same ranks (the first call is
then collective, as every call is anyway).  A process without a group, or
alone in it, gets its own row back.

``timeout_s`` (default ``VESCALE_BARRIER_TIMEOUT``; unset or <= 0 waits
forever) runs the collective on a helper thread and raises
``BarrierTimeout`` when it has not finished by the deadline.  A blocked
collective cannot be cancelled: it stays pending on the abandoned helper
thread, so after a ``BarrierTimeout`` the process must issue no further
collective and should abort (the watchdog's reaction), letting a
supervisor restart it.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import zlib
from datetime import timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import config

__all__ = [
    "BarrierTimeout",
    "all_processes_ok",
    "allgather_ints",
    "barrier",
    "hybrid_device_mesh",
    "initialize",
    "is_initialized",
    "process_count",
    "process_index",
]


class BarrierTimeout(RuntimeError):
    """A cross-process sync point did not complete within its deadline: a
    peer is hung or dead.  The collective is still pending on a leaked
    helper thread; issue no further collective."""

    def __init__(self, tag: str, elapsed_s: float, timeout_s: float):
        self.tag = tag
        self.elapsed_s = float(elapsed_s)
        self.timeout_s = float(timeout_s)
        super().__init__(
            f"barrier {tag!r} timed out after {elapsed_s:.1f}s "
            f"(timeout {timeout_s:g}s) — a peer process is hung or dead"
        )


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_count() -> int:
    return _world()


def process_index() -> int:
    return dist.get_rank() if _world() > 1 else 0


_GLOO = {}  # id of the default group -> (the default group, its gloo twin)


def _gloo_group():
    """The group CPU tensors travel on: the default one when it is gloo.
    The entry holds the default group, so its id is not reused."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if id(world) not in _GLOO:
        _GLOO[id(world)] = (world, dist.new_group(backend="gloo"))
    return _GLOO[id(world)][1]


def _resolve_timeout(timeout_s: Optional[float]) -> Optional[float]:
    """None -> ``VESCALE_BARRIER_TIMEOUT`` (unset: no timeout); <= 0 disables."""
    if timeout_s is None:
        timeout_s = config.get_float("VESCALE_BARRIER_TIMEOUT")
        if timeout_s is None:
            return None
    return timeout_s if timeout_s > 0 else None


class _SyncWorker:
    """One reusable daemon thread for timed collectives (a thread per call
    would put its start-up on every coordinated step).  After a timeout it
    is abandoned (``busy`` stays set) and the next call makes another."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self.busy = False
        threading.Thread(target=self._run, name="vescale-sync", daemon=True).start()

    def _run(self) -> None:
        while True:
            fn, box, done = self._q.get()
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — raised again on the caller
                box["error"] = e
            finally:
                self.busy = False
                done.set()

    def submit(self, fn: Callable):
        box: dict = {}
        done = threading.Event()
        self.busy = True
        self._q.put((fn, box, done))
        return box, done


_SYNC_WORKER: Optional[_SyncWorker] = None


def _sync_with_timeout(fn: Callable, tag: str, timeout_s: Optional[float]):
    global _SYNC_WORKER
    timeout_s = _resolve_timeout(timeout_s)
    if timeout_s is None:
        return fn()
    if _SYNC_WORKER is None or _SYNC_WORKER.busy:
        _SYNC_WORKER = _SyncWorker()  # first use, or the last one is wedged
    t0 = time.monotonic()
    box, done = _SYNC_WORKER.submit(fn)
    if not done.wait(timeout_s):
        from . import telemetry as _tel

        _tel.count("resilience_barrier_timeouts_total")
        raise BarrierTimeout(tag, time.monotonic() - t0, timeout_s)
    if "error" in box:
        raise box["error"]
    return box.get("value")


def barrier(tag: str = "vescale_barrier", timeout_s: Optional[float] = None) -> None:
    """Block until every process reaches this point; ``BarrierTimeout``
    past ``timeout_s``."""
    if _world() == 1:
        return
    group = _gloo_group()
    _sync_with_timeout(lambda: dist.barrier(group=group), tag, timeout_s)


def allgather_ints(values: Sequence[int], tag: str = "vescale_allgather",
                   timeout_s: Optional[float] = None) -> np.ndarray:
    """All-gather a small int64 vector from every process: an array of
    shape ``(process_count, len(values))`` whose row p came from rank p.
    Every rank must pass a vector of the same length."""
    row = np.asarray(list(values), np.int64).reshape(-1)
    world = _world()
    if world == 1:
        return row.reshape(1, -1)
    group = _gloo_group()

    def _gather() -> np.ndarray:
        mine = torch.from_numpy(row.copy())
        out = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(out, mine, group=group)
        return torch.stack(out).numpy()

    return _sync_with_timeout(_gather, tag, timeout_s).reshape(world, -1)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_device_ids: Optional[Sequence[int]] = None,
               *, device_type: str = "cuda", timeout_s: Optional[float] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the world (reference ``initialize``; upstream
    ``init_process_group``): the default process group of ``backend``
    (default NCCL for ``device_type="cuda"`` and gloo for ``"cpu"``;
    ``backend="gloo"`` with ``"cuda"`` lets several ranks share a card).  The group meets at
    ``tcp://<coordinator_address>`` (host:port) with ``num_processes`` and
    ``process_id``; without an address, at torch's ``env://`` rendezvous
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as
    ``torchrun`` sets them) when ``MASTER_ADDR`` is set, else in a world of
    one on a local store.  On the card this process takes
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else its rank modulo the
    host's cards.  A second call does nothing."""
    from .mesh import backend_of

    if is_initialized():
        return
    backend = backend_of(device_type) if backend is None else backend
    if backend not in ("nccl", "gloo") or (backend == "nccl" and device_type != "cuda"):
        raise ValueError(f"backend {backend!r} for device_type {device_type!r}")
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        kw.update(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                  rank=int(process_id))
    elif os.environ.get("MASTER_ADDR"):
        kw.update(init_method="env://")
    else:
        if num_processes not in (None, 1):
            raise ValueError(f"a world of {num_processes} processes needs coordinator_address "
                             "or the env:// variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: initialize(device_type='cuda') needs the card; "
                               "pass device_type='cpu' for gloo")
        if local_device_ids:
            local = local_device_ids[0]
        elif os.environ.get("LOCAL_RANK"):
            local = int(os.environ["LOCAL_RANK"])
        else:
            rank = kw.get("rank", int(os.environ.get("RANK", 0)))
            local = rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kw)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def all_processes_ok(ok: bool, tag: str = "vescale_ok", timeout_s: Optional[float] = None) -> bool:
    """Cross-process AND of a local success flag; doubles as a barrier.
    The tag travels with the vote, so two processes voting at differently
    tagged points raise instead of pairing their votes up; a peer that
    never votes raises ``BarrierTimeout`` past ``timeout_s``."""
    rows = allgather_ints([zlib.crc32(tag.encode("utf-8")), 1 if ok else 0], tag, timeout_s)
    if len(set(int(t) for t in rows[:, 0])) != 1:
        raise RuntimeError(f"all_processes_ok({tag!r}): processes voted at differently tagged points")
    return bool(rows[:, 1].all())


def hybrid_device_mesh(mesh_dim_names: Sequence[str], ici_shape: Sequence[int],
                       dcn_shape: Sequence[int], *, device_type: str = "cuda"):
    """A live mesh whose leading dims span hosts (``dcn_shape``) and
    trailing dims the cards of one host (``ici_shape``): ranks are laid out
    host-major, so the trailing dims' groups stay on NVLink and only the
    leading dims' traffic crosses hosts (the reference's DCN x ICI mesh).
    ``mesh_dim_names`` covers the dcn dims, then the ici dims."""
    from .mesh import init_device_mesh

    ici_shape = tuple(ici_shape)
    dcn_shape = tuple(dcn_shape)
    if len(mesh_dim_names) != len(ici_shape) + len(dcn_shape):
        raise ValueError(f"{len(mesh_dim_names)} names for {len(dcn_shape)}+{len(ici_shape)} dims")
    return init_device_mesh(device_type, dcn_shape + ici_shape, mesh_dim_names=tuple(mesh_dim_names))
