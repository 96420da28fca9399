"""Cross-process control plane: ``allgather_ints``, ``barrier`` and
``BarrierTimeout`` over ``torch.distributed``.

The port of the three calls of ``vescale_tpu/distributed.py`` that the
serve loop's coordination uses.  They move small int64 vectors as CPU
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

import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["BarrierTimeout", "allgather_ints", "barrier", "process_count", "process_index"]


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


_GLOO = {}  # id of the default group -> its gloo twin


def _gloo_group():
    """The group CPU tensors travel on: the default one when it is gloo."""
    if dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _GLOO:
        _GLOO[key] = dist.new_group(backend="gloo")
    return _GLOO[key]


def _resolve_timeout(timeout_s: Optional[float]) -> Optional[float]:
    """None -> ``VESCALE_BARRIER_TIMEOUT`` (unset: no timeout); <= 0 disables."""
    if timeout_s is None:
        from .serve import config as _config

        timeout_s = _config.get_float("VESCALE_BARRIER_TIMEOUT")
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
