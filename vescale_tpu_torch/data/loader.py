"""TokenDataLoader — ctypes binding of the native prefetching loader.

The port of ``vescale_tpu/data/loader.py``'s core: a C++ mmap + prefetch-
thread loader (``data/native/dataloader.cpp``, the port's own copy of the
reference's source, same C ABI and version) keeps the host input path off
the card's step.  DP sharding: each dp rank draws a disjoint deterministic
stream, so batches differ across dp while runs reproduce exactly
(seed-stable SplitMix64).  On the same token file, seed, shape and dp
coordinates the batches equal the reference loader's bit for bit.  They
come out as int64 torch tensors on the caller's device (default: the
card).

  * ``state()`` / ``load_state()`` — the sample-exact resume contract:
    batches are a pure function of (seed, dp coords, batch index), so the
    position is one counter.  Restore fast-forwards via the native
    ``vdl_seek`` (O(1): skipped batches are never filled); rewinding
    reopens the file first (prefetch state cannot run backwards).
  * ``elastic=True`` keys every sample on its GLOBAL row index instead of
    the per-rank partition, making the global stream invariant to the
    (dp_world, per-rank batch) split; the state then carries a
    rank-invariant global cursor so a resume onto a different world size
    re-splits the position sample-exactly.

Not here yet: the reference wraps ``next()`` in its retry/backoff policy,
the faultsim ``loader_next`` hook, the ndtimeline ``DATA_LOAD`` span and
the ``data_load_seconds`` telemetry (``loader.py:174-219``); they come with
ROADMAP.md queue A, items 13 and 14.  Here ``next()`` calls the native
fetch directly, and ``elastic`` is an argument only (no env knob).

The shared library builds with ``g++`` at first use into ``data/build/``,
under a name that carries the ABI version, so it can never load the JAX
package's build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["TokenDataLoader", "build_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "dataloader.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_ABI_VERSION = 2  # must match dataloader.cpp vdl_abi_version()
# ABI-versioned name: dlopen dedups by pathname, so a stale library of an
# older C API under the same path would shadow a rebuild in this process
_SO = os.path.join(_BUILD_DIR, f"libvdl.abi{_ABI_VERSION}.so")
_BUILD_LOCK = threading.Lock()
_LIB = None


def build_native(force: bool = False) -> str:
    """Compile the native loader (``g++ -O3 -shared``) when the library is
    missing or older than its source; returns the library's path.  The
    build writes a temporary file and renames it, so concurrent processes
    never load half a library."""
    with _BUILD_LOCK:
        if force or not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC, "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _SO)
    return _SO


def _lib():
    global _LIB
    if _LIB is None:
        so = build_native()
        lib = ctypes.CDLL(so)
        if not hasattr(lib, "vdl_abi_version") or lib.vdl_abi_version() != _ABI_VERSION:
            raise RuntimeError(
                f"native loader {so} does not export ABI v{_ABI_VERSION}; "
                "remove it and restart (stale build artifact)"
            )
        lib.vdl_open.restype = ctypes.c_void_p
        lib.vdl_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.vdl_next.restype = ctypes.c_int
        lib.vdl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.vdl_num_tokens.restype = ctypes.c_int64
        lib.vdl_num_tokens.argtypes = [ctypes.c_void_p]
        lib.vdl_close.restype = None
        lib.vdl_close.argtypes = [ctypes.c_void_p]
        lib.vdl_seek.restype = ctypes.c_int
        lib.vdl_seek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        _LIB = lib
    return _LIB


class TokenDataLoader:
    """Batches of (input, target) next-token pairs from a binary token file
    (uint16 or int32/uint32 tokens, nanoGPT .bin convention).

        loader = TokenDataLoader("train.bin", batch=8, seq_len=1024, seed=1)
        batch = loader.next()   # {"input": (B, T) int64, "target": (B, T)}
    """

    def __init__(self, path: str, batch: int, seq_len: int, *, seed: int = 0, dp_rank: int = 0,
                 dp_world: int = 1, token_dtype=np.uint16, num_prefetch_threads: int = 2,
                 elastic: bool = False, device=None):
        token_bytes = np.dtype(token_dtype).itemsize
        if token_bytes not in (2, 4):
            raise ValueError("token dtype must be 2 or 4 bytes")
        self.device = resolve_device(device)
        self.batch, self.seq_len = batch, seq_len
        self.path = path
        self.seed, self.dp_rank, self.dp_world = int(seed), int(dp_rank), int(dp_world)
        self.elastic = bool(elastic)
        self._token_bytes = token_bytes
        self._nprefetch = num_prefetch_threads
        # the handle is kept on the instance: __del__ at interpreter shutdown
        # must not re-enter the build
        self._lib = _lib()
        self._batches_served = 0  # serve cursor, = next batch index
        self._close_lock = threading.Lock()
        self._h = self._open_native()

    def _open_native(self):
        h = self._lib.vdl_open(
            self.path.encode(), self._token_bytes, self.seq_len, self.batch, self.seed,
            self.dp_rank, self.dp_world, self._nprefetch, 1 if self.elastic else 0,
        )
        if not h:
            raise OSError(f"cannot open token file {self.path!r} (too small or unreadable)")
        return h

    @property
    def num_tokens(self) -> int:
        return int(self._lib.vdl_num_tokens(self._h))

    @property
    def batches_served(self) -> int:
        return self._batches_served

    def next(self) -> Dict[str, torch.Tensor]:
        """The next batch, ``{"input", "target"}`` (batch, seq_len) int64 on
        the loader's device."""
        if self._h is None:
            raise RuntimeError(f"TokenDataLoader({self.path!r}) is closed")
        x = np.empty((self.batch, self.seq_len), np.int32)
        y = np.empty((self.batch, self.seq_len), np.int32)
        rc = self._lib.vdl_next(self._h, x.ctypes.data_as(ctypes.c_void_p),
                                y.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"native loader failed: vdl_next rc={rc} "
                               f"(path={self.path!r}, batch_index={self._batches_served})")
        self._batches_served += 1
        return {k: torch.from_numpy(v).to(torch.int64).to(self.device)
                for k, v in (("input", x), ("target", y))}

    # --------------------------------------------------------- resume state
    def state(self) -> Dict[str, int]:
        """Checkpointable position: the batch counter plus the stream's
        identity coords (seed, dp coords, shape, mode); elastic mode adds the
        rank-invariant global cursor (``samples_served`` global rows,
        ``global_batch`` rows per global step)."""
        st = {
            "batches_served": int(self._batches_served),
            "seed": self.seed,
            "dp_rank": self.dp_rank,
            "dp_world": self.dp_world,
            "batch": int(self.batch),
            "seq_len": int(self.seq_len),
            "elastic": int(self.elastic),
        }
        if self.elastic:
            gb = int(self.batch) * int(self.dp_world)
            st["global_batch"] = gb
            st["samples_served"] = int(self._batches_served) * gb
        return st

    def load_state(self, state: Dict[str, int]) -> None:
        """Position the stream so the next ``next()`` returns batch
        ``state['batches_served']``: sample-exact resume, forward by the
        native seek, backward by reopening and seeking from zero.  The
        identity coords must match, except when both sides are elastic:
        then the split (dp_rank, dp_world, batch) may change and the
        position is re-derived from the global cursor, provided seed,
        seq_len and the global batch are kept."""
        resplit = (
            self.elastic
            and bool(state.get("elastic"))
            and "samples_served" in state
            and any(int(state.get(k, getattr(self, k))) != int(getattr(self, k))
                    for k in ("dp_rank", "dp_world", "batch"))
        )
        if resplit:
            for key in ("seed", "seq_len"):
                if key in state and int(state[key]) != int(getattr(self, key)):
                    raise ValueError(
                        f"loader state mismatch on {key!r}: checkpoint has {state[key]}, this "
                        f"loader has {getattr(self, key)} — resuming would silently change the "
                        "data stream")
            gb = int(self.batch) * int(self.dp_world)
            saved_gb = int(state.get("global_batch", -1))
            if saved_gb != gb:
                raise ValueError(
                    f"[VSC133] loader position cannot be re-split: checkpoint global batch is "
                    f"{saved_gb} rows, this run's is {gb} — an elastic resume must preserve "
                    "batch*dp_world (change the per-rank batch, not the global one)")
            target = int(state["samples_served"]) // gb
        else:
            for key in ("seed", "dp_rank", "dp_world", "batch", "seq_len", "elastic"):
                if key in state and int(state[key]) != int(getattr(self, key)):
                    raise ValueError(
                        f"loader state mismatch on {key!r}: checkpoint has {state[key]}, this "
                        f"loader has {int(getattr(self, key))} — resuming would silently change "
                        "the data stream"
                        + (" (enable elastic=True on BOTH runs to re-split across a world-size "
                           "change)" if key in ("dp_rank", "dp_world", "batch") else ""))
            target = int(state["batches_served"])
        if self._h is None:
            raise RuntimeError(f"TokenDataLoader({self.path!r}) is closed")
        if target < self._batches_served:
            # prefetch cannot run backwards: reopen, then seek forward
            with self._close_lock:
                h, self._h = self._h, None
            if h:
                self._lib.vdl_close(h)
            self._h = self._open_native()
            self._batches_served = 0
        if target > self._batches_served:
            rc = self._lib.vdl_seek(self._h, target)
            if rc != 0:
                raise RuntimeError(f"native loader seek to {target} failed: rc={rc} "
                                   f"(path={self.path!r})")
        self._batches_served = target

    def __iter__(self):
        while True:
            yield self.next()

    def close(self) -> None:
        # pop the handle under the lock so concurrent close() calls (or close
        # racing __del__) free it exactly once; getattr guards a __del__
        # after a failed __init__
        lock = getattr(self, "_close_lock", None)
        if lock is None:
            return
        with lock:
            h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.vdl_close(h)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
