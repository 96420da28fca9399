"""ctypes binding of the native checkpoint chunk writer (``native/ckpt_io.cpp``).

The port of ``vescale_tpu/checkpoint/native_io.py``, with its own copy of
the C++ source.  A C++ thread pool does open/write/fsync/rename outside
the GIL.  ``g++`` builds it at first use into ``checkpoint/build/``, under
a name carrying the source's hash.  This is host I/O, not a device kernel:
as in the reference, ``NativeWritePool.get()`` returns None when no
toolchain can build it, and the Python pool writes instead.

``WRITES`` counts the chunks and bytes the native pool was handed, in
this process (``reset_writes`` sets them to 0): a caller checks with it
that the native pool did the writing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

__all__ = ["NativeWritePool", "WRITES", "build_native", "reset_writes"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "ckpt_io.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_BUILD_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False

WRITES: Dict[str, int] = {"files": 0, "bytes": 0}
_WRITES_LOCK = threading.Lock()


def reset_writes() -> None:
    with _WRITES_LOCK:
        WRITES.update(files=0, bytes=0)


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libvck_{digest}.so")


def build_native() -> str:
    """Compile the writer (``g++ -O3 -shared``) unless its library is built;
    returns the library's path.  The build writes a temporary file and
    renames it, so concurrent processes never load half a library."""
    so = _so_path()
    with _BUILD_LOCK:
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC, "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
    return so


def _lib():
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is None and not _LIB_FAILED:
            try:
                lib = ctypes.CDLL(build_native())
            except (OSError, subprocess.CalledProcessError):
                _LIB_FAILED = True
                return None
            lib.vck_create.restype = ctypes.c_void_p
            lib.vck_create.argtypes = [ctypes.c_int]
            lib.vck_submit.restype = ctypes.c_int
            lib.vck_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_uint64]
            lib.vck_drain.restype = ctypes.c_int
            lib.vck_drain.argtypes = [ctypes.c_void_p]
            lib.vck_destroy.restype = None
            lib.vck_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
        return _LIB


class NativeWritePool:
    """The native writer pool (its threads live in C++), one per
    ``AsyncWriter``: a shared pool would pool the failure count across
    concurrent saves, so one save's failed chunk could surface on another's
    drain while the first commits a torn checkpoint."""

    def __init__(self, lib, num_threads: int):
        self._lib = lib
        self._pool = lib.vck_create(num_threads)
        self._closed = False

    @classmethod
    def get(cls, num_threads: int = 4) -> Optional["NativeWritePool"]:
        lib = _lib()
        if lib is None:
            return None
        return cls(lib, num_threads)

    def submit(self, path: str, data: bytes) -> None:
        """Enqueue one atomic file write (the pool copies ``data``)."""
        rc = self._lib.vck_submit(self._pool, path.encode(), data, len(data))
        if rc != 0:
            raise IOError(f"native checkpoint writer rejected {path}")
        with _WRITES_LOCK:
            WRITES["files"] += 1
            WRITES["bytes"] += len(data)

    def drain(self) -> None:
        failures = self._lib.vck_drain(self._pool)
        if failures:
            raise IOError(f"native checkpoint writer: {failures} chunk write(s) failed")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.vck_destroy(self._pool)

    def __del__(self):  # backstop; close() is the real path
        try:
            self.close()
        except Exception:  # noqa: BLE001 — never raise from a finalizer
            pass
