"""Checkpoint storage: filesystem and in-memory backends, the async writer,
and the chunk format.

The port of ``vescale_tpu/checkpoint/storage.py``.  A chunk is the bytes of
a ``.npy`` file (``np.lib.format``): the files the port writes are
byte-identical to the JAX package's for the same values.  bfloat16 has no
numpy dtype without ``ml_dtypes``, which the port does not use: its chunks
carry the header descr ``'<V2'``, as numpy writes an ``ml_dtypes`` bfloat16
array, then the raw 2-byte values; a reader takes them as ``int16`` on the
host and views them as ``torch.bfloat16``.  The manifest's ``"dtype"`` names
numpy's dtype names (``float32``, ``bfloat16``, ``int32``, ...): the names
of the torch dtypes in :data:`DTYPE_NAMES`.

A tensor on the card is copied to the host on the calling thread
(``array_to_bytes``: ``.cpu()`` is synchronous), so a caller may change it
as soon as ``save`` returns, async save included.
"""

from __future__ import annotations

import concurrent.futures as _fut
import io
import os
import threading
from typing import Dict, List, Union

import numpy as np
import torch

from .. import config
from ..resilience import faultsim as _fs
from ..resilience.retry import ckpt_policy

__all__ = [
    "AsyncWriter",
    "DTYPE_NAMES",
    "FileSystemStorage",
    "MemoryStorage",
    "Storage",
    "array_to_bytes",
    "bytes_to_array",
    "dtype_name",
    "host_dtype",
]

# the manifest's dtype names (numpy's) of the torch dtypes a chunk can hold
DTYPE_NAMES: Dict[torch.dtype, str] = {
    torch.float64: "float64",
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int64: "int64",
    torch.int32: "int32",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
}
_BF16_DESCR = "<V2"  # numpy's descr of an ml_dtypes bfloat16 array


def dtype_name(dtype) -> str:
    """The manifest name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in DTYPE_NAMES:
            raise TypeError(f"a checkpoint cannot hold {dtype}")
        return DTYPE_NAMES[dtype]
    return np.dtype(dtype).name


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype a chunk of manifest dtype ``name`` is assembled in on
    the host: ``int16`` bits for bfloat16, else numpy's own."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


class Storage:
    """The minimal storage interface (reference bfile)."""

    def write_bytes(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, name: str) -> bytes:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def list(self) -> List[str]:
        raise NotImplementedError


class FileSystemStorage(Storage):
    """Durable filesystem backend.  Reads and writes go through the retry
    policy (``VESCALE_CKPT_RETRIES``, ``VESCALE_IO_BACKOFF_*``:
    ``resilience/retry.py``) and the faultsim ``storage_write`` and
    ``storage_read`` hooks.  Chunk writes on the native pool (``AsyncWriter``)
    bypass this class: tests that inject write faults set
    ``VESCALE_NATIVE_CKPT_IO=0``; the commit marker (``meta.json``) always
    comes through here."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, name: str) -> str:
        p = os.path.join(self.root, name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def _write_once(self, name: str, data: bytes) -> None:
        # fsync before the rename and the parent directory after: the rename
        # is the commit point, and meta.json may only chase durable chunks
        _fs.check("storage_write", ctx=name)
        path = self._p(name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(os.path.dirname(path), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def write_bytes(self, name: str, data: bytes) -> None:
        ckpt_policy().call(self._write_once, name, data, description=name)

    def _read_once(self, name: str) -> bytes:
        _fs.check("storage_read", ctx=name)
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def read_bytes(self, name: str) -> bytes:
        return ckpt_policy().call(self._read_once, name, description=name)

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name))

    def list(self) -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                out.append(os.path.relpath(os.path.join(dirpath, fn), self.root))
        return out


class MemoryStorage(Storage):
    """In-process memory store (the reference's mem_server_lib without a
    transport); thread-safe."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def write_bytes(self, name: str, data: bytes) -> None:
        with self._lock:
            self._data[name] = bytes(data)

    def read_bytes(self, name: str) -> bytes:
        with self._lock:
            return self._data[name]

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._data

    def list(self) -> List[str]:
        with self._lock:
            return list(self._data)


def array_to_bytes(arr: Union[np.ndarray, torch.Tensor]) -> bytes:
    """The ``.npy`` bytes of a host array or a tensor on any device, as
    ``np.lib.format.write_array`` writes ``np.ascontiguousarray`` of the
    same values (a 0-d array goes out with shape ``(1,)``, as there)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dim() == 0:
            t = t.reshape(1)
        if t.dtype == torch.bfloat16:
            header = {"descr": _BF16_DESCR, "fortran_order": False, "shape": tuple(t.shape)}
            data = t.view(torch.int16).numpy()
        else:
            dtype_name(t.dtype)  # refuse what no manifest name covers
            data = t.numpy()
            header = np.lib.format.header_data_from_array_1_0(data)
    else:
        data = np.ascontiguousarray(arr)
        if data.dtype.hasobject:
            raise TypeError("a checkpoint chunk cannot hold Python objects")
        header = np.lib.format.header_data_from_array_1_0(data)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, header)
    return b"".join((buf.getvalue(), memoryview(data).cast("B")))


def bytes_to_array(data: bytes) -> np.ndarray:
    """A read-only array over a chunk's bytes (no copy).  bfloat16 chunks
    come back as 2-byte voids; ``host_dtype`` views them."""
    f = io.BytesIO(data)
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    else:
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    if dtype.hasobject:
        raise ValueError("a checkpoint chunk cannot hold Python objects")
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=f.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


class AsyncWriter:
    """Thread-pool chunk writer (the reference's async io workers).
    ``submit`` serializes on the calling thread and enqueues the write;
    ``wait`` drains.

    Filesystem chunk writes go to the native C++ pool when ``g++`` can
    build it (``native_io.py``: open/write/fsync/rename outside the GIL);
    ``VESCALE_NATIVE_CKPT_IO=0`` forces the Python pool."""

    def __init__(self, storage: Storage, num_workers: int = 4):
        self.storage = storage
        # >= 2 workers: the commit task blocks one while it waits on the
        # data writes, which need another
        self.pool = _fut.ThreadPoolExecutor(max_workers=max(2, num_workers))
        self.futures: List[_fut.Future] = []
        self._native = None
        if isinstance(storage, FileSystemStorage) and config.get_bool("VESCALE_NATIVE_CKPT_IO"):
            from .native_io import NativeWritePool

            self._native = NativeWritePool.get(num_workers)

    def submit(self, name: str, arr) -> None:
        """Serialize ``arr`` here (the device-to-host copy included) and
        enqueue its write."""
        data = array_to_bytes(arr)
        if self._native is not None:
            # the C++ writer makes parent directories itself
            self._native.submit(os.path.join(self.storage.root, name), data)
        else:
            self.futures.append(self.pool.submit(self.storage.write_bytes, name, data))

    def drain_native(self) -> None:
        """Block until every native chunk write is durable (no-op without the
        native pool).  Must run before any commit marker is written."""
        if self._native is not None:
            self._native.drain()

    def close_native(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None

    def wait(self) -> None:
        for f in self.futures:
            f.result()
        self.futures.clear()
        self.drain_native()

    def shutdown(self) -> None:
        self.wait()
        self.pool.shutdown()
        self.close_native()
