"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), with the common flags plus its own (``EXTRA_FLAGS``:
``fused_adamw`` turns off FMA contraction).  Libraries land in
``kernels/build/`` under a name that carries the hash of the source, of
every shared header ``csrc/*.cuh`` and of its flags, so an edited source,
header or flag rebuilds and an unchanged one is reused.  Nothing here runs at import: the first
kernel call builds what it needs, or :func:`build` builds everything up
front, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

__all__ = ["SOURCES", "EXTRA_FLAGS", "BUILD_DIR", "build", "load", "nvcc_path"]

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "paged_decode": "paged_decode.cu",
    "paged_decode_pad": "paged_decode_pad.cu",
    "flash_bwd": "flash_bwd.cu",
    "fused_adamw": "fused_adamw.cu",
    "cross_entropy": "cross_entropy.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the moments must match the reference chain bit for bit: no mul+add -> FMA
EXTRA_FLAGS = {"fused_adamw": ("--fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else the toolkit's
    default install prefix; raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every stale library among ``names`` (default: all), one
    ``nvcc`` per source, all running at once.  Returns the seconds each
    compile took (absent when the library was current).  The compiler's
    output, with ``ptxas``'s register and spill report, is kept in
    ``build/<name>.log``.  Raises with that output when a compile fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = BUILD_DIR / f"{name}.log"
        log = open(log_path, "w")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, log, log_path, tmp, out, time.perf_counter())
    seconds: Dict[str, float] = {}
    failures = []
    for name, (proc, log, log_path, tmp, out, t0) in running.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failures.append(f"nvcc failed for {name} (exit {rc}):\n{log_path.read_text()}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name``, built on
    first use, with its argument and return types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
