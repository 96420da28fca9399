"""The run's environment: where the program's build caches live, how old
the process is, and the check that nothing of JAX was loaded."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]  # the checkout
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout, ignored by git
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vescale_tpu")


def prepare() -> None:
    """Fix every build and kernel cache to a directory inside the
    checkout (the port's own nvcc outputs already land in
    ``vescale_tpu_torch/kernels/build``), keep ``transformers`` off JAX,
    and put the checkout first on the import path.  Call before torch is
    imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's start time
    (so the interpreter's own start and the imports count)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``vescale_tpu_torch`` is not ``vescale_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
