"""Fused ``adamw_lowmem`` moment update — every leaf in one launch.

``fused_adamw_update(gs, ms, vs, c1, c2, b1=, b2=, eps=)`` returns, for
lists of leaves, the update ``u`` (in g's dtype) and the new moments m', v'
(in the state dtype), per element in fp32 and in the order of the
reference chain (``vescale_tpu/parallel/optimizer.py::
scale_by_adam_lowmem``)::

    m' = b1 * m + (1 - b1) * g
    v' = b2 * v + (1 - b2) * g^2
    u  = (m' / c1) / (sqrt(v' / c2) + eps)

On CUDA tensors it launches ``csrc/fused_adamw.cu`` once over all leaves
(the port of ``vescale_tpu/kernels/fused_adamw.py::_adamw_kernel``, which
the TPU ran once per leaf); on CPU tensors it runs
:func:`fused_adamw_reference`, the same chain op by op.  ``c1`` and ``c2``
are the caller's fp32 bias corrections.  The moments come out bit for bit
equal to the chain; ``u`` within a few ulps where ``c1``/``c2`` were
rounded differently.  With ``inplace=True`` m' and v' are written into the
given m and v, which are returned: the kernel may alias them, since each
thread reads its elements of m and v before it writes the same elements,
so the optimizer keeps one generation of moments.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import LAUNCHES, _build, costed, require_hopper

__all__ = ["fused_adamw_update", "fused_adamw_reference"]

_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    *(ctypes.c_float,) * 7, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)
_CHUNK = 8192  # elements per CUDA block: 256 threads x 4 elements x 8 turns
_DTYPES = (torch.float32, torch.bfloat16)

Leaves = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as the reference's weak-typed scalars are."""
    return float(np.float32(x))


def fused_adamw_reference(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], c1: float, c2: float, *,
                          b1: float, b2: float, eps: float) -> Leaves:
    """Plain PyTorch: the reference chain per leaf, the same ops in the same
    order (``parallel/optimizer.py:529-533``).  c1 and c2 divide as 0-d
    tensors on the leaf's device: CUDA divides by a Python scalar as a
    multiplication by its reciprocal, which is not the reference's IEEE
    division."""
    us, mos, vos = [], [], []
    for g, m, v in zip(gs, ms, vs):
        t1, t2 = (torch.tensor(_f32(c), dtype=torch.float32, device=g.device) for c in (c1, c2))
        g32 = g.float()
        m32 = b1 * m.float() + (1.0 - b1) * g32
        v32 = b2 * v.float() + (1.0 - b2) * (g32 * g32)
        us.append(((m32 / t1) / (torch.sqrt(v32 / t2) + eps)).to(g.dtype))
        mos.append(m32.to(m.dtype))
        vos.append(v32.to(v.dtype))
    return us, mos, vos


def fused_adamw_cost(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor], *_, **__):
    """(flops, bytes) of one update: g read and u written in the grads'
    dtype, m and v read and written in the state's; fp32 arithmetic on the
    CUDA cores, 3 operations for m', 4 for v' and 5 for u an element."""
    gs, ms = list(gs), list(ms)
    if not gs:
        return 0, 0
    n = sum(g.numel() for g in gs)
    return 12 * n, n * (2 * gs[0].element_size() + 4 * ms[0].element_size())


@costed("fused_adamw", fused_adamw_cost)
def fused_adamw_update(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                       vs: Sequence[torch.Tensor], c1: float, c2: float, *,
                       b1: float, b2: float, eps: float, inplace: bool = False) -> Leaves:
    """(us, ms', vs') for lists of leaves; see the module docstring.  Every
    g must share one dtype, and every m and v another (fp32 or bf16).
    ``inplace``: ms' and vs' are ms and vs, updated."""
    gs, ms, vs = list(gs), list(ms), list(vs)
    if not (len(gs) == len(ms) == len(vs)):
        raise ValueError(f"fused_adamw: {len(gs)} grads, {len(ms)} m, {len(vs)} v")
    if not gs:
        return [], [], []
    if gs[0].device.type == "cpu":
        us, mos, vos = fused_adamw_reference(gs, ms, vs, c1, c2, b1=b1, b2=b2, eps=eps)
        if not inplace:
            return us, mos, vos
        for t, new in zip(ms + vs, mos + vos):
            t.copy_(new)
        return us, ms, vs
    require_hopper(gs[0])
    dev, g_dt, s_dt = gs[0].device, gs[0].dtype, ms[0].dtype
    if g_dt not in _DTYPES or s_dt not in _DTYPES:
        raise ValueError(f"fused_adamw: grad dtype {g_dt}, state dtype {s_dt}")
    us = [torch.empty_like(g) for g in gs]
    mos = ms if inplace else [torch.empty_like(m) for m in ms]
    vos = vs if inplace else [torch.empty_like(v) for v in vs]
    rows, block0 = [], 0
    for i, group in enumerate(zip(gs, ms, vs, us, mos, vos)):
        g, m, v = group[:3]
        if g.dtype != g_dt or m.dtype != s_dt or v.dtype != s_dt:
            raise ValueError(f"fused_adamw: leaf {i} dtypes {g.dtype}/{m.dtype}/{v.dtype}, "
                             f"expected {g_dt}/{s_dt}/{s_dt}")
        if m.shape != g.shape or v.shape != g.shape:
            raise ValueError(f"fused_adamw: leaf {i} shapes {tuple(g.shape)}/{tuple(m.shape)}/"
                             f"{tuple(v.shape)}")
        for t in group:
            if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"fused_adamw: leaf {i} must be contiguous on {dev}, "
                                 "16-byte aligned")
        n = g.numel()
        if n == 0:
            continue
        rows.append([t.data_ptr() for t in group] + [n, block0])
        block0 += -(-n // _CHUNK)
    if not rows:
        return us, mos, vos
    # one row of 8 int64 per leaf: the C side's Leaf record
    table = torch.tensor(np.asarray(rows, dtype=np.uint64).view(np.int64))
    table = table.pin_memory().to(dev, non_blocking=True)
    fn = _build.load("fused_adamw", "vtt_fused_adamw", _ARGTYPES)
    rc = fn(
        table.data_ptr(), len(rows), block0, _CHUNK, _f32(b1), _f32(1.0 - b1), _f32(b2),
        _f32(1.0 - b2), _f32(c1), _f32(c2), _f32(eps), int(g_dt == torch.bfloat16),
        int(s_dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_adamw launch failed: cudaError {rc}")
    LAUNCHES["fused_adamw"] += 1
    return us, mos, vos
