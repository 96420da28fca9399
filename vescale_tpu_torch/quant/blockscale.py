"""Block-scaled int8 quantization: the wire format of the quantized
gradient collectives.

The port of ``vescale_tpu/quant/blockscale.py`` in plain PyTorch (the
reference computes it in ``jnp``; no TPU kernel stands behind it).  The
flattened tensor is cut into blocks (default 64 elements,
``VESCALE_GRAD_COMPRESS_BLOCK``); each block gets its own scale from its
own amax, so one outlier costs only its block precision.

The scale is the smallest power of two >= ``amax / 127`` (the OCP
Microscaling rule), one E8M0 exponent byte a block on the wire.  ``q *
2^e`` is an exact fp32 exponent shift, so the dequantize multiply cannot
change a bit under FMA contraction, and the result is the reference's bit
for bit on every device.

Rounding: ``"nearest"`` (round-half-to-even, ``torch.round``) or
``"stochastic"`` (``floor(x/s + u)``, ``u`` uniform in [0, 1) from the
port's threefry, ``random.py``: the same key gives the reference's mask).

Non-finite contract: a block holding any non-finite element gets the
scale +inf (E8M0 byte 255) and dequantizes to NaN/Inf as a whole, so a
quantized reduction still trips ``found_inf``.  Its codes are those of a
NaN cast to int8 by XLA: zero.  ``validate=True`` raises on non-finite
input instead.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

__all__ = [
    "INT8_MAX",
    "DEFAULT_BLOCK",
    "scale_from_amax",
    "pow2_scale_from_amax",
    "quantize_clip",
    "block_amax",
    "QuantizedBlocks",
    "quantize_int8_blocks",
    "dequantize_int8_blocks",
    "packed_nbytes",
    "pack_int8_payload",
    "unpack_int8_payload",
]

INT8_MAX = 127.0
DEFAULT_BLOCK = 64


def scale_from_amax(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``qmax / amax``, the quantize scale that puts the largest observed
    value at the format's edge; a zero amax gives 1.0.  An IEEE division
    (a Python float over a tensor would take the reciprocal first)."""
    return torch.where(amax > 0.0, torch.full_like(amax, qmax) / amax, torch.ones_like(amax))


def quantize_clip(x: torch.Tensor, scale, dtype: torch.dtype, qmax: float) -> torch.Tensor:
    """Scale, saturate to ±qmax and cast (NaN casts to 0, as XLA does)."""
    q = torch.clamp(x.float() * scale, -qmax, qmax)
    if not dtype.is_floating_point:
        q = torch.nan_to_num(q, nan=0.0)
    return q.to(dtype)


def _to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1).float()
    n = flat.numel()
    nb = -(-n // block) if n else 1
    if nb * block != n:
        flat = torch.cat([flat, flat.new_zeros(nb * block - n)])
    return flat.view(nb, block)


def block_amax(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-block max |x| of the flattened input, fp32, shape
    ``(n_blocks,)`` (zero-padded tail); NaN propagates."""
    return _to_blocks(x, block).abs().amax(dim=1)


class QuantizedBlocks(NamedTuple):
    """int8 codes ``(n_blocks, block)`` (zero-padded tail) and per-block
    fp32 dequantize scales ``(n_blocks,)``, each exactly a power of two."""

    q: torch.Tensor
    scales: torch.Tensor


def pow2_scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """The smallest power of two >= ``amax / 127`` by bit manipulation (a
    ceil on the exponent field, clamped to the normal range); a zero amax
    takes 1.0's (``2^-6``) and a non-finite one +inf."""
    target = torch.where(amax > 0.0, amax, torch.ones_like(amax)).float()
    target = target * torch.tensor(1.0 / INT8_MAX, dtype=torch.float32, device=amax.device)
    bits = target.view(torch.int32)
    exp = torch.bitwise_and(torch.bitwise_right_shift(bits, 23), 0xFF)
    mant = torch.bitwise_and(bits, 0x7FFFFF)
    e = torch.clamp(exp + (mant != 0).to(torch.int32), 1, 254)
    e = torch.where(torch.isfinite(amax), e, torch.full_like(e, 255))
    return torch.bitwise_left_shift(e.to(torch.int32), 23).view(torch.float32)


def quantize_int8_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK, rounding: str = "nearest",
                         key=None, validate: bool = False) -> QuantizedBlocks:
    """``x`` as block-scaled int8.  With ``"nearest"``, ``|x -
    dequantize(quantize(x))| <= amax_block / 127`` elementwise; stochastic
    rounding doubles that bound and is unbiased.  ``key`` (a
    ``random.key``/``fold_in`` pair) seeds the stochastic draw."""
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"rounding must be 'nearest' or 'stochastic', got {rounding!r}")
    if rounding == "stochastic" and key is None:
        raise ValueError("stochastic rounding needs an explicit PRNG key")
    if validate and not bool(torch.isfinite(x).all()):
        raise ValueError("quantize_int8_blocks(validate=True): non-finite input")
    blocks = _to_blocks(x, block)
    amax = blocks.abs().amax(dim=1)
    scales = pow2_scale_from_amax(amax)
    v = blocks * (1.0 / scales)[:, None]  # exact: the reciprocal of 2^e
    if rounding == "nearest":
        q = torch.round(v)  # half to even
    else:
        from .. import random as _random

        u = _random.uniform(tuple(blocks.shape), torch.float32, key=key, device=blocks.device)
        q = torch.floor(v + u)
    q = torch.nan_to_num(torch.clamp(q, -INT8_MAX, INT8_MAX), nan=0.0)
    return QuantizedBlocks(q.to(torch.int8), scales)


def dequantize_int8_blocks(qb: QuantizedBlocks, shape: Sequence[int], dtype: torch.dtype,
                           acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` per block in ``acc_dtype``, trimmed to ``shape`` and
    cast to ``dtype``."""
    full = qb.q.to(acc_dtype) * qb.scales.to(acc_dtype)[:, None]
    n = 1
    for s in shape:
        n *= int(s)
    return full.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def packed_nbytes(n_elements: int, block: int = DEFAULT_BLOCK) -> int:
    """Bytes of the packed payload: one a (padded) element plus one E8M0
    byte a block."""
    nb = -(-max(1, n_elements) // block)
    return nb * block + nb


def pack_int8_payload(qb: QuantizedBlocks) -> torch.Tensor:
    """One flat int8 buffer ``[codes | E8M0 scale bytes]``: a quantized
    collective moves one array, its scales bound to their codes."""
    bits = qb.scales.contiguous().view(torch.int32)
    e = torch.bitwise_and(torch.bitwise_right_shift(bits, 23), 0xFF).to(torch.uint8)
    return torch.cat([qb.q.reshape(-1), e.view(torch.int8)])


def unpack_int8_payload(buf: torch.Tensor, n_blocks: int, block: int) -> QuantizedBlocks:
    q = buf[: n_blocks * block].reshape(n_blocks, block)
    e = buf[n_blocks * block:].contiguous().view(torch.uint8)
    scales = torch.bitwise_left_shift(e.to(torch.int32), 23).view(torch.float32)
    return QuantizedBlocks(q, scales)
