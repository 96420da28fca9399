"""Block-scaled int8 quantization (``quant/blockscale.py``).

The fp8 matmul of the JAX package's ``quant/fp8.py`` is ROADMAP.md queue
A, item 17."""

from .blockscale import (
    DEFAULT_BLOCK,
    INT8_MAX,
    QuantizedBlocks,
    block_amax,
    dequantize_int8_blocks,
    pack_int8_payload,
    packed_nbytes,
    pow2_scale_from_amax,
    quantize_clip,
    quantize_int8_blocks,
    scale_from_amax,
    unpack_int8_payload,
)

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
