"""Block-scaled int8 quantization (``quant/blockscale.py``) and the
delayed-scaling fp8 matmul (``quant/fp8.py``: the functional ``fp8_dot``
and flax's ``Fp8DirectDotGeneralOp``, the fp8 Llama's op)."""

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
from .fp8 import (
    Fp8DirectDotGeneralOp,
    Fp8DotState,
    Fp8TensorState,
    fp8_dot,
    fp8_state_grads,
    init_fp8_dot_state,
    merge_fp8_state,
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
    "Fp8TensorState",
    "Fp8DotState",
    "init_fp8_dot_state",
    "fp8_dot",
    "fp8_state_grads",
    "merge_fp8_state",
    "Fp8DirectDotGeneralOp",
]
