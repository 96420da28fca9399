"""MFU of a Llama-family train step (reference ``examples/
open_llama_4d_benchmark/llama_mfu_calculator.py``): the same FLOP count a
token, against the card's bf16 peak, 989 TFLOP/s for an H100 SXM
(``bench.peak_bf16_flops`` reads the card's).

    python -m vescale_tpu_torch.examples.llama_mfu_calculator --tok-s-chip 12000
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

__all__ = ["llama_flops_per_token", "mfu", "H100_SXM_BF16", "main"]

# NVIDIA's H100 SXM data sheet: dense bf16 tensor-core FLOP/s
H100_SXM_BF16 = 989e12


def llama_flops_per_token(hidden: int, inter: int, layers: int, vocab: int, seq: int,
                          kv_heads_ratio: float = 1.0) -> float:
    """Train FLOPs a token: three times the forward's (PaLM's 6N plus the
    attention term), as the reference counts them."""
    attn_proj = 2 * hidden * hidden * (2 + 2 * kv_heads_ratio)  # q, o + k, v (GQA)
    mlp = 2 * hidden * inter * 3  # gate, up, down
    attn_scores = 2 * 2 * seq * hidden  # QK^T + PV a token
    per_layer = attn_proj + mlp + attn_scores
    head = 2 * hidden * vocab
    return 3.0 * (layers * per_layer + head)


def mfu(tokens_per_sec_per_chip: float, flops_per_token: float,
        peak_flops: float = H100_SXM_BF16) -> float:
    return tokens_per_sec_per_chip * flops_per_token / peak_flops


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--inter", type=int, default=11008)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--tok-s-chip", type=float, required=True)
    ap.add_argument("--peak", type=float, default=H100_SXM_BF16,
                    help="bf16 peak FLOP/s of the card (default: the H100 SXM's)")
    a = ap.parse_args(argv)
    f = llama_flops_per_token(a.hidden, a.inter, a.layers, a.vocab, a.seq)
    print(f"FLOPs/token: {f:.3e}  MFU: {mfu(a.tok_s_chip, f, a.peak):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
