"""The benchmark's frozen yardstick: the card's peaks, the MFU formula and
the operations and bytes of each kernel's roofline.

Nothing here is read from the program: the counts are worked out from the
cell's shapes, so a later change to the program cannot move them.  The
MFU formula and the peaks are copies of the port's training bench
(``6 * P + 12 * L * T * E`` FLOPs a token, MoE over the active
parameters; 989 TFLOP/s dense bf16 for an H100 SXM, 756 for the PCIe
part).  A roofline's least time is the larger of FLOPs over the peak and
bytes over the HBM bandwidth, for the work these inputs need: real
lengths, no padding, causal work counted once, each input read once and
each output written once.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_PEAKS = (("PCIe", 756e12), ("H100", 989e12))  # by the device's name, first match


def peak_bf16_flops(device_name: str) -> Optional[float]:
    """Dense bf16 tensor-core peak of the named card; None for a card
    that is not an H100 (no CPU number is ever reported as a device
    metric)."""
    if "H100" not in device_name:
        return None
    for key, peak in BF16_PEAKS:
        if key in device_name:
            return peak
    return None


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


# ------------------------------------------------------------ training MFU
def mixtral_param_count(c: dict) -> Tuple[int, int]:
    """(all parameters, expert-product parameters) of a Mixtral
    configuration as the port lays it out: embedding and untied head,
    per layer two norms, q/k/v/o, the router, and per expert w_in,
    w_gate, w_out with the biases b_in and b_out."""
    d, f, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    H, KV, E = c["num_attention_heads"], c["num_key_value_heads"], c["num_local_experts"]
    hd = d // H
    attn = d * H * hd * 2 + d * KV * hd * 2
    expert = 3 * E * d * f
    per_layer = 2 * d + attn + d * E + expert + E * f + E * d
    return 2 * V * d + d + L * per_layer, L * expert


def mixtral_train_flops_per_token(c: dict, T: int) -> float:
    """The port bench's MoE formula: ``6 * active + 12 * L * T * d``, the
    active parameters being all but (1 - top_k / E) of the expert
    products."""
    total, expert = mixtral_param_count(c)
    active = total - expert + expert * c["num_experts_per_tok"] / c["num_local_experts"]
    return 6.0 * active + 12.0 * c["num_hidden_layers"] * T * c["hidden_size"]


# ------------------------------------------------------------ serving FLOPs
def llama_matmul_params(c: dict) -> int:
    """Parameters a token multiplies through: the projections of every
    layer and the head (the embedding is a lookup)."""
    d, f, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // H
    return L * (d * H * hd * 2 + d * KV * hd * 2 + 3 * d * f) + d * V


def llama_forward_flops(c: dict, positions: Iterable[int]) -> float:
    """Forward FLOPs of tokens at the given 0-based positions: 2 FLOPs a
    multiplied parameter, and attention's two products over the
    ``pos + 1`` positions each token sees (causal, counted once)."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    P = llama_matmul_params(c)
    n, seen = 0, 0
    for p in positions:
        n += 1
        seen += p + 1
    return 2.0 * P * n + 4.0 * L * d * seen


def prompt_flops(c: dict, n: int) -> float:
    """A prefill of ``n`` real prompt tokens."""
    return llama_forward_flops(c, range(n))


# -------------------------------------------------------- kernel rooflines
def flash_fwd_work(T: int, H: int, KV: int, hd: int, B: int = 1, elt: int = 2):
    """(FLOPs, bytes) of causal flash attention's forward over T tokens:
    QK^T and PV over the T (T + 1) / 2 visible pairs of each head; q, k,
    v read once, o written in ``elt`` bytes and the fp32 logsumexp."""
    pairs = T * (T + 1) / 2
    flops = 4.0 * B * H * hd * pairs
    nbytes = B * T * hd * (2 * H + 2 * KV) * elt + B * H * T * 4
    return flops, nbytes


def flash_bwd_work(T: int, H: int, KV: int, hd: int, B: int = 1, elt: int = 2):
    """(FLOPs, bytes) of its backward: the scores again, dV, dP, dQ and
    dK, five products over the visible pairs; q, k, v, o, dO and the
    logsumexp read, dQ, dK and dV written."""
    pairs = T * (T + 1) / 2
    flops = 10.0 * B * H * hd * pairs
    nbytes = (B * T * hd * (3 * H + 2 * KV) * elt + B * H * T * 4
              + B * T * hd * (H + 2 * KV) * elt)
    return flops, nbytes


def adamw_work(numel_by_dtype: Iterable[Tuple[int, int, int]]):
    """(FLOPs, bytes) of a whole AdamW step: for each group of (elements,
    parameter and gradient bytes an element, moment bytes an element) the
    gradient read, the parameter read and written, both moments read and
    written; 12 fp32 operations an element for the moments and the
    update's direction, 3 for weight decay, the learning rate and the
    apply."""
    flops = nbytes = 0
    for n, p, m in numel_by_dtype:
        flops += 15 * n
        nbytes += n * (3 * p + 4 * m)
    return float(flops), float(nbytes)


def paged_decode_work(attended: int, slots: int, H: int, KV: int, hd: int, layers: int,
                      kv_elt: int = 2, q_elt: int = 2):
    """(FLOPs, bytes) of decode attention over one step: ``attended`` is
    the sum over the active slots of the positions each reads (its length
    with the new token).  K and V of those positions read once, each
    slot's query read and its fp32 output written, in every layer."""
    flops = 4.0 * layers * H * hd * attended
    nbytes = layers * (2 * attended * KV * hd * kv_elt + slots * H * hd * (q_elt + 4))
    return flops, float(nbytes)
