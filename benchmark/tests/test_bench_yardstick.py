"""The frozen counts against hand counts at small shapes."""

import itertools

import pytest
import torch

from harness import yardstick as Y
from tiny import train_cell


def test_peaks_by_name():
    assert Y.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert Y.peak_bf16_flops("NVIDIA H100 PCIe") == 756e12
    assert Y.peak_bf16_flops("cpu") is None


def test_least_seconds_takes_the_larger_bound():
    assert Y.least_seconds(989e12, 1.0, 989e12) == pytest.approx(1.0)
    assert Y.least_seconds(1.0, 3.35e12, 989e12) == pytest.approx(1.0)


def test_flash_forward_counts_by_hand():
    # T = 3: the visible (query, key) pairs are 1 + 2 + 3 = 6; each pair is
    # a dot of hd for the scores and hd multiply-adds for PV: 4 hd FLOPs
    T, H, KV, hd = 3, 2, 1, 4
    pairs = sum(1 for q, k in itertools.product(range(T), range(T)) if k <= q)
    flops, nbytes = Y.flash_fwd_work(T, H, KV, hd)
    assert flops == 4 * hd * H * pairs
    # q, o: T H hd; k, v: T KV hd, 2 bytes each; lse: H T fp32
    assert nbytes == 2 * (T * H * hd * 2 + T * KV * hd * 2) + 4 * H * T
    bflops, bbytes = Y.flash_bwd_work(T, H, KV, hd)
    assert bflops == 10 * hd * H * pairs  # five products
    # read q, k, v, o, dO and lse; write dq, dk, dv
    assert bbytes == 2 * (3 * T * H * hd + 2 * T * KV * hd) + 4 * H * T + 2 * (T * H * hd + 2 * T * KV * hd)


def test_adamw_counts_by_hand():
    flops, nbytes = Y.adamw_work([(10, 2, 2), (5, 4, 4)])
    assert flops == 15 * 15
    # gradient read, parameter read and written, both moments read and written
    assert nbytes == 10 * (2 + 2 * 2 + 4 * 2) + 5 * (4 + 2 * 4 + 4 * 4)


def test_paged_decode_counts_by_hand():
    # two slots of lengths 3 and 5 with the new token: 8 positions read
    flops, nbytes = Y.paged_decode_work(8, 2, 4, 2, 8, 3)
    assert flops == 3 * 4 * 4 * 8 * 8
    assert nbytes == 3 * (2 * 8 * 2 * 8 * 2 + 2 * 4 * 8 * (2 + 4))


def test_llama_forward_flops_by_hand():
    c = {"hidden_size": 8, "intermediate_size": 16, "vocab_size": 10, "num_hidden_layers": 2,
         "num_attention_heads": 2, "num_key_value_heads": 1}
    # per layer q 8x8, k 8x4, v 8x4, o 8x8, mlp 3 x 8x16; the head 8x10
    P = 2 * (64 + 32 + 32 + 64 + 3 * 128) + 80
    assert Y.llama_matmul_params(c) == P
    # positions 0, 1, 2 see 1 + 2 + 3 keys; 4 d FLOPs a (query, key) pair a layer
    assert Y.llama_forward_flops(c, range(3)) == 2 * P * 3 + 4 * 2 * 8 * 6
    assert Y.prompt_flops(c, 3) == Y.llama_forward_flops(c, [0, 1, 2])


def test_mixtral_counts_match_the_model():
    from harness.kinds.train_steps import model_config
    from vescale_tpu_torch.models import Mixtral

    c = train_cell().config
    model = Mixtral(model_config(c), device=torch.device("cpu"))
    total, expert = Y.mixtral_param_count(c)
    assert total == sum(p.numel() for p in model.parameters())
    L, E, d, f = (c[k] for k in ("num_hidden_layers", "num_local_experts", "hidden_size",
                                 "intermediate_size"))
    assert expert == L * 3 * E * d * f
    active = total - expert + expert * 2 / E
    assert Y.mixtral_train_flops_per_token(c, 64) == 6 * active + 12 * L * 64 * d


def test_mixtral_8x7b_at_4_layers_holds_6_07_billion():
    from harness import spec

    total, expert = Y.mixtral_param_count(spec.load_cell("mixtral8x7b-l4_train_s4096").config)
    assert 6.06e9 < total < 6.08e9 and 5.63e9 < expert < 5.65e9
