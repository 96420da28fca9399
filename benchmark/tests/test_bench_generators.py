"""The generators repeat exactly for a seed, and every seed of a serve mix
gets the same sizes."""

from collections import Counter
from itertools import islice

import numpy as np
import torch

from harness import traffic, weights
from tiny import SERVE_CELLS, serve_cell, train_cell

BIG_SEED = 2 ** 31 + 12345


def test_zipf_tokens_repeat_for_a_seed():
    a = traffic.ZipfTokens(32000, 1.2, traffic.rng(BIG_SEED, 1)).draw(10_000)
    b = traffic.ZipfTokens(32000, 1.2, traffic.rng(BIG_SEED, 1)).draw(10_000)
    c = traffic.ZipfTokens(32000, 1.2, traffic.rng(BIG_SEED + 1, 1)).draw(10_000)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 32000


def test_zipf_tokens_are_the_port_benchs_draw(tmp_path):
    # the frozen copy draws what the program's write_token_file writes
    from vescale_tpu_torch.bench import write_token_file

    path = write_token_file(str(tmp_path / "tokens.bin"), 5000, 32000, seed=BIG_SEED)
    want = np.fromfile(path, dtype=np.uint16).astype(np.int64)
    got = traffic.ZipfTokens(32000, 1.2, np.random.default_rng(BIG_SEED)).draw(5000)
    assert np.array_equal(got, want)


def _sizes(t, seed, count):
    return list(islice(traffic.request_sizes(t, seed), count))


def test_request_sizes_repeat_and_share_one_multiset():
    for name in SERVE_CELLS:
        t = serve_cell(name).traffic
        a = _sizes(t, BIG_SEED, 3 * t["block"])
        assert a == _sizes(t, BIG_SEED, 3 * t["block"])
        b = _sizes(t, BIG_SEED + 9, 3 * t["block"])
        assert a != b
        for i in range(3):  # every block holds the same sizes, in another order
            blk = slice(i * t["block"], (i + 1) * t["block"])
            assert Counter(a[blk]) == Counter(b[blk])


def test_request_sizes_follow_the_mix():
    from harness import spec

    t = spec.load_cell("mistral7b_serve_chat").traffic
    sizes = _sizes(t, 1, t["block"])
    prompts = sorted(p for p, _ in sizes)
    assert prompts[0] >= 32 and prompts[-1] <= 2048
    assert abs(prompts[len(prompts) // 2] - 256) < 30  # the median


def test_weights_repeat_for_a_seed_and_leaf():
    c = train_cell().config
    specs = weights.mixtral_specs(c)
    cpu = torch.device("cpu")
    a = weights.make_tree(specs, BIG_SEED, cpu)
    b = dict(weights.iter_leaves(specs, BIG_SEED, cpu))
    for path, leaf in weights.flat(a).items():
        assert torch.equal(leaf, b[path])
    i = [s[0] for s in specs].index("layers_1.block_sparse_moe.w_in")
    again = weights.make_leaf(specs[i], BIG_SEED, i, cpu)
    assert again.dtype == torch.bfloat16 and torch.equal(again, b["layers_1.block_sparse_moe.w_in"])
    other = weights.make_leaf(specs[i], BIG_SEED + 1, i, cpu)
    assert not torch.equal(again, other)
