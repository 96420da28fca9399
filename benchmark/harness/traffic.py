"""The benchmark's generators: token ids and request sizes from a seed.

``zipf_tokens`` is a frozen copy of the port bench's ``write_token_file``
draw: Zipf(a) ranks folded below the vocab, mapped through a seeded
permutation of the vocab, from ``numpy.random.default_rng``.

``request_sizes`` gives a serve mix its (prompt, output) lengths.  Every
seed gets the same multiset of sizes: the lengths are the quantiles of
the mix's distribution at ``block`` evenly spaced levels, prompt and
output quantiles paired by a fixed permutation, and a seed only shuffles
the order within each block of ``block`` requests.  So any run that
serves whole blocks did the same work, and the seed changes the order
and the token ids only.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

SEED_MOD = 1 << 64


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one purpose (``stream``) of a run's seed."""
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


class ZipfTokens:
    """Token ids below ``vocab``: Zipf(``a``) ranks through a seeded
    permutation of the vocab.  The first draw is ``write_token_file``'s
    exactly (the ranks, then the permutation, from one generator); later
    draws take further ranks through the same permutation."""

    def __init__(self, vocab: int, a: float, gen: np.random.Generator):
        self.vocab, self.a, self.gen = vocab, a, gen
        self.perm = None

    def draw(self, n: int) -> np.ndarray:
        ranks = (self.gen.zipf(self.a, n) - 1) % self.vocab
        if self.perm is None:
            self.perm = self.gen.permutation(self.vocab).astype(np.int64)
        return self.perm[ranks]


def _quantiles(spec: Dict, n: int) -> List[int]:
    """``n`` lengths at the levels (i + 0.5) / n of the spec's
    distribution, clipped: ``lognormal`` (``median``, ``sigma``) or
    ``uniform`` (``min``, ``max``)."""
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            z = NormalDist().inv_cdf(u)
            x = spec["median"] * math.exp(spec["sigma"] * z)
        elif spec["dist"] == "uniform":
            x = spec["min"] + u * (spec["max"] - spec["min"])
        else:
            raise ValueError(f"length distribution {spec['dist']!r}")
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    return out


def request_sizes(traffic: Dict, seed: int) -> Iterator[Tuple[int, int]]:
    """The mix's (prompt, output) lengths for ``seed``, block after block
    without end: draw one as each request goes out."""
    block = int(traffic["block"])
    prompts = _quantiles(traffic["prompt_len"], block)
    outputs = _quantiles(traffic["output_len"], block)
    pairing = np.random.default_rng(0).permutation(block)  # fixed for every seed
    pairs = [(prompts[i], outputs[int(pairing[i])]) for i in range(block)]
    gen = rng(seed, 2)
    while True:
        for j in gen.permutation(block):
            yield pairs[int(j)]
