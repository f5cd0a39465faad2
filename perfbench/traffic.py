"""The one traffic generator: closed-loop clients over a fixed set of
request sizes, read from a traffic file (``perfbench/traffic/*.json``).

A traffic file gives ``clients``, the size of the set (``sizes``) and a
lognormal for the prompt and for the output lengths (``median``,
``sigma``, clipped to ``min`` .. ``max``).  The set is the same for every
seed: its lengths are the lognormal's quantiles at (k + 0.5) / sizes.
The seed only orders it (prompts and outputs by independent
permutations) and draws the prompt ids, so two seeds do the same work
in another order.  Request ``i`` is the set's entry ``i % sizes``; its
ids are drawn from ``(seed, i)`` alone, uniform over the vocabulary, so
prompts share no prefix.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of a clipped lognormal."""
    z = [NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)]
    mu = math.log(dist["median"])
    out = np.rint(np.exp(mu + dist["sigma"] * np.asarray(z)))
    return np.clip(out, dist["min"], dist["max"]).astype(np.int64)


class Traffic:
    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.clients = int(spec["clients"])
        n = int(spec["sizes"])
        rng = np.random.default_rng([self.seed, 0])
        self.prompt_lens = quantile_lengths(spec["prompt"], n)[
            rng.permutation(n)]
        self.output_lens = quantile_lengths(spec["output"], n)[
            rng.permutation(n)]

    def ids(self, i: int, length: int, stream: int = 1) -> np.ndarray:
        """``length`` prompt ids of request ``i`` (``stream`` keeps the
        warm-up's draws apart from the traffic's)."""
        rng = np.random.default_rng([self.seed, stream, i])
        return rng.integers(0, self.vocab, size=length, dtype=np.int64)

    def request(self, i: int) -> tuple[np.ndarray, int]:
        """(prompt ids, output length) of request ``i``."""
        k = i % len(self.prompt_lens)
        return (self.ids(i, int(self.prompt_lens[k])),
                int(self.output_lens[k]))

    def prompt_blocks(self, block: int) -> list[int]:
        """Every prompt length the traffic can pad to, in ``block``-token
        steps: the shapes a monolithic prefill sees."""
        lo, hi = self.spec["prompt"]["min"], self.spec["prompt"]["max"]
        return [min(b, hi) for b in range(-(-lo // block) * block,
                                          hi + block, block)
                if b - block < hi]
