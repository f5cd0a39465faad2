"""Deterministic, preemption-safe synthetic data pipeline.

Batches are a pure function of (seed, step): restart/elastic-resume lands on
exactly the token stream it would have seen, with no iterator state to
checkpoint and O(1) skip-ahead.  The stream mimics an LM mixture: Zipfian
token ids with document boundaries; labels are next-token with -100 padding
at document tails (exercises the masked-loss path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 512


class SyntheticLM:
    """data[step] → {"tokens": (B,S) int32, "labels": (B,S) int32}."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf CDF once (host): p(i) ∝ 1/(i+10)
        ranks = np.arange(cfg.vocab, dtype=np.float64) + 10.0
        p = 1.0 / ranks
        self._cdf = np.cumsum(p / p.sum())

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step]))
        u = rng.random((c.global_batch, c.seq_len))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, c.vocab - 1)
        # document boundaries: geometric lengths, boundary token 0
        labels = np.roll(toks, -1, axis=1).astype(np.int32)
        labels[:, -1] = -100
        n_bounds = max(1, c.seq_len // c.mean_doc_len)
        cuts = rng.integers(0, c.seq_len, size=(c.global_batch, n_bounds))
        for b in range(c.global_batch):
            labels[b, cuts[b]] = -100
        return {"tokens": toks, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
