"""Deterministic synthetic corpus: an order-2 Markov chain over the vocab.

The same generator as the reference's ``data/pipeline.py`` (numpy's
``default_rng`` draws in the same order), so ``sample(batch, seq, seed)``
gives the same tokens byte for byte in both packages.  A miniature trained
on it has real weight/activation structure, which makes calibration
comparisons meaningful; at full width with random weights it is the
calibration and held-out data of the card's smoke run.
"""
from __future__ import annotations

import numpy as np


class MarkovCorpus:
    """Order-2 Markov language over ``vocab`` tokens.

    State (t-2, t-1) hashes to one of ``buckets`` buckets; each bucket has
    ``branching`` permitted successors drawn with a shared Zipf profile, and
    2% of tokens are uniform noise (the chain stays ergodic)."""

    def __init__(self, vocab: int, branching: int = 8, buckets: int = 4096,
                 zipf: float = 1.2, seed: int = 0):
        self.vocab = vocab
        self.branching = branching
        self.buckets = buckets
        rng = np.random.default_rng(seed)
        self.succ = rng.integers(0, vocab, size=(buckets, branching),
                                 dtype=np.int32)
        p = 1.0 / np.arange(1, branching + 1) ** zipf
        self.p = (p / p.sum()).astype(np.float64)
        self._h1 = np.int64(rng.integers(1, 1 << 30))
        self._h2 = np.int64(rng.integers(1, 1 << 30))

    def _bucket(self, t2: np.ndarray, t1: np.ndarray) -> np.ndarray:
        h = (t2.astype(np.int64) * self._h1 + t1.astype(np.int64) * self._h2)
        return (h % self.buckets).astype(np.int64)

    def sample(self, batch: int, seq_len: int, seed: int) -> np.ndarray:
        """(batch, seq_len) int32 tokens, a pure function of ``seed``."""
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq_len), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        out[:, 1] = rng.integers(0, self.vocab, batch)
        choice_idx = rng.choice(self.branching, size=(batch, seq_len),
                                p=self.p)
        noise = rng.random((batch, seq_len))
        rand_tok = rng.integers(0, self.vocab, (batch, seq_len))
        for t in range(2, seq_len):
            b = self._bucket(out[:, t - 2], out[:, t - 1])
            tok = self.succ[b, choice_idx[:, t]]
            out[:, t] = np.where(noise[:, t] < 0.02, rand_tok[:, t], tok)
        return out


def make_batch_fn(corpus, global_batch: int, seq_len: int,
                  rank: int = 0, num_ranks: int = 1, base_seed: int = 1234):
    """``batch(step) -> {"tokens": (global_batch // num_ranks, seq_len)}``,
    deterministic in (step, rank)."""
    if global_batch % num_ranks:
        raise ValueError(f"global_batch={global_batch} is not a multiple of "
                         f"num_ranks={num_ranks}")
    local = global_batch // num_ranks

    def batch(step: int) -> dict:
        seed = base_seed + step * 100003 + rank * 7919
        return {"tokens": corpus.sample(local, seq_len, seed)}

    return batch
