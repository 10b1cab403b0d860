"""Data pipeline: a deterministic synthetic token stream for LM training.

Counterpart of `repro.training.data` (its LM half), copied: a seeded
Zipfian token sampler with a shifted-target layout, deterministic in
(seed, step), so a restarted job resumes exactly where it left off by
replaying from the step counter alone. Host numpy; batches are bitwise
the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2  # token-frequency skew (realistic rank-frequency)


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_a)
    return p / p.sum()


class TokenStream:
    """Deterministic batches: batch(step) is a pure function of config."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """{"tokens", "targets"}: int32 (global_batch, seq_len) on the host."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        # inverse-CDF sampling on the host
        u = rng.random((cfg.global_batch, cfg.seq_len + 1))
        cdf = np.cumsum(self._probs)
        toks = np.searchsorted(cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, cfg.vocab_size - 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
