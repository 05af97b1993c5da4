"""Deterministic token data pipeline.

The port's copy of the reference package's ``training/data.py``: numpy
only, so a batch is bitwise the reference's for the same arguments.

Two sources:
  * ``SyntheticLM`` — seeded on (seed, step, host) so every restart replays
    the identical stream (checkpoint stores only the step counter) and every
    DP shard draws disjoint substreams: elastic restarts with a different
    device count still see a deterministic, non-overlapping assignment.
  * ``MemmapCorpus`` — flat uint16/uint32 token file (np.memmap), sliced into
    (batch, seq) windows by a strided, shuffled index — the standard
    production layout (tokens are pre-tokenised offline).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "MemmapCorpus"]


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """Batch for a global step (pure function of (seed, step))."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Markov-ish stream: mixture of a random walk and uniform draws so
        # the loss is learnable (tests assert loss decreases).
        base = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1))
        walk = np.cumsum(rng.integers(0, 3, size=(self.batch, self.seq + 1)),
                         axis=1) % self.vocab
        pick = rng.random((self.batch, self.seq + 1)) < 0.7
        toks = np.where(pick, walk, base).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class MemmapCorpus:
    path: str
    vocab: int
    batch: int
    seq: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        n_windows = (len(self._data) - 1) // self.seq
        rng = np.random.default_rng(self.seed)
        self._order = rng.permutation(n_windows)

    def batch_at(self, step: int) -> dict:
        n = len(self._order)
        idx = [self._order[(step * self.batch + i) % n]
               for i in range(self.batch)]
        toks = np.stack([
            np.asarray(self._data[j * self.seq: j * self.seq + self.seq + 1],
                       dtype=np.int64)
            for j in idx])
        toks = (toks % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
