"""Deterministic, checkpointable synthetic-token data pipeline.

A real deployment would stream tokenized shards; here the source is a
counter-seeded PRNG so that (a) every batch is reproducible from the
pipeline state alone, (b) restore(state) resumes the exact stream —
asserted in tests (fault-tolerance depends on it: after checkpoint
restart the data pipeline must not replay or skip batches).

Structured statistics (Zipfian token marginals + Markov repetition) make
the LM loss actually *descend* on this stream, so the end-to-end training
example shows learning, not noise.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineState:
    step: int
    seed: int


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, repeat_p: float = 0.3,
                 zipf_a: float = 1.3):
        self.vocab = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.repeat_p = repeat_p
        self.zipf_a = zipf_a
        self._step = 0
        # fixed Zipf marginal over the vocab
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._marginal = p / p.sum()

    @property
    def state(self) -> PipelineState:
        return PipelineState(self._step, self.seed)

    def restore(self, state: PipelineState) -> None:
        assert state.seed == self.seed, "pipeline seed mismatch"
        self._step = state.step

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.seed, step)))

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens (B,S+1) int32 -> inputs/labels split upstream)."""
        rng = self._rng(self._step)
        self._step += 1
        B, S = self.batch, self.seq_len + 1
        toks = rng.choice(self.vocab, size=(B, S), p=self._marginal)
        # Markov repetition: with prob repeat_p copy the previous token
        rep = rng.random((B, S)) < self.repeat_p
        for t in range(1, S):
            toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()
