"""Seeded synthetic token batches for training cells: a frozen copy of the
port's ``data/pipeline.py`` generator (a Zipf-like unigram draw with a
fixed bigram grammar that 60% of positions follow, so the loss has
structure to learn), pure numpy on the host, as a trainer's input pipeline
runs.  Batch ``step`` of seed ``seed`` is the same in every run; every
batch's rows differ."""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq: int, batch: int, seed: int):
        self.vocab, self.seq, self.batch, self.seed = vocab, seq, batch, seed
        master = np.random.default_rng([seed, 0])
        ranks = np.arange(1, vocab + 1)
        logits = -1.1 * np.log(ranks) + 0.1 * master.standard_normal(vocab)
        self._probs = np.exp(logits)
        self._probs /= self._probs.sum()
        self._succ = master.permutation(vocab)      # the bigram grammar

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, 1, step])
        b, s = self.batch, self.seq
        draw = rng.choice(self.vocab, size=(b, s + 1), p=self._probs)
        follow = rng.random((b, s)) < 0.6
        for t in range(1, s + 1):
            draw[:, t] = np.where(follow[:, t - 1],
                                  self._succ[draw[:, t - 1]], draw[:, t])
        return {"tokens": draw[:, :-1].astype(np.int32),
                "labels": draw[:, 1:].astype(np.int32)}
