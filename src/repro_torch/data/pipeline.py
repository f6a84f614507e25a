"""Deterministic, resumable, shardable synthetic-token data pipeline.

A copy of ``repro.data.pipeline`` (pure numpy; the port imports nothing of
``repro``).  Each host materializes only its shard of the global batch
(``host_index`` of ``host_count``), and batches are a pure function of
``(seed, step, host_index)``, so a restarted job resumes bit-identically
from the checkpointed step and the iterator carries no state beyond the
step counter.  The batches are the reference's, bit for bit.

The generator fabricates a Zipf-ish token stream with local bigram
structure so losses decrease measurably during short runs (a pure uniform
stream has irreducible loss = log V).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_image_tokens: int = 0
    d_image: int = 0
    d_frame: int = 0           # enc-dec: frame-embedding dim


def _zipf_logits(vocab: int, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, vocab + 1)
    base = -1.1 * np.log(ranks)
    return base + 0.1 * rng.standard_normal(vocab)


class SyntheticLM:
    """get_batch(step) → numpy batch dict; deterministic in (seed, step)."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        master = np.random.default_rng(cfg.seed)
        self._probs = np.exp(_zipf_logits(cfg.vocab_size, master))
        self._probs /= self._probs.sum()
        # a fixed bigram "grammar": token t prefers successor perm[t]
        self._succ = master.permutation(cfg.vocab_size)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step, self.host_index))
        b, s = self.local_batch, c.seq_len
        draw = rng.choice(c.vocab_size, size=(b, s + 1), p=self._probs)
        # 60% of positions follow the bigram grammar → learnable structure
        follow = rng.random((b, s)) < 0.6
        for t in range(1, s + 1):
            prev = draw[:, t - 1]
            draw[:, t] = np.where(follow[:, t - 1], self._succ[prev],
                                  draw[:, t])
        batch = {"tokens": draw[:, :-1].astype(np.int32),
                 "labels": draw[:, 1:].astype(np.int32)}
        if c.n_image_tokens:
            batch["images"] = rng.standard_normal(
                (b, c.n_image_tokens, c.d_image)).astype(np.float32)
        if c.d_frame:
            batch["frames"] = rng.standard_normal(
                (b, s, c.d_frame)).astype(np.float32)
        return batch

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.get_batch(step)
            step += 1
