"""The LM token pipeline: the reference's `data/loader.py` in numpy.

`ShardedBatcher` (hierarchical shuffling: examples static across pods,
re-dealt within a pod every epoch) and the seeded Markov-chain token
stream (`markov_batch`, `lm_token_batches`) are numpy, copied from the
reference without JAX, so both packages produce the same integers for
the same seeds: a restart at step s regenerates step s's batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class ShardedBatcher:
    """Deterministic, restartable batcher with hierarchical shuffling.

    State is (seed, step) only: restart from a checkpointed step is
    exact, and the schedule is a pure function, so a re-run at another
    lane count re-deals the same global order.
    """
    n: int
    global_batch: int
    pods: int = 1
    lanes: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.global_batch % (self.pods * self.lanes):
            raise ValueError("global_batch must divide by pods*lanes")
        self.per_pod = self.n // self.pods

    def epoch_order(self, epoch: int) -> np.ndarray:
        """(pods, per_pod) example ids: static across pods, shuffled
        within."""
        rng = np.random.default_rng((self.seed, epoch))
        base = np.arange(self.pods * self.per_pod).reshape(
            self.pods, self.per_pod)
        for p in range(self.pods):
            rng.shuffle(base[p])
        return base

    def batches(self, epoch: int) -> Iterator[np.ndarray]:
        """Yields (global_batch,) index arrays laid out pod-major, so a
        reshape to (pods, lanes, -1) matches the mesh layout."""
        order = self.epoch_order(epoch)
        per_pod_batch = self.global_batch // self.pods
        steps = self.per_pod // per_pod_batch
        for s in range(steps):
            cols = order[:, s * per_pod_batch:(s + 1) * per_pod_batch]
            yield cols.reshape(-1)


def markov_batch(vocab: int, batch: int, seq: int, *, table_seed: int = 0,
                 step: int = 0) -> dict:
    """One deterministic batch of a FIXED seeded order-1 Markov chain.

    The transition table depends only on table_seed (a stable structure
    to learn, so the LM loss decreases); the trajectories depend on
    (table_seed, step), so a restart at step s regenerates the identical
    batch.  Returns {"tokens", "labels"}, (batch, seq) int32 each, the
    labels the tokens shifted by one.
    """
    table_rng = np.random.default_rng(table_seed)
    succ = table_rng.integers(0, vocab, size=(vocab, 4))
    rng = np.random.default_rng((table_seed, step))
    out = np.empty((batch, seq + 1), dtype=np.int32)
    out[:, 0] = rng.integers(0, vocab, size=batch)
    for t in range(seq):
        pick = succ[out[:, t], rng.integers(0, 4, size=batch)]
        noise = rng.integers(0, vocab, size=batch)
        use_noise = rng.uniform(size=batch) < 0.1
        out[:, t + 1] = np.where(use_noise, noise, pick)
    return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def lm_token_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                     steps: Optional[int] = None):
    """Deterministic stream of `markov_batch`es, step 0, 1, ..."""
    step = 0
    while steps is None or step < steps:
        yield markov_batch(vocab, batch, seq, table_seed=seed, step=step)
        step += 1
