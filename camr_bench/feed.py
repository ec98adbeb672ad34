"""The token feed: the one generator that every traffic file drives.

A traffic file (``traffic/<name>.json``) gives ``seqs_per_subfile``
sequences of ``seq_len`` tokens in each subfile a map task trains on;
the steps run in a closed loop (one trainer; the next step starts when
the last has ended). :class:`TokenFeed` has the interface the trainer
reads its data through (``batch(step, shard)``): batch ``i`` is drawn from
``(seed, i)`` alone, uniform over the published vocabulary, so every
subfile of every step holds different rows and the same seed gives the
same inputs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenFeed", "seed_words"]


def seed_words(seed: int, *tags: int) -> list:
    """Entropy for ``numpy.random.SeedSequence`` from a run's seed (any
    whole number) and integer tags."""
    return [int(seed) % (1 << 64), *tags]


class TokenFeed:
    """Token and label batches ``[seqs_per_subfile, seq_len]`` (int32)
    from a traffic file and a seed; labels are the next tokens."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.rows = int(traffic["seqs_per_subfile"])
        self.seq_len = int(traffic["seq_len"])
        self.vocab, self.seed = int(vocab), seed

    @property
    def tokens_per_subfile(self) -> int:
        return self.rows * self.seq_len

    def batch(self, step: int, shard: int = 0) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence(seed_words(self.seed, 1, step, shard)))
        seq = rng.integers(0, self.vocab, size=(self.rows, self.seq_len + 1),
                           dtype=np.int32)
        return {"tokens": np.ascontiguousarray(seq[:, :-1]),
                "labels": np.ascontiguousarray(seq[:, 1:])}
