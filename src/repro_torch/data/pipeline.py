"""Data pipeline: deterministic, shardable, restart-safe.

Two producers:

* :class:`ShardedTokenPipeline` — synthetic LM token streams. Every batch
  is a pure function of (seed, step, shard), so a restarted job resumes
  bit-identically from the checkpointed step (fault tolerance includes
  the data order), and every data-parallel worker slices its own shard
  without coordination.
* :func:`make_camr_job_datasets` — the J-jobs x N-subfiles layout the
  CAMR engine consumes (paper Example 1 word-count corpora, or gradient
  microbatch groups for the training integration).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ShardedTokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    # markov-ish structure so losses actually decrease during examples
    structure: float = 0.7

    def batch(self, step: int, shard: int = 0) -> dict:
        """Returns tokens/labels [B/n_shards, seq_len] for (step, shard)."""
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        b = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # structured stream: next token = f(prev) with prob `structure`
        base = rng.integers(0, self.vocab, size=(b, self.seq_len + 1))
        shifted = (base[:, :-1] * 31 + 7) % self.vocab
        coin = rng.random((b, self.seq_len)) < self.structure
        seq = np.concatenate(
            [base[:, :1], np.where(coin, shifted, base[:, 1:])], axis=1)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def microbatches(self, step: int, shard: int, n: int) -> list[dict]:
        """Split the shard's batch into n gradient-accumulation groups."""
        full = self.batch(step, shard)
        b = full["tokens"].shape[0]
        if b % n:
            raise ValueError("shard batch must divide by microbatches")
        return [{k: v[i * (b // n):(i + 1) * (b // n)]
                 for k, v in full.items()} for i in range(n)]


def wordcount_corpus(J: int, N: int, Q: int, *, chapter_len: int = 50,
                     seed: int = 0) -> list[list[np.ndarray]]:
    """Paper Example 1: J books of N chapters over a Q-word vocabulary."""
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, Q, size=chapter_len) for _ in range(N)]
            for _ in range(J)]


def make_camr_job_datasets(pipeline: ShardedTokenPipeline, J: int, N: int,
                           step: int) -> list[list[dict]]:
    """J jobs x N subfiles of LM batches (multi-model training: job j is
    model j's step data; subfile n is one map task's microbatch)."""
    out = []
    for j in range(J):
        subs = []
        for n in range(N):
            subs.append(pipeline.batch(step * J * N + j * N + n, 0))
        out.append(subs)
    return out
