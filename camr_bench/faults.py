"""Faults planted in the trainer, to show that the check catches them.

Each is a function that breaks a built
``repro_torch.runtime.MultiModelCAMRTrainer`` in place, on the timed
path underneath the harness. The benchmark's runs plant none; the
calibration (``calibrate.py``) reads each at a cell's own size, and the
tests see each turn ``correct`` false.

* ``state_unchanged``: the update is skipped; every step returns the
  state it was given.
* ``half_batch``: each map sees half of its subfile (the first half of
  the rows, or of the positions of a single row) and takes the mean
  over that half.
* ``exchange_left_out``: the coded shuffle between the virtual workers
  is skipped; each worker's shard of a job's gradient holds only what
  that worker contributed itself (nothing, for a job it does not own).

A training step produces no token and no answer to check one by one, so
it has no fault of those.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FAULTS"]


def state_unchanged(tr) -> None:
    tr._apply = lambda gsync: None


def _halve(batch: dict) -> dict:
    rows = batch["tokens"].shape[0]
    if rows > 1:
        return {key: v[:rows // 2] for key, v in batch.items()}
    labels = np.array(batch["labels"], copy=True)
    labels[:, labels.shape[1] // 2:] = -1
    return {**batch, "labels": labels}


def half_batch(tr) -> None:
    grad_vec = tr._grad_vec
    tr._grad_vec = lambda j, n, batch: grad_vec(j, n, _halve(batch))


def exchange_left_out(tr) -> None:
    prog = tr.plan.program

    def local_only(contribs, report, *args):
        K, J_own = contribs.shape[0], contribs.shape[1]
        out = torch.zeros((K, tr.J, tr.d_shard), dtype=contribs.dtype,
                          device=contribs.device)
        for s in range(K):
            for a in range(J_own):
                j = int(prog.owned_jobs[s, a])
                out[s, j] = contribs[s, a, :, s].float().sum(0).to(out.dtype)
        return out

    tr._sync_spmd = local_only


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  exchange_left_out)}
