"""Executable baseline shuffles, with the same byte accounting as CAMR.

* :class:`UncodedAggregatedEngine` — same resolvable-design placement and
  combiners, but NO coding: every missing aggregate is unicast by a holder.
  Achieves L = (2K - k)/K (loads.uncoded_aggregated_load).
* :class:`CCDCEngine` — the *group-level exchange primitive* of Compressed
  Coded Distributed Computing [Li-Maddah-Ali-Avestimehr, ISIT'18] at
  computation load r = mu*K: jobs are indexed by the (r+1)-subsets of
  servers (J = C(K, r+1) — the paper's §V job-count requirement, which this
  engine makes concrete: every subset must host a job for the scheme to be
  complete), every server in subset S maps all parts of job_S except the
  one exclusive to it, and each S runs one Lemma-2-style coded exchange.
  The engine validates decode correctness and the member-exchange load
  (1/r per (job, member-function)); the full-system CCDC load formula
  (1-mu)(mu K+1)/(mu K) is compared analytically in
  :mod:`repro.core.loads` (test_camr_equals_ccdc_at_same_mu), since the
  paper's own comparison is analytic.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

from .designs import make_design
from .placement import make_placement
from .shuffle import (
    ShuffleTrace,
    Transmission,
    coded_multicast_schedule,
    decode_coded_multicast,
)

__all__ = ["UncodedAggregatedEngine", "CCDCEngine"]


class UncodedAggregatedEngine:
    """CAMR placement + combiners, shuffle without coding (all unicast)."""

    def __init__(self, q: int, k: int, gamma: int, map_fn,
                 combine=np.add):
        from .engine import CAMRConfig  # local import to avoid cycle
        self.cfg = CAMRConfig(q=q, k=k, gamma=gamma)
        self.design = make_design(q, k)
        self.placement = make_placement(self.design, gamma)
        self.map_fn = map_fn
        self.combine = combine
        self.trace = ShuffleTrace()

    def run(self, datasets):
        d, pl = self.design, self.placement
        K, Q = self.cfg.K, self.cfg.num_functions()
        agg = [dict() for _ in range(K)]
        for s in range(K):
            for job, t in pl.stored_batches(s):
                vals = [np.asarray(self.map_fn(job, datasets[job][n]))
                        for n in pl.batch_subfiles(t)]
                a = vals[0]
                for v in vals[1:]:
                    a = self.combine(a, v)
                agg[s][(job, t)] = a
        self._value_bytes = a[0].nbytes

        # Same canonical combine order as CAMREngine.reduce_phase
        # (delivered batch + ascending fold of the other k-1): coded and
        # uncoded runs over the same map outputs are BITWISE equal —
        # same math, different wires.
        results = [dict() for _ in range(K)]
        for j in range(d.J):
            for s in range(K):
                if d.is_owner(s, j):
                    # one unicast: any holder of the missing batch sends it
                    tmiss = pl.batch_of_label(j, s)
                    h = pl.holders(j, tmiss)[0]
                    payload = agg[h][(j, tmiss)][s]
                    self.trace.add(Transmission(
                        stage=1, sender=h, receivers=(s,),
                        payload=payload.tobytes(), tag=("job", j)))
                    rest = None
                    for t in range(d.k):
                        if t != tmiss:
                            v = agg[s][(j, t)][s]
                            rest = v if rest is None else self.combine(rest, v)
                    acc = self.combine(payload.copy(), rest)
                else:
                    # two unicasts: the owner u1 in s's parallel class sends
                    # its k-1 stored batches combined; u2 sends u1's missing
                    # batch (mirrors the CAMR stage-2/3 pair).
                    (u1,) = [u for u in d.owners[j]
                             if d.class_of(u) == d.class_of(s)]
                    t1 = pl.batch_of_label(j, u1)
                    acc1 = None
                    for t in range(d.k):
                        if t != t1:
                            v = agg[u1][(j, t)][s]
                            acc1 = v if acc1 is None else self.combine(acc1, v)
                    u2 = pl.holders(j, t1)[0]
                    part2 = agg[u2][(j, t1)][s]
                    for payload, u in ((acc1, u1), (part2, u2)):
                        self.trace.add(Transmission(
                            stage=3, sender=u, receivers=(s,),
                            payload=payload.tobytes(), tag=("job", j)))
                    acc = self.combine(part2, acc1)
                results[s][(j, s)] = acc
        return results

    def measured_load(self, model: str = "bus") -> float:
        J, Q, B = self.design.J, self.cfg.num_functions(), self._value_bytes
        return self.trace.total_bytes(model) / (J * Q * B)


@dataclass(frozen=True)
class _CCDCJob:
    """Job indexed by an (r+1)-subset S of servers."""

    subset: tuple[int, ...]


class CCDCEngine:
    """Executable CCDC group exchange at computation load r, J = C(K, r+1).

    Placement for job S (|S| = r+1): the dataset is split into r+1 parts,
    part ``p`` is stored on ``S \\ {S[p]}`` (each server in S misses exactly
    one part and stores r parts — storage fraction r/K per job).

    Shuffle: within group S, server S[p] needs the aggregate of part p for
    its reduce function; every other server of S can compute it — exactly
    the Lemma-2 setting with k := r+1. Measured member-exchange load is
    1/r per (job, member function); see module docstring for why the
    full-system formula comparison is analytic.
    """

    def __init__(self, K: int, r: int, map_fn, combine=np.add):
        if not 1 <= r <= K - 1:
            raise ValueError("need 1 <= r <= K-1")
        self.K, self.r = K, r
        self.jobs = [
            _CCDCJob(subset=S)
            for S in itertools.combinations(range(K), r + 1)
        ]
        self.map_fn = map_fn
        self.combine = combine
        self.trace = ShuffleTrace()

    @property
    def J(self) -> int:
        return len(self.jobs)

    def run(self, datasets):
        """datasets[j] = list of r+1 parts (each a subfile payload).

        Returns per-server dict {(job, member_index): reduced value}. Each
        member S[p] reduces function p of its job (Q_eff = r+1 per job).
        """
        r, K = self.r, self.K
        results = [dict() for _ in range(K)]
        for j, job in enumerate(self.jobs):
            S = job.subset
            # map: server S[p] maps all parts except part p
            vals = [np.asarray(self.map_fn(j, part)) for part in datasets[j]]
            dim = vals[0].shape
            self._value_bytes = vals[0][0].nbytes
            # coded exchange within S: chunk for S[p] = aggregate of part p
            # for function p (its reduce function)
            chunks = {S[p]: np.ascontiguousarray(vals[p][p]).tobytes()
                      for p in range(r + 1)}
            txs = coded_multicast_schedule(S, chunks, stage=1,
                                           tag=("job", j))
            for t in txs:
                self.trace.add(t)
            clen = len(next(iter(chunks.values())))
            for p, s in enumerate(S):
                known = {S[p2]: chunks[S[p2]] for p2 in range(r + 1)
                         if p2 != p}  # recomputable: s stores those parts
                dec = decode_coded_multicast(S, s, txs, known, clen)
                got = np.frombuffer(dec, dtype=vals[0].dtype).copy()
                acc = got
                for p2 in range(r + 1):
                    if p2 != p:
                        acc = self.combine(acc, vals[p2][p])
                results[s][(j, p)] = acc
        return results

    def verify(self, datasets, results):
        for j, job in enumerate(self.jobs):
            vals = [np.asarray(self.map_fn(j, part)) for part in datasets[j]]
            total = vals[0]
            for v in vals[1:]:
                total = self.combine(total, v)
            for p, s in enumerate(job.subset):
                np.testing.assert_allclose(results[s][(j, p)], total[p],
                                           rtol=1e-6, atol=1e-6)

    def measured_load(self, model: str = "bus") -> float:
        """Normalized by J * Q_eff * B with Q_eff = r+1 reducers per job."""
        B = self._value_bytes
        return self.trace.total_bytes(model) / (self.J * (self.r + 1) * B)
