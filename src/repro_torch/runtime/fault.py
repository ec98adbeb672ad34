"""Fault tolerance built ON the paper's redundancy.

The CAMR placement stores every batch on k-1 servers (computation
redundancy) — the same structure that buys the coded-shuffle savings also
makes single-server loss recoverable WITHOUT recomputation:

* stage 1/2 groups containing a failed server: its coded broadcast Δ is
  gone, but every packet Δ would have covered is known by other live
  group members (the Lemma-2 storage condition) — each receiver fetches
  its missing packet uncoded from any live holder.
* stage-3 unicasts from a failed sender: the k-1 batches it would have
  aggregated are each stored on other owners of the job; the receiver
  collects them (at most k-1 uncoded values instead of 1).
* the failed server's reduce functions are reassigned to live servers
  (function migration), which then also receive the values the failed
  server would have decoded.

:class:`DegradedCAMREngine` executes exactly this protocol and reports
the load inflation; the straggler path is identical (a straggler is a
failure with a deadline). The degraded schedule is not patched at run
time: :func:`repro.core.schedule.lower_degraded` RE-LOWERS the compiled
:class:`~repro.core.schedule.ShuffleProgram` against the surviving
server set, and the engine here interprets the result. The re-lowering
goes through :data:`repro.core.schedule.SCHEDULE_CACHE`, keyed by the
survivor set, so a stream of waves on a degraded cluster pays it once
(DESIGN.md §7/§9). Elastic re-planning rebuilds the design for a new K
and quantifies data movement.

In the port, everything up to :func:`retarget_engine`, and
:func:`degraded_dense_plan`, is the JAX package's numpy code unchanged.
:func:`degraded_shuffle_host` takes a ``combine`` (the bf16 lane hands
it ``uint16`` bit patterns and ``train_loop.bf16_add``), and
:func:`build_degraded_executor` gathers and folds with torch on a
device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from functools import lru_cache

from repro_torch.core.designs import factorize_cluster, make_design
from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.core.placement import make_placement
from repro_torch.core.schedule import (SCHEDULE_CACHE, DegradedProgram,
                                       resolve_topology, surviving_topology)
from repro_torch.core.shuffle import Transmission
from repro_torch.device import resolve_device

__all__ = ["DegradedCAMREngine", "elastic_replan", "ReplanReport",
           "MembershipError", "WireCorruptionError", "StragglerPolicy",
           "Membership", "HostMembership", "ElasticController",
           "retarget_engine", "smallest_unrecoverable_set",
           "degraded_shuffle_host", "degraded_dense_plan",
           "build_degraded_executor"]


class MembershipError(RuntimeError):
    """Invalid membership transition, or a degraded engine whose failed
    set was mutated after its survivor-set lowering was fixed."""


class WireCorruptionError(RuntimeError):
    """A coded wire packet failed its checksum after decode and the
    bounded bitwise replay could not produce a clean wave (DESIGN.md
    §17). Raised INSTEAD of returning silently mis-reduced values —
    the integrity lane's whole contract."""


@lru_cache(maxsize=32)
def _design_placement(q: int, k: int, gamma: int):
    design = make_design(q, k)
    return design, make_placement(design, gamma)


def smallest_unrecoverable_set(q: int, k: int, failed,
                               gamma: int = 1):
    """Smallest subset of ``failed`` that is by itself unrecoverable
    by the degraded shuffle, or ``None`` when ``failed`` is
    recoverable (the exact conditions
    :func:`repro.core.schedule.lower_degraded` rejects on).

    Checked smallest-first, so the returned tuple is a MINIMAL witness
    the operator can act on: a single worker when ``k < 3`` (no
    redundancy to recover from), a same-parallel-class pair (map
    recompute required), or a batch's full ``k-1`` holder set (data
    loss).
    """
    failed = frozenset(int(s) for s in failed)
    if not failed:
        return None
    design, pl = _design_placement(q, k, gamma)
    if k < 3:
        return (min(failed),)
    for i in range(k):
        cls = sorted(set(design.parallel_class(i)) & failed)
        if len(cls) > 1:
            return tuple(cls[:2])
    for j in range(design.J):
        for t in range(k):
            holders = frozenset(pl.holders(j, t))
            if holders <= failed:
                return tuple(sorted(holders))
    return None


class DegradedCAMREngine(CAMREngine):
    """CAMR engine that survives a set of failed/straggling servers.

    ``failed`` servers complete the Map phase but are silent in the
    Shuffle (crash or deadline-miss after map). Their reduce functions
    are migrated to the next live server in their parallel class.

    All scheduling decisions live in the re-lowered
    :class:`~repro.core.schedule.DegradedProgram`; this class only moves
    the bytes it prescribes.
    """

    def __init__(self, cfg: CAMRConfig, map_fn, failed: set[int],
                 **kw):
        super().__init__(cfg, map_fn, **kw)
        self.failed = set(failed)
        # raises ValueError when the loss exceeds the redundancy; the
        # re-lowering is cached per (configuration, survivor set), so a
        # JobStream of waves on a degraded cluster pays it once
        self.degraded: DegradedProgram = SCHEDULE_CACHE.degraded(
            self.program, self.failed)

    # -- function migration -------------------------------------------- #
    def migrate_target(self, s: int) -> int:
        """Live server taking over s's reduce duties (same class)."""
        return int(self.degraded.migrate[s])

    # -- frozen-membership guard ---------------------------------------- #
    def _check_membership_frozen(self) -> None:
        """The survivor set is FIXED at construction: every uncoded
        route, stage-3 source and migration-fill send is baked into the
        re-lowered :class:`DegradedProgram`. Stacking another failure
        onto a live engine would silently mis-reduce (the schedule
        would keep routing through the newly-dead server), so any drift
        between ``self.failed`` and the lowered set is a hard error."""
        if frozenset(self.failed) != self.degraded.failed:
            raise MembershipError(
                f"failed set changed after lowering: this engine was "
                f"re-lowered for failures {sorted(self.degraded.failed)} "
                f"but now sees {sorted(self.failed)}. A "
                "DegradedCAMREngine is frozen to one survivor set — "
                "route membership changes through a fresh re-lowering "
                "instead (repro.runtime.fault.retarget_engine adopts "
                "the map state and pulls the new survivor-set schedule "
                "from the warm SCHEDULE_CACHE).")

    def shuffle_phase(self):
        self._check_membership_frozen()
        super().shuffle_phase()

    # -- degraded shuffle ----------------------------------------------- #
    def _coded_stage(self, stage, fn_group):
        """Run Algorithm 2 for the fully-live group rows; deliver the
        degraded rows uncoded, exactly as the re-lowered program says."""
        K = self.cfg.K
        prog, deg = self.program, self.degraded
        for row in deg.coded_rows:
            if int(prog.stage_of[row]) == stage:
                self._run_coded_group(int(row), stage, fn_group)
        for row, sends in deg.uncoded:
            if int(prog.stage_of[row]) != stage:
                continue
            G = prog.group_members(row)
            for holder, rcv, job, batch, owner in sends:
                qf = fn_group * K + owner
                val = self.servers[holder].agg[(job, batch)][qf]
                payload = self._ser(val)
                self.trace.add(Transmission(
                    stage=stage, sender=holder, receivers=(rcv,),
                    payload=payload, tag=("degraded", G)))
                self.servers[rcv].recv_batch[(job, batch, qf)] = \
                    self._de(payload)

    def _stage3(self, fn_group):
        """Interpret the re-lowered stage-3 sends (normal unicasts,
        per-batch recovery from redundant holders, and migration fill).
        Entries sharing a (receiver, job, function) key are combined
        locally first, then ASSIGNED — shuffle_phase stays idempotent
        like the base engine's."""
        K = self.cfg.K
        acc_map: dict = {}
        for snd, rcv, job, owner, batches in self.degraded.s3:
            qf = fn_group * K + owner
            sender_st = self.servers[snd]
            acc = None
            for t in batches:
                v = sender_st.agg[(job, t)][qf]
                acc = v if acc is None else self.combine(acc, v)
            payload = self._ser(acc)
            self.trace.add(Transmission(
                stage=3, sender=snd, receivers=(rcv,),
                payload=payload, tag=("job", job, "fn", fn_group)))
            key = (rcv, job, qf)
            val = self._de(payload)
            acc_map[key] = (val if key not in acc_map
                            else self.combine(acc_map[key], val))
        for (rcv, job, qf), val in acc_map.items():
            self.servers[rcv].recv_rest[(job, qf)] = val

    def reduce_phase(self):
        """Reduce on live servers; migrated functions use the redirected
        (stage-1/2 batch value) + (stage-3/fill complement) pair."""
        self._check_membership_frozen()
        pl, d = self.placement, self.design
        results = [dict() for _ in range(d.K)]
        for s_orig in range(d.K):
            s = self.migrate_target(s_orig)
            st = self.servers[s]
            migrated = s != s_orig
            for qf in self.functions_of(s_orig):
                for j in range(d.J):
                    if migrated:
                        # unified: l = owner of j in the FAILED server's
                        # class (l == s_orig when s_orig owned j)
                        cls = d.class_of(s_orig)
                        (l,) = [u for u in d.owners[j]
                                if d.class_of(u) == cls]
                        tl = pl.batch_of_label(j, l)
                        acc = self.combine(st.recv_batch[(j, tl, qf)],
                                           st.recv_rest[(j, qf)])
                    elif d.is_owner(s, j):
                        # canonical order (engine.reduce_phase): delivered
                        # batch + ascending fold of the k-1 stored ones
                        tmiss = pl.batch_of_label(j, s)
                        rest = None
                        for t in range(d.k):
                            if t != tmiss:
                                v = st.agg[(j, t)][qf]
                                rest = v if rest is None \
                                    else self.combine(rest, v)
                        acc = self.combine(st.recv_batch[(j, tmiss, qf)],
                                           rest)
                    else:
                        cls = d.class_of(s)
                        (l,) = [u for u in d.owners[j]
                                if d.class_of(u) == cls]
                        tl = pl.batch_of_label(j, l)
                        acc = self.combine(st.recv_batch[(j, tl, qf)],
                                           st.recv_rest[(j, qf)])
                    results[s][(j, qf)] = acc
            if migrated:
                results[s_orig] = {}
        return results


@dataclass(frozen=True)
class ReplanReport:
    old_qk: tuple
    new_qk: tuple
    moved_fraction: float     # fraction of stored subfiles that must move
    new_storage_fraction: float


def elastic_replan(q_old: int, k_old: int, K_new: int,
                   mu_target: float | None = None,
                   gamma: int = 1) -> ReplanReport:
    """Re-derive the design for a resized cluster and quantify movement.

    Servers keep their index order; subfiles already resident count as
    not-moved. The CAMR structural requirement is only K = q*k, so
    elastic scaling is a pure re-placement (no re-encoding of data)."""
    q_new, k_new = factorize_cluster(K_new, mu_target)
    old = make_placement(make_design(q_old, k_old), gamma)
    new = make_placement(make_design(q_new, k_new), gamma)
    K_old = q_old * k_old
    # compare on the job universe of the smaller plan, normalized per job
    J = min(old.design.J, new.design.J)
    total, moved = 0, 0
    for s in range(min(K_old, K_new)):
        old_set = {(j, n) for j, n in old.stored_subfiles(s) if j < J}
        new_set = {(j, n) for j, n in new.stored_subfiles(s) if j < J}
        total += len(new_set)
        moved += len(new_set - old_set)
    for s in range(min(K_old, K_new), K_new):   # fresh servers fetch all
        new_set = {(j, n) for j, n in new.stored_subfiles(s) if j < J}
        total += len(new_set)
        moved += len(new_set)
    return ReplanReport(
        old_qk=(q_old, k_old), new_qk=(q_new, k_new),
        moved_fraction=moved / max(total, 1),
        new_storage_fraction=(k_new - 1) / K_new)


# --------------------------------------------------------------------- #
# live elasticity (DESIGN.md §14): membership state machine, straggler
# detection, wave-boundary control, and engine re-targeting
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class StragglerPolicy:
    """Knobs of the wave-timing straggler detector (DESIGN.md §14).

    A worker whose observed map time exceeds ``rel_threshold`` times the
    live-set median (or ``abs_timeout_s``, when set) earns a strike and
    is flagged ``straggler``; ``patience`` consecutive strikes demote it
    to ``dead`` when ``demote`` is on. ``max_failed`` caps concurrent
    dead workers at what one re-lowering can absorb — a would-be demote
    beyond the cap keeps the worker flagged but live (slow data beats
    no data). Waves whose live median lands under ``min_wave_s`` are
    too fast to measure and are skipped entirely (no strikes, no
    clears) — scheduler jitter on a µs-scale map phase says nothing
    about worker health.
    """

    rel_threshold: float = 4.0
    abs_timeout_s: float | None = None
    patience: int = 2
    demote: bool = True
    max_failed: int = 1
    min_wave_s: float = 0.0


class Membership:
    """Worker membership state machine for one (q, k) CAMR cluster.

    States: ``live`` -> ``straggler`` (timing strikes) -> ``dead``
    (demoted, or killed outright) -> ``live`` again via :meth:`rejoin`.
    Every transition bumps ``generation`` and is appended to ``events``
    — the stream's replan hook keys off :meth:`failed`, so a stale
    engine is always detectable by set comparison.

    :meth:`rejoin` re-admits a worker through
    :func:`elastic_replan`'s pure re-placement: with the cluster size
    unchanged the factorization is pinned to the original ``(q, k)``
    (``mu_target = (k-1)/K``), so the replan receipt proves
    ``moved_fraction == 0`` — no subfile moves and nothing re-encodes;
    the rejoined worker's stored batches are simply valid again.

    With a two-level ``topology`` the ``max_failed`` cap counts FAULT
    DOMAINS (class-major host blocks), not individual workers: two
    dead workers on ONE host are one correlated event and consume one
    slot (DESIGN.md §17). Either way a kill/demote that would make the
    failed set shuffle-unrecoverable is rejected up front with the
    smallest unrecoverable witness named — the stream never reaches
    ``lower_degraded`` with a doomed survivor set.
    """

    LIVE, STRAGGLER, DEAD = "live", "straggler", "dead"

    def __init__(self, q: int, k: int, *, gamma: int = 1,
                 policy: StragglerPolicy | None = None, topology=None):
        self.q, self.k, self.gamma = q, k, gamma
        self.K = q * k
        self.policy = policy or StragglerPolicy()
        self.topology = resolve_topology(topology, q, k)
        self._dph = (self.K // self.topology.hosts
                     if self.topology is not None else None)
        self.state = [self.LIVE] * self.K
        self.strikes = [0] * self.K
        self.generation = 0
        self.events: list[tuple] = []     # (generation, kind, worker)
        self.replans: list[ReplanReport] = []

    # -- queries --------------------------------------------------------- #
    def failed(self) -> frozenset:
        return frozenset(s for s in range(self.K)
                         if self.state[s] == self.DEAD)

    def live(self) -> frozenset:
        return frozenset(s for s in range(self.K)
                         if self.state[s] != self.DEAD)

    def domains(self, workers) -> frozenset:
        """Correlated fault domains covering ``workers``: host ids
        under a two-level topology, the workers themselves when flat
        (every worker its own domain — the pre-§17 accounting)."""
        if self.topology is None:
            return frozenset(workers)
        return frozenset(int(w) // self._dph for w in workers)

    def gateway_avoid(self) -> frozenset:
        """Devices a straggler-aware lowering should not elect as
        phase-A gateways: everything not fully ``live`` right now."""
        return frozenset(s for s in range(self.K)
                         if self.state[s] != self.LIVE)

    def _check_worker(self, w: int) -> None:
        if not 0 <= w < self.K:
            raise MembershipError(f"worker {w} outside cluster "
                                  f"[0, {self.K})")

    def _record(self, kind: str, worker: int) -> None:
        self.generation += 1
        self.events.append((self.generation, kind, worker))

    def _vet_kill(self, w: int) -> str | None:
        """Reason the live/straggler worker ``w`` must not die now, or
        ``None`` when the kill is admissible. Shared by :meth:`kill`
        (raises) and :meth:`demote` (declines quietly)."""
        would = self.failed() | {w}
        if len(self.domains(would)) > self.policy.max_failed:
            unit = ("fault domains (class-major host blocks)"
                    if self.topology is not None else "failures")
            bad = smallest_unrecoverable_set(self.q, self.k, would,
                                             self.gamma)
            hint = (f"; smallest unrecoverable set: workers {list(bad)}"
                    if bad is not None else "")
            return (f"killing worker {w} would exceed "
                    f"max_failed={self.policy.max_failed} concurrent "
                    f"{unit} (dead: {sorted(self.failed())}, domains: "
                    f"{sorted(self.domains(would))}){hint}")
        bad = smallest_unrecoverable_set(self.q, self.k, would,
                                         self.gamma)
        if bad is not None:
            return (f"killing worker {w} would make the dead set "
                    f"{sorted(would)} shuffle-unrecoverable — smallest "
                    f"unrecoverable set: workers {list(bad)} "
                    "(same parallel class, a wiped holder set, or "
                    "k < 3); recover at host granularity instead "
                    "(HostMembership re-lowers the topology)")
        return None

    # -- transitions ----------------------------------------------------- #
    def kill(self, w: int) -> None:
        """live/straggler -> dead (crash or operator drain)."""
        self._check_worker(w)
        if self.state[w] == self.DEAD:
            raise MembershipError(f"worker {w} is already dead")
        veto = self._vet_kill(w)
        if veto is not None:
            raise MembershipError(veto)
        self.state[w] = self.DEAD
        self.strikes[w] = 0
        self._record("kill", w)

    def demote(self, w: int) -> bool:
        """straggler -> dead, respecting the ``max_failed`` cap (and
        never into an unrecoverable set — slow data beats no data).
        Returns whether the demote actually happened."""
        self._check_worker(w)
        if self.state[w] == self.DEAD:
            raise MembershipError(f"worker {w} is already dead")
        if self._vet_kill(w) is not None:
            return False
        self.state[w] = self.DEAD
        self.strikes[w] = 0
        self._record("demote", w)
        return True

    def rejoin(self, w: int) -> ReplanReport:
        """dead -> live, with the elastic-replan receipt recorded."""
        self._check_worker(w)
        if self.state[w] != self.DEAD:
            raise MembershipError(
                f"worker {w} is {self.state[w]}; only dead workers "
                "rejoin")
        # same-K re-admission: mu_target pins factorize_cluster to the
        # original (q, k), so the receipt certifies zero data movement
        rep = elastic_replan(self.q, self.k, self.K,
                             mu_target=(self.k - 1) / self.K,
                             gamma=self.gamma)
        self.replans.append(rep)
        self.state[w] = self.LIVE
        self.strikes[w] = 0
        self._record("rejoin", w)
        return rep

    # -- detection ------------------------------------------------------- #
    def observe(self, timings: dict[int, float]) -> list[int]:
        """Feed one wave of per-worker map seconds; returns workers
        demoted by this observation. Dead workers are ignored; a clean
        wave clears a worker's strikes (the detector demands
        ``patience`` CONSECUTIVE slow waves, so one GC pause or page
        fault never evicts a healthy worker)."""
        pol = self.policy
        live_t = {int(w): float(t) for w, t in timings.items()
                  if self.state[int(w)] != self.DEAD}
        demoted: list[int] = []
        if not live_t:
            return demoted
        med = float(np.median(list(live_t.values())))
        if med < pol.min_wave_s:
            return demoted      # unmeasurable wave: no verdict either way
        for w, t in live_t.items():
            timed_out = (pol.abs_timeout_s is not None
                         and t > pol.abs_timeout_s)
            slow = med > 0 and t > pol.rel_threshold * med
            if timed_out or slow:
                self.strikes[w] += 1
                if self.state[w] == self.LIVE:
                    self.state[w] = self.STRAGGLER
                    self._record("flag", w)
                if pol.demote and self.strikes[w] >= pol.patience:
                    if self.demote(w):
                        demoted.append(w)
            else:
                self.strikes[w] = 0
                if self.state[w] == self.STRAGGLER:
                    self.state[w] = self.LIVE
                    self._record("clear", w)
        return demoted


class HostMembership:
    """Host-granularity fault domains over a two-level topology
    (DESIGN.md §17).

    Whole-host loss is NEVER absorbable by the survivor-set degraded
    shuffle: each class-major host block holds ``k/hosts`` COMPLETE
    parallel classes, so any single dead host already trips
    ``lower_degraded``'s one-per-class check. Recovery is therefore a
    TOPOLOGY re-homing, not a degradation — :meth:`kill_host`
    atomically fails the block (one correlated event) and
    :meth:`current_topology` names the surviving-host lowering target:
    ``two_level`` over the remaining hosts while ``hosts_left | k``
    still holds, else ``None`` (the bitwise-identical flat fallback).
    Schedule values are topology-independent, so the re-homed stream
    stays bitwise-equal to the healthy oracle; pre-pay every
    survivor lowering with ``ScheduleCache.warm_host_survivors`` and
    the swap is a pure cache hit.
    """

    LIVE, DEAD = "live", "dead"

    def __init__(self, q: int, k: int, topology, *,
                 max_failed_hosts: int | None = None):
        topology = resolve_topology(topology, q, k)
        if topology is None:
            raise MembershipError(
                "HostMembership needs a two-level topology (flat "
                "clusters have no host fault domains — use Membership)")
        topology.check(q, k)
        self.q, self.k, self.K = q, k, q * k
        self.topology = topology
        self.hosts = topology.hosts
        self.dph = self.K // self.hosts
        cap = self.hosts - 1 if max_failed_hosts is None \
            else int(max_failed_hosts)
        if not 0 < cap < self.hosts:
            raise MembershipError(
                f"max_failed_hosts={max_failed_hosts} outside "
                f"[1, {self.hosts - 1}] for {self.hosts} hosts")
        self.max_failed_hosts = cap
        self.state = [self.LIVE] * self.hosts
        self.generation = 0
        self.events: list[tuple] = []    # (generation, kind, host)

    # -- queries --------------------------------------------------------- #
    def failed_hosts(self) -> frozenset:
        return frozenset(h for h in range(self.hosts)
                         if self.state[h] == self.DEAD)

    def live_hosts(self) -> frozenset:
        return frozenset(h for h in range(self.hosts)
                         if self.state[h] == self.LIVE)

    def host_block(self, h: int) -> tuple:
        """The class-major device block host ``h`` owns."""
        self._check_host(h)
        return tuple(range(h * self.dph, (h + 1) * self.dph))

    def failed_workers(self) -> frozenset:
        """Every device on a dead host — the correlated loss set."""
        return frozenset(w for h in self.failed_hosts()
                         for w in self.host_block(h))

    def current_topology(self):
        """Lowering target for the surviving hosts: ``two_level`` when
        the block structure still divides ``k``, else ``None``
        (flat)."""
        return surviving_topology(len(self.live_hosts()), self.k,
                                  alpha=self.topology.alpha)

    def _check_host(self, h: int) -> None:
        if not 0 <= h < self.hosts:
            raise MembershipError(f"host {h} outside cluster "
                                  f"[0, {self.hosts})")

    def _record(self, kind: str, host: int) -> None:
        self.generation += 1
        self.events.append((self.generation, kind, host))

    # -- transitions ----------------------------------------------------- #
    def kill_host(self, h: int) -> tuple:
        """Atomically fail host ``h``'s whole block (ONE correlated
        event against ``max_failed_hosts``); returns the dead device
        block so the caller can drain in-flight work."""
        self._check_host(h)
        if self.state[h] == self.DEAD:
            raise MembershipError(f"host {h} is already dead")
        would = sorted(self.failed_hosts() | {h})
        if len(would) >= self.hosts:
            lost = sorted(w for hh in would for w in self.host_block(hh))
            raise MembershipError(
                f"killing host {h} would fail every host {would} — "
                f"smallest unrecoverable set: the full host set owning "
                f"workers {lost}; no surviving host remains to re-home "
                "the shuffle onto")
        if len(would) > self.max_failed_hosts:
            raise MembershipError(
                f"killing host {h} would exceed "
                f"max_failed_hosts={self.max_failed_hosts} concurrent "
                f"host fault domains (dead hosts: "
                f"{sorted(self.failed_hosts())})")
        self.state[h] = self.DEAD
        self._record("kill_host", h)
        return self.host_block(h)

    def rejoin_host(self, h: int) -> None:
        """dead -> live; the next :meth:`current_topology` re-homes
        back onto the larger host set (pure cache hit when warmed)."""
        self._check_host(h)
        if self.state[h] != self.DEAD:
            raise MembershipError(
                f"host {h} is {self.state[h]}; only dead hosts rejoin")
        self.state[h] = self.LIVE
        self._record("rejoin_host", h)


class ElasticController:
    """Wave-boundary control loop between a :class:`Membership` and a
    stream (``JobStream(elastic=...)``).

    The stream calls :meth:`wave_start` from its map-prefetch thread
    when it builds each batch's engine, and :meth:`current_failed` +
    :meth:`wave_timings` from the main thread around each batch's
    shuffle+reduce — one lock serializes the two lanes. Under
    pipelining, batch ``t+1``'s engine may be built before batch ``t``'s
    timings arrive; detection therefore lands one batch late at worst,
    and correctness never depends on WHEN a membership change is seen:
    the stream re-targets every engine against the current survivor set
    right before its shuffle, and degraded output is bitwise-identical
    to healthy output (DESIGN.md §11/§14).

    Subclass hooks (both called under the lock):
    ``on_wave_start(wave)`` — apply scripted churn (tests/chaos.py);
    ``on_wave_timings(wave, timings) -> timings`` — perturb observed
    timings before they reach the detector.
    """

    def __init__(self, membership: Membership):
        self.membership = membership
        self._lock = threading.Lock()
        self.waves = 0                 # batches started
        self.migrations = 0            # engine re-targets (stream-fed)

    # -- subclass hooks -------------------------------------------------- #
    def on_wave_start(self, wave: int) -> None:
        pass

    def on_wave_timings(self, wave: int,
                        timings: dict[int, float]) -> dict[int, float]:
        return timings

    # -- stream interface ------------------------------------------------ #
    def wave_start(self, wave: int) -> frozenset:
        with self._lock:
            self.waves = max(self.waves, wave + 1)
            self.on_wave_start(wave)
            return self.membership.failed()

    def current_failed(self) -> frozenset:
        with self._lock:
            return self.membership.failed()

    def wave_timings(self, wave: int, map_times) -> list[int]:
        """Feed a completed batch's per-server map seconds (live
        workers only) through the straggler detector."""
        with self._lock:
            failed = self.membership.failed()
            timings = {s: float(map_times[s])
                       for s in range(self.membership.K)
                       if s not in failed}
            timings = self.on_wave_timings(wave, timings)
            return self.membership.observe(timings)


def retarget_engine(eng: CAMREngine, failed) -> CAMREngine:
    """Swap an engine's shuffle schedule to the survivor set ``failed``
    WITHOUT recomputing its map phase.

    Returns ``eng`` unchanged when the set already matches; otherwise a
    fresh engine (degraded or healthy) whose re-lowering comes from the
    warm :data:`SCHEDULE_CACHE` and which ADOPTS the old engine's
    mapped aggregates — the recovery memory model of DESIGN.md §14: a
    membership change costs one cached table lookup, never a re-map.
    """
    failed = set(int(s) for s in failed) if failed else set()
    have = set(getattr(eng, "failed", set()) or set())
    if failed == have:
        return eng
    label_perm = eng.placement.label_perm
    if failed:
        new = DegradedCAMREngine(eng.cfg, eng.map_fn, failed,
                                 combine=eng.combine,
                                 label_perm=label_perm)
    else:
        new = CAMREngine(eng.cfg, eng.map_fn, combine=eng.combine,
                         label_perm=label_perm)
    # adopt map-phase state: aggregates, value metadata, timings. The
    # shuffle/reduce run entirely off these plus the (new) lowering.
    new.servers = eng.servers
    new._value_dim = eng._value_dim
    new._dtype = eng._dtype
    new.map_times = eng.map_times
    new.trace = eng.trace
    return new




def degraded_shuffle_host(program, failed, contribs,
                          combine=np.add) -> np.ndarray:
    """Host-side degraded executor over SPMD contribution tensors.

    Interprets the survivor-set re-lowering of ``program`` (served from
    :data:`SCHEDULE_CACHE`) against stacked per-worker contributions
    ``[K, J_own, k-1, K, d]`` — the exact input of
    :func:`repro_torch.core.collective.camr_shuffle` — and returns
    logical outputs ``[K, J, d]``: row ``s`` is the fully-aggregated
    shard ``s`` of every job, computed on ``s``'s migrate target when
    ``s`` failed. Rows of failed workers in ``contribs`` are NEVER read
    (failed means silent after map), and because every route folds in
    the canonical combine order the output is BITWISE equal to the
    healthy shuffle of the same contributions (DESIGN.md §11).

    The JAX package's interpreter step for step, with every add going
    through ``combine``: ``np.add`` for values numpy can add, or
    ``train_loop.bf16_add`` for bf16 carried as ``uint16`` bit patterns
    (an integer ``+`` on those bits would be wrong).
    """
    deg = SCHEDULE_CACHE.degraded(program, set(failed))
    design, pl = program.design, program.placement
    q, k, K = program.q, program.k, program.K
    J = design.J
    J_own = q ** (k - 2)
    contribs = np.asarray(contribs)
    d = contribs.shape[-1]
    if contribs.shape != (K, J_own, k - 1, K, d):
        raise ValueError(f"contribs shape {contribs.shape} != "
                         f"{(K, J_own, k - 1, K, d)}")
    dead = deg.failed

    # (server, job, batch) -> [K, d] per-function-shard aggregate; only
    # survivor rows enter the table, so a read of dead data is a KeyError
    agg: dict = {}
    for s in range(K):
        if s in dead:
            continue
        for a in range(J_own):
            j = int(program.owned_jobs[s, a])
            for b in range(k - 1):
                t = int(program.stored_batches[s, a, b])
                agg[(s, j, t)] = contribs[s, a, b]
    # stages 1+2: coded rows deliver from the first co-holder (all live);
    # degraded rows follow the uncoded unicast plan
    recv_batch: dict = {}           # (rcv, job, batch, owner) -> [d]
    for row in deg.coded_rows:
        G = program.group_members(int(row))
        for kp, j, t in program.coded_chunks(int(row)):
            holder = next(s for s in G if s != kp)
            recv_batch[(kp, j, t, kp)] = agg[(holder, j, t)][kp]
    for _row, sends in deg.uncoded:
        for holder, rcv, j, t, owner in sends:
            recv_batch[(rcv, j, t, owner)] = agg[(holder, j, t)][owner]
    # stage 3: sender-side ascending folds; entries sharing a key are
    # combined in s3 iteration order (the engine's acc_map contract)
    recv_rest: dict = {}            # (rcv, job, owner) -> [d]
    for snd, rcv, j, owner, batches in deg.s3:
        acc = None
        for t in batches:
            v = agg[(snd, j, t)][owner]
            acc = v if acc is None else combine(acc, v)
        key = (rcv, j, owner)
        recv_rest[key] = (acc if key not in recv_rest
                          else combine(recv_rest[key], acc))
    # reduce: canonical order per DegradedCAMREngine.reduce_phase, with
    # migrated rows normalized back to their logical slots
    out = np.zeros((K, J, d), contribs.dtype)
    for s_orig in range(K):
        s = int(deg.migrate[s_orig])
        migrated = s != s_orig
        for j in range(J):
            if migrated:
                cls = design.class_of(s_orig)
                (l,) = [u for u in design.owners[j]
                        if design.class_of(u) == cls]
                tl = pl.batch_of_label(j, l)
                out[s_orig, j] = combine(recv_batch[(s, j, tl, s_orig)],
                                         recv_rest[(s, j, s_orig)])
            elif design.is_owner(s, j):
                tmiss = pl.batch_of_label(j, s)
                rest = None
                for t in range(k):
                    if t != tmiss:
                        v = agg[(s, j, t)][s]
                        rest = v if rest is None else combine(rest, v)
                out[s_orig, j] = combine(recv_batch[(s, j, tmiss, s)], rest)
            else:
                cls = design.class_of(s)
                (l,) = [u for u in design.owners[j]
                        if design.class_of(u) == cls]
                tl = pl.batch_of_label(j, l)
                out[s_orig, j] = combine(recv_batch[(s, j, tl, s)],
                                         recv_rest[(s, j, s)])
    return out
def degraded_dense_plan(program, failed):
    """Dense index-plan of the survivor-set re-lowering (DESIGN.md §15).

    Every logical output row ``(s_orig, j)`` of
    :func:`degraded_shuffle_host` is ``A + B``: A is ONE element of the
    flattened contribution tensor (the recv_batch delivery) and B is a
    TWO-LEVEL ordered fold over further elements — the outer level over
    "groups" (the s3 sends sharing the row's key, in s3 iteration
    order; or the owner's stored batches ascending), the inner level a
    left fold over each group's elements in listed order. This function
    extracts those indices WITHOUT running anything, preserving the
    host interpreter's exact combine order, so a device executor
    gathering through them is BITWISE-identical to the interpreter
    (fp addition is not associative — flattening the nested folds
    would break the §11 bit-identity contract).

    Returns ``(a_idx [R], g_idx [R, G, E], g_mask [R, G, E])`` int32 /
    bool with ``R = K * J`` row-major over ``(s_orig, j)``, indexing
    the flattened ``[K * J_own * (k-1) * K]`` leading axes of contribs.
    ``g_mask`` marks real (non-pad) elements; every row has >= 1 group
    and every real group >= 1 element, with element 0 always real.
    Indices are value-width independent: one plan serves every stacked
    wave width ``W * d``.
    """
    deg = SCHEDULE_CACHE.degraded(program, set(failed))
    design, pl = program.design, program.placement
    q, k, K = program.q, program.k, program.K
    J = design.J
    J_own = q ** (k - 2)
    dead = deg.failed

    def flat(s, a, b, owner):
        return ((s * J_own + a) * (k - 1) + b) * K + owner

    # (server, job, batch) -> (a, b) slot in the contribs tensor; only
    # survivors enter, so indexing dead data is a KeyError (a plan bug)
    pos: dict = {}
    for s in range(K):
        if s in dead:
            continue
        for a in range(J_own):
            j = int(program.owned_jobs[s, a])
            for b in range(k - 1):
                t = int(program.stored_batches[s, a, b])
                pos[(s, j, t)] = (a, b)

    recv_src: dict = {}          # (rcv, job, batch, owner) -> flat idx
    for row in deg.coded_rows:
        G = program.group_members(int(row))
        for kp, j, t in program.coded_chunks(int(row)):
            holder = next(s for s in G if s != kp)
            a, b = pos[(holder, j, t)]
            recv_src[(kp, j, t, kp)] = flat(holder, a, b, kp)
    for _row, sends in deg.uncoded:
        for holder, rcv, j, t, owner in sends:
            a, b = pos[(holder, j, t)]
            recv_src[(rcv, j, t, owner)] = flat(holder, a, b, owner)

    rest_groups: dict = {}       # (rcv, job, owner) -> [group, ...]
    for snd, rcv, j, owner, batches in deg.s3:
        grp = [flat(snd, *pos[(snd, j, t)], owner) for t in batches]
        rest_groups.setdefault((rcv, j, owner), []).append(grp)

    a_idx = np.zeros(K * J, np.int32)
    per_row: list = []
    for s_orig in range(K):
        s = int(deg.migrate[s_orig])
        migrated = s != s_orig
        for j in range(J):
            r = s_orig * J + j
            if migrated:
                cls = design.class_of(s_orig)
                (l,) = [u for u in design.owners[j]
                        if design.class_of(u) == cls]
                tl = pl.batch_of_label(j, l)
                a_idx[r] = recv_src[(s, j, tl, s_orig)]
                grps = rest_groups[(s, j, s_orig)]
            elif design.is_owner(s, j):
                tmiss = pl.batch_of_label(j, s)
                a_idx[r] = recv_src[(s, j, tmiss, s)]
                grps = [[flat(s, *pos[(s, j, t)], s)
                         for t in range(k) if t != tmiss]]
            else:
                cls = design.class_of(s)
                (l,) = [u for u in design.owners[j]
                        if design.class_of(u) == cls]
                tl = pl.batch_of_label(j, l)
                a_idx[r] = recv_src[(s, j, tl, s)]
                grps = rest_groups[(s, j, s)]
            per_row.append(grps)

    Gm = max(len(g) for g in per_row)
    Em = max(len(e) for g in per_row for e in g)
    g_idx = np.zeros((K * J, Gm, Em), np.int32)
    g_mask = np.zeros((K * J, Gm, Em), bool)
    for r, grps in enumerate(per_row):
        for gi, grp in enumerate(grps):
            g_idx[r, gi, :len(grp)] = grp
            g_mask[r, gi, :len(grp)] = True
    return a_idx, g_idx, g_mask


def build_degraded_executor(program, failed, d: int, dtype, device=None):
    """Build the dense degraded plan into ONE device executor
    ``contribs [K, J_own, k-1, K, d] -> out [K, J, d]`` (DESIGN.md §15)
    — the :class:`~repro_torch.core.collective.ShuffleStream` degraded
    lane. The plan's index tables go to ``device`` HERE, once: a call
    does no host work and no copy to the host, and a mid-stream degrade
    warmed through the EXEC_CACHE builds nothing.

    Bitwise contract: the gathers and the two-level masked fold below
    replay :func:`degraded_shuffle_host`'s adds in its exact order: the
    left fold over each group's elements, then the fold over a row's
    groups, then ``A + B``, each add in ``dtype`` (a bf16 add rounds
    once, as the coded shuffle's assembly does). Masking uses
    ``where(mask, acc + v, acc)`` — a SELECT around the add, never
    ``acc + where(mask, v, 0)``, which would rewrite ``-0.0`` rows, and
    never a ``sum`` or ``index_add_``, which pick their own order. One
    ``[R, d]`` slab is gathered per (group, element) inside the fold, so
    the ``[R, G, E, d]`` element tensor is never materialized, and a slot
    that is padding on every row is skipped (the select would keep
    ``acc``). ``uint32`` values add on their ``int32`` view (the same
    wrapped bits; torch has no ``uint32`` add).
    """
    device = resolve_device(device)
    a_idx, g_idx, g_mask = degraded_dense_plan(program, failed)
    q, k, K = program.q, program.k, program.K
    J_own = q ** (k - 2)
    J = a_idx.shape[0] // K
    Gm, Em = g_idx.shape[1], g_idx.shape[2]
    shape = (K, J_own, k - 1, K, d)
    arith = torch.int32 if dtype == torch.uint32 else dtype

    def idx(a):
        return torch.as_tensor(a.astype(np.int64), device=device)

    def mask(m):
        """A slot's ``[R, 1]`` select, or None where no row is real."""
        return torch.as_tensor(m[:, None], device=device) if m.any() \
            else None

    ai = idx(a_idx)
    # per group: its element slabs' row indices and masks, then the
    # group's own mask in the outer fold (group 0 and every group's
    # element 0 are real on every row)
    groups = [([idx(g_idx[:, g, e]) for e in range(Em)],
               [mask(g_mask[:, g, e]) for e in range(Em)],
               mask(g_mask[:, g].any(axis=-1)))
              for g in range(Gm)]

    def run(contribs: torch.Tensor) -> torch.Tensor:
        if (tuple(contribs.shape) != shape or contribs.dtype != dtype
                or contribs.device != device):
            raise ValueError(
                f"degraded executor for {shape} {dtype} on {device} got "
                f"{tuple(contribs.shape)} {contribs.dtype} on "
                f"{contribs.device}")
        flat = contribs.reshape(-1, d).view(arith)       # [F, d]
        B = None
        for g, (rows, masks, valid) in enumerate(groups):
            acc = flat.index_select(0, rows[0])
            for e in range(1, Em):
                if masks[e] is not None:
                    v = flat.index_select(0, rows[e])
                    acc = torch.where(masks[e], acc + v, acc)
                    del v
            B = acc if g == 0 else torch.where(valid, B + acc, B)
            del acc
        A = flat.index_select(0, ai)
        return A.add_(B).view(K, J, d).view(dtype)       # A + B

    return run
