"""Executable aggregated-MapReduce engine (single-host simulator of K servers).

Runs the full CAMR pipeline — Map, per-batch Combine (the paper's
"aggregation"), 3-stage coded Shuffle, Reduce — with *honest* receiver-side
decoding: every XOR cancellation uses only aggregates recomputed from the
receiver's own map outputs (the Lemma-2 storage condition), and every byte
on the wire is accounted in a :class:`~repro.core.shuffle.ShuffleTrace`.

The engine is the reference oracle for the TPU/shard_map implementation in
:mod:`repro.core.collective` and the test bed for the paper's Examples 1-5.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .designs import ResolvableDesign
from .placement import Placement
from .schedule import SCHEDULE_CACHE, ShuffleProgram
from .shuffle import (
    ShuffleTrace,
    Transmission,
    coded_multicast_schedule,
    decode_coded_multicast,
)

__all__ = ["CAMRConfig", "CAMREngine", "run_wordcount_example"]

Combine = Callable[[np.ndarray, np.ndarray], np.ndarray]


@dataclass(frozen=True)
class CAMRConfig:
    """Scheme parameters. ``Q`` must be a multiple of ``K`` (paper §II)."""

    q: int
    k: int
    gamma: int = 1
    Q: int | None = None  # defaults to K

    @property
    def K(self) -> int:
        return self.q * self.k

    @property
    def J(self) -> int:
        return self.q ** (self.k - 1)

    @property
    def N(self) -> int:
        return self.k * self.gamma

    def num_functions(self) -> int:
        Q = self.K if self.Q is None else self.Q
        if Q % self.K:
            raise ValueError("Q must be a multiple of K")
        return Q


@dataclass
class _ServerState:
    """Local state of one simulated server."""

    # (job, batch) -> (Q, d) array of per-batch aggregates, one row per fn
    agg: dict[tuple[int, int], np.ndarray] = field(default_factory=dict)
    # decoded stage-1/2 values: (job, batch, qfunc) -> (d,) array
    recv_batch: dict[tuple[int, int, int], np.ndarray] = field(
        default_factory=dict)
    # decoded stage-3 values: (job, qfunc) -> (d,) aggregate of k-1 batches
    recv_rest: dict[tuple[int, int], np.ndarray] = field(default_factory=dict)
    map_invocations: int = 0


class CAMREngine:
    """Execute J aggregated-MapReduce jobs on K simulated servers.

    Parameters
    ----------
    cfg
        Scheme parameters (q, k, gamma, Q).
    map_fn
        ``map_fn(job, subfile_payload) -> (Q, d) float/int array``; row ``f``
        is the intermediate value of output function ``f`` on that subfile.
    combine
        Associative+commutative pairwise combiner (default ``np.add`` —
        linear aggregation). Applied elementwise to value arrays.
    """

    def __init__(self, cfg: CAMRConfig, map_fn, combine: Combine = np.add,
                 label_perm=None):
        self.cfg = cfg
        # the engine is a numpy interpreter of the compiled schedule —
        # the SAME tables the SPMD collective executes (schedule.py);
        # the structural SCHEDULE_CACHE shares one lowering (and one
        # design/placement) across every engine of a configuration.
        self.program: ShuffleProgram = SCHEDULE_CACHE.program(
            cfg.q, cfg.k, gamma=cfg.gamma, Q=cfg.num_functions(),
            label_perm=label_perm, device_tables=False)
        self.design: ResolvableDesign = self.program.design
        self.placement: Placement = self.program.placement
        self.map_fn = map_fn
        self.combine = combine
        self.trace = ShuffleTrace()
        self.servers = [_ServerState() for _ in range(cfg.K)]
        self._value_dim: int | None = None
        self._dtype = None
        #: per-server wall seconds spent in the last map phase — the
        #: wave-timing signal the elastic runtime's straggler detector
        #: consumes (repro.runtime.fault.Membership.observe).
        self.map_times = np.zeros(cfg.K)

    # ------------------------------------------------------------------ #
    # function assignment: server s reduces functions {s, s+K, ...}
    # ------------------------------------------------------------------ #
    def functions_of(self, server: int) -> list[int]:
        Q = self.cfg.num_functions()
        return list(range(server, Q, self.cfg.K))

    # ------------------------------------------------------------------ #
    # phases
    # ------------------------------------------------------------------ #
    def run(self, datasets: Sequence[Sequence]) -> list[dict[int, np.ndarray]]:
        """Run all phases. ``datasets[j][n]`` is subfile n of job j.

        Returns ``results`` with ``results[s][ (j, f) ] = reduced value`` for
        every function ``f`` assigned to server ``s`` and every job ``j``.
        """
        d = self.design
        if len(datasets) != d.J:
            raise ValueError(f"need {d.J} job datasets, got {len(datasets)}")
        for ds in datasets:
            if len(ds) != self.placement.N:
                raise ValueError(
                    f"each job needs N={self.placement.N} subfiles")
        self.map_phase(datasets)
        self.shuffle_phase()
        return self.reduce_phase()

    def reset(self) -> None:
        """Clear all per-run state (aggregates, decoded values, trace)."""
        self.trace = ShuffleTrace()
        self.servers = [_ServerState() for _ in range(self.cfg.K)]
        self._value_dim = None
        self._dtype = None
        self.map_times = np.zeros(self.cfg.K)

    def run_stream(self, waves) -> list:
        """Serial multi-wave loop: :meth:`run` on each element of
        ``waves`` (a sequence of per-wave ``datasets``) with fresh state
        in between. This is the correctness oracle the pipelined
        :class:`repro.runtime.jobstream.JobStream` must match
        bit-for-bit (DESIGN.md §9)."""
        out = []
        for datasets in waves:
            self.reset()
            out.append(self.run(datasets))
        return out

    def map_phase(self, datasets) -> None:
        pl, d = self.placement, self.design
        for s in range(d.K):
            t_start = time.perf_counter()
            st = self.servers[s]
            for job, t in pl.stored_batches(s):
                vals = []
                for n in pl.batch_subfiles(t):
                    v = np.asarray(self.map_fn(job, datasets[job][n]))
                    if v.ndim != 2 or v.shape[0] != self.cfg.num_functions():
                        raise ValueError(
                            f"map_fn must return (Q, d), got {v.shape}")
                    vals.append(v)
                    st.map_invocations += 1
                agg = vals[0]
                for v in vals[1:]:
                    agg = self.combine(agg, v)  # per-batch aggregation
                st.agg[(job, t)] = agg
                self._value_dim = agg.shape[1]
                self._dtype = agg.dtype
            self.map_times[s] = time.perf_counter() - t_start

    # -- payload helpers ------------------------------------------------ #
    def _ser(self, arr: np.ndarray) -> bytes:
        return np.ascontiguousarray(arr).tobytes()

    def _de(self, raw: bytes) -> np.ndarray:
        return np.frombuffer(raw, dtype=self._dtype).copy()

    @property
    def value_bytes(self) -> int:
        """B in the paper — size of one intermediate/aggregate value."""
        return self._value_dim * np.dtype(self._dtype).itemsize

    def shuffle_phase(self) -> None:
        ngroups = self.cfg.num_functions() // self.cfg.K
        for g in range(ngroups):  # Q/K repetitions (paper §II)
            self._stage1(g)
            self._stage2(g)
            self._stage3(g)

    def _run_coded_group(self, row: int, stage: int, fn_group: int) -> None:
        """Algorithm 2 on one group row of the compiled program: encode
        from holder aggregates, honest receiver-side decode."""
        K = self.cfg.K
        prog = self.program
        G = prog.group_members(row)
        specs = prog.coded_chunks(row)           # [(receiver, job, batch)]
        # true chunk values, computed from any holder's map outputs and
        # cross-checked across all holders (deterministic map).
        chunks: dict[int, bytes] = {}
        for kp, job, batch in specs:
            qf = fn_group * K + kp
            holders = [s for s in G if s != kp]
            vals = [self.servers[h].agg[(job, batch)][qf]
                    for h in holders]
            for v in vals[1:]:
                np.testing.assert_array_equal(vals[0], v)
            chunks[kp] = self._ser(vals[0])
        txs = coded_multicast_schedule(
            G, chunks, stage=stage, tag=("group", G, "fn", fn_group))
        for t in txs:
            self.trace.add(t)
        # honest decode at every receiver, from ITS OWN aggregates
        clen = len(next(iter(chunks.values())))
        for kp, job, batch in specs:
            known = {}
            for kp2, job2, batch2 in specs:
                if kp2 == kp:
                    continue
                qf2 = fn_group * K + kp2
                own = self.servers[kp].agg.get((job2, batch2))
                if own is None:
                    raise AssertionError(
                        "Lemma-2 condition violated: receiver cannot "
                        "recompute a cancellation chunk")
                known[kp2] = self._ser(own[qf2])
            dec = decode_coded_multicast(G, kp, txs, known, clen)
            qf = fn_group * K + kp
            self.servers[kp].recv_batch[(job, batch, qf)] = self._de(dec)

    def _coded_stage(self, stage: int, fn_group: int) -> None:
        """Interpret stages 1/2 of the program (shared machinery)."""
        for row in self.program.stage_rows(stage):
            self._run_coded_group(int(row), stage, fn_group)

    def _stage1(self, fn_group: int) -> None:
        self._coded_stage(1, fn_group)

    def _stage2(self, fn_group: int) -> None:
        self._coded_stage(2, fn_group)

    def _stage3(self, fn_group: int) -> None:
        K = self.cfg.K
        prog = self.program
        for i in range(len(prog.s3_job)):
            job = int(prog.s3_job[i])
            rcv = int(prog.s3_recv[i])
            snd = int(prog.s3_send[i])
            qf = fn_group * K + rcv
            sender_st = self.servers[snd]
            acc = None
            for t in prog.s3_batches[i]:
                v = sender_st.agg[(job, int(t))][qf]
                acc = v if acc is None else self.combine(acc, v)
            payload = self._ser(acc)
            self.trace.add(Transmission(
                stage=3, sender=snd, receivers=(rcv,),
                payload=payload, tag=("job", job, "fn", fn_group)))
            self.servers[rcv].recv_rest[(job, qf)] = self._de(payload)

    def reduce_phase(self) -> list[dict[tuple[int, int], np.ndarray]]:
        # Canonical combine order (the bit-identity contract every
        # executor of the schedule honors — collective.py, baselines.py,
        # fault.py): value = delivered_batch + fold_asc(other k-1
        # batches), where fold_asc is a sequential left fold in
        # ascending batch order. With a deterministic combiner this
        # makes all executors BITWISE equal, not merely allclose.
        pl, d = self.placement, self.design
        results: list[dict[tuple[int, int], np.ndarray]] = []
        for s in range(d.K):
            st = self.servers[s]
            out: dict[tuple[int, int], np.ndarray] = {}
            for qf in self.functions_of(s):
                for j in range(d.J):
                    if d.is_owner(s, j):
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
                        # stage-2 value covers the class-mate owner's missing
                        # batch; stage-3 value covers the other k-1 batches
                        # (already an ascending fold at the sender).
                        cls = d.class_of(s)
                        (l,) = [u for u in d.owners[j]
                                if d.class_of(u) == cls]
                        tl = pl.batch_of_label(j, l)
                        acc = self.combine(st.recv_batch[(j, tl, qf)],
                                           st.recv_rest[(j, qf)])
                    out[(j, qf)] = acc
            results.append(out)
        return results

    # ------------------------------------------------------------------ #
    # verification helpers
    # ------------------------------------------------------------------ #
    def oracle(self, datasets) -> dict[tuple[int, int], np.ndarray]:
        """Uncoded single-machine ground truth for every (job, function)."""
        out = {}
        for j in range(self.design.J):
            vals = [np.asarray(self.map_fn(j, sf)) for sf in datasets[j]]
            acc = vals[0]
            for v in vals[1:]:
                acc = self.combine(acc, v)
            for qf in range(self.cfg.num_functions()):
                out[(j, qf)] = acc[qf]
        return out

    def verify(self, datasets, results) -> None:
        oracle = self.oracle(datasets)
        for s, res in enumerate(results):
            for (j, qf), v in res.items():
                np.testing.assert_allclose(
                    v, oracle[(j, qf)], rtol=1e-6, atol=1e-6,
                    err_msg=f"server {s} job {j} fn {qf}")

    def measured_loads(self) -> dict[str, float]:
        """Per-stage + total load, both cost models (DESIGN.md §3)."""
        J, Q, B = self.design.J, self.cfg.num_functions(), self.value_bytes
        out = {}
        for model in ("bus", "p2p"):
            for st in (1, 2, 3):
                out[f"L_stage{st}_{model}"] = self.trace.load(
                    J, Q, B, stage=st, model=model)
            out[f"L_total_{model}"] = self.trace.load(J, Q, B, model=model)
        return out


# --------------------------------------------------------------------- #
# the paper's running example, runnable end to end
# --------------------------------------------------------------------- #
def run_wordcount_example(q: int = 2, k: int = 3, gamma: int = 2,
                          vocab: int | None = None, seed: int = 0):
    """Paper Example 1: J jobs counting Q words in N-chapter books.

    Returns (engine, results, loads). Each subfile is a chapter = array of
    word ids; function f counts word f. Uses d=1 values (a count).
    """
    cfg = CAMRConfig(q=q, k=k, gamma=gamma)
    Q = cfg.num_functions()
    vocab = vocab or Q
    rng = np.random.default_rng(seed)
    datasets = [
        [rng.integers(0, vocab, size=50) for _ in range(cfg.N)]
        for _ in range(cfg.J)
    ]

    def map_fn(job, chapter):
        counts = np.bincount(chapter % Q, minlength=Q).astype(np.int64)
        return counts[:, None]  # (Q, 1)

    eng = CAMREngine(cfg, map_fn)
    results = eng.run(datasets)
    eng.verify(datasets, results)
    return eng, results, eng.measured_loads()
