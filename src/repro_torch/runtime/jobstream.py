"""JobStream — a pipelined multi-wave CAMR runtime (DESIGN.md §9).

A *wave* is one complete CAMR execution: ``J = q**(k-1)`` aggregated
MapReduce jobs pushed through Map -> per-batch Combine -> 3-stage coded
Shuffle -> Reduce on the ``K = q*k``-server cluster. The serial baseline
(:meth:`repro.core.engine.CAMREngine.run_stream`) runs waves strictly
one at a time — the shuffle machinery idles during map and vice versa,
exactly the waste the coded-MapReduce line of work (Li et al.,
1512.01625 / 1604.07086) identifies as dominating job time.

:class:`JobStream` streams heterogeneous waves through the cluster with
three cooperating mechanisms, all byte-preserving:

* **schedule caching** — every engine pulls its lowered
  :class:`~repro.core.schedule.ShuffleProgram` (and any degraded
  re-lowering) from the structural
  :data:`~repro.core.schedule.SCHEDULE_CACHE`, so lowering cost is paid
  once per ``(q, k, gamma, label_perm, Q, survivor-set)`` configuration
  instead of once per wave.
* **wave batching** — same-shaped waves are stacked along the value
  axis ``d`` and run as a SINGLE ShuffleProgram execution. The XOR
  codec and any elementwise combiner act independently per value
  element, so concatenation commutes with the whole pipeline and the
  split results are bit-identical to serial runs (tested in
  tests/test_jobstream.py).
* **software pipelining** — the map/aggregate phase of batch ``t+1``
  runs on a prefetch thread while the main thread drives the shuffle +
  reduce of batch ``t`` (double buffering: at most TWO batches of
  aggregates are alive at any time; memory cost model in DESIGN.md §9).

The SPMD counterpart — async, double-buffered dispatch of the shard_map
executor — is :class:`repro.core.collective.ShuffleStream`; this module
is the host-side runtime and the bit-exact reference for it.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.core.schedule import SCHEDULE_CACHE

__all__ = ["JobSpec", "JobStream", "StreamReport"]

def _check_wave_dtype(dtype, where: str) -> None:
    """Entry guard for half-precision value dtypes.

    The numpy engine XORs raw bytes, so every full-width dtype (and
    sub-word integers) transports losslessly, as it always has. 16-bit
    floats are accepted exactly when the SPMD codec lists a wire lane
    for them — :data:`repro.core.collective.PACKED_DTYPES`, backed by
    :data:`~repro.core.collective.CODEC_DTYPES` as the single source
    of truth (DESIGN.md §12) — so this guard and the collective's can
    never drift apart. Today both halves are packed-lane members and
    the raise arm is a tripwire against a future lane removal.
    """
    from repro_torch.core.collective import CODEC_DTYPES, PACKED_DTYPES

    dt = np.dtype(dtype)
    half_float = (dt.itemsize == 2
                  and (dt.kind == "f" or dt.name == "bfloat16"))
    if half_float and dt.name not in CODEC_DTYPES:
        raise TypeError(
            f"{where}: {dt.name} values have no codec wire lane; the "
            f"packed 16-bit lane covers {', '.join(PACKED_DTYPES)} "
            "(DESIGN.md §12) — cast the map outputs "
            "(v.astype(np.float32)) or use a supported dtype.")


@dataclass(frozen=True)
class JobSpec:
    """One wave submitted to a :class:`JobStream`.

    ``datasets[j][n]`` is subfile ``n`` of job ``j`` (the engine's
    :meth:`~repro.core.engine.CAMREngine.run` input); ``map_fn`` and
    ``combine`` follow the engine's contract. Waves batch together only
    when they share :meth:`shape_key` — the schedule shape AND the
    combiner (stacking along ``d`` requires the same elementwise
    combine on both sides of the seam). Waves in one batch must also
    produce the same value dtype (``np.concatenate`` would silently
    promote mixed dtypes, changing the bits): declare ``value_dtype``
    to pre-split mixed-dtype streams into separate batches; undeclared
    mismatches are detected at map time and raise.
    """

    cfg: CAMRConfig
    map_fn: Callable
    datasets: Sequence = field(repr=False)
    combine: Callable = np.add
    name: str = ""
    value_dtype: object = None

    def __post_init__(self):
        if self.value_dtype is not None:
            _check_wave_dtype(self.value_dtype,
                              f"JobSpec {self.name!r}")

    def shape_key(self) -> tuple:
        c = self.cfg
        dt = (None if self.value_dtype is None
              else np.dtype(self.value_dtype).str)
        return (c.q, c.k, c.gamma, c.num_functions(), self.combine, dt)


@dataclass
class StreamReport:
    """What the last :meth:`JobStream.run` did (for benchmarks/tests)."""

    waves: int
    batches: int
    cache_hits: int       # SCHEDULE_CACHE hits during the run
    cache_misses: int     # lowerings actually paid during the run
    pipelined: bool
    migrations: int = 0   # in-flight engine re-targets (elastic runs)
    batch_times: list = field(default_factory=list)  # wall s per batch
                          # completion (elastic recovery-gap signal)


class JobStream:
    """Pipelined multi-wave scheduler over the numpy CAMR engine.

    Parameters
    ----------
    failed
        Optional failed-server set: waves run on the degraded cluster
        via :class:`repro.runtime.fault.DegradedCAMREngine`, whose
        survivor-set re-lowering is served from the schedule cache.
    batching
        Stack same-shaped waves along ``d`` into one engine pass
        (default on). ``wave_batch`` caps the stack width — the default
        of 4 keeps batches small enough that homogeneous streams still
        pipeline and bounds live memory at ``2 * wave_batch`` waves'
        aggregates (the double buffer); ``wave_batch=None`` removes the
        cap (one maximal batch per shape, no overlap within a shape).
    pipeline
        Overlap map/aggregate of the next batch with shuffle+reduce of
        the current one on a prefetch thread (default on).
    elastic
        Live-churn controller (:class:`repro.runtime.fault
        .ElasticController`, or a bare :class:`~repro.runtime.fault
        .Membership` which gets wrapped): workers may die, straggle and
        rejoin BETWEEN batches. Each batch's engine is built against
        the survivor set at its map time, re-targeted (zero map
        recompute, warm-cache re-lowering) right before its shuffle if
        membership moved while it was in flight, and its per-server map
        timings feed the controller's straggler detector. Results come
        back in LOGICAL slots — bitwise-identical to the healthy serial
        oracle for every churn schedule (DESIGN.md §14). Mutually
        exclusive with the static ``failed`` set.
    """

    DEFAULT_WAVE_BATCH = 4

    def __init__(self, *, failed: set[int] | None = None,
                 batching: bool = True,
                 wave_batch: int | None = DEFAULT_WAVE_BATCH,
                 pipeline: bool = True, elastic=None):
        if wave_batch is not None and wave_batch < 1:
            raise ValueError("wave_batch must be >= 1 (or None for "
                             "no cap)")
        if elastic is not None and failed:
            raise ValueError(
                "failed= is a static survivor set; elastic= manages "
                "membership live — pass the kill to the controller "
                "(membership.kill) instead of both")
        if elastic is not None:
            from repro_torch.runtime.fault import (ElasticController,
                                             Membership)
            if isinstance(elastic, Membership):
                elastic = ElasticController(elastic)
        self.elastic = elastic
        self.failed = set(failed) if failed else None
        self.batching = batching
        self.wave_batch = wave_batch
        self.pipeline = pipeline
        self.last_report: StreamReport | None = None
        #: engines of the last run, one per batch in completion order —
        #: byte accounting (``.trace``) and degraded-mode migration
        #: (``.migrate_target``) for callers like the training loop.
        self.last_engines: list = []

    # ------------------------------------------------------------------ #
    # batching plan
    # ------------------------------------------------------------------ #
    def _plan_batches(self, specs: list[JobSpec]) -> list[list[int]]:
        """Group submission indices by shape key (first-seen order),
        splitting groups at ``wave_batch``."""
        if not self.batching:
            return [[i] for i in range(len(specs))]
        groups: dict = {}
        order: list = []
        for i, sp in enumerate(specs):
            key = sp.shape_key()
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(i)
        cap = (max((len(v) for v in groups.values()), default=1)
               if self.wave_batch is None else self.wave_batch)
        out = []
        for key in order:
            idxs = groups[key]
            out.extend(idxs[a:a + cap] for a in range(0, len(idxs), cap))
        return out

    # ------------------------------------------------------------------ #
    # one batch = one engine pass over d-stacked waves
    # ------------------------------------------------------------------ #
    def _make_engine(self, specs: list[JobSpec], idxs: list[int],
                     failed=None):
        """Build the batched engine + datasets for one batch.

        Returns ``(engine, datasets, widths)`` where ``widths[w]`` is
        filled with wave ``w``'s value width after the map phase runs.
        ``failed`` overrides the stream's static set (elastic runs pass
        the controller's survivor set at map time).
        """
        batch = [specs[i] for i in idxs]
        cfg = batch[0].cfg
        W = len(batch)
        widths: list = [None] * W

        def map_fn(job, subfiles):
            vals = []
            for w, sp in enumerate(batch):
                v = np.asarray(sp.map_fn(job, subfiles[w]))
                _check_wave_dtype(v.dtype, f"JobStream wave {sp.name!r}")
                widths[w] = v.shape[1] if v.ndim == 2 else None
                vals.append(v)
            if W == 1:
                return vals[0]
            if len({v.dtype for v in vals}) > 1:
                raise ValueError(
                    "waves with different value dtypes cannot be "
                    "stacked bit-exactly (np.concatenate would "
                    "promote); declare JobSpec.value_dtype so they "
                    "batch separately, or run with batching=False: "
                    f"{[str(v.dtype) for v in vals]}")
            return np.concatenate(vals, axis=1)

        J, N = cfg.J, cfg.N
        for sp in batch:
            # same checks CAMREngine.run applies — truncating or
            # index-erroring here would diverge from the serial oracle
            if len(sp.datasets) != J:
                raise ValueError(
                    f"spec {sp.name!r}: need {J} job datasets, got "
                    f"{len(sp.datasets)}")
            for ds in sp.datasets:
                if len(ds) != N:
                    raise ValueError(
                        f"spec {sp.name!r}: each job needs N={N} "
                        "subfiles")
        datasets = [
            [tuple(sp.datasets[j][n] for sp in batch) for n in range(N)]
            for j in range(J)
        ]
        failed = self.failed if failed is None else (set(failed) or None)
        if failed:
            from repro_torch.runtime.fault import DegradedCAMREngine
            eng = DegradedCAMREngine(cfg, map_fn, failed,
                                     combine=batch[0].combine)
        else:
            eng = CAMREngine(cfg, map_fn, combine=batch[0].combine)
        return eng, datasets, widths

    @staticmethod
    def _split_results(results, widths: list) -> list:
        """Slice per-server ``(job, fn) -> (sum(widths),)`` values back
        into per-wave result structures (submission order preserved by
        the caller)."""
        offs = np.concatenate([[0], np.cumsum(widths)])
        out = []
        for w in range(len(widths)):
            a, b = int(offs[w]), int(offs[w + 1])
            out.append([{key: v[a:b] for key, v in res.items()}
                        for res in results])
        return out

    # ------------------------------------------------------------------ #
    # the stream
    # ------------------------------------------------------------------ #
    def run(self, specs: Sequence[JobSpec]) -> list:
        """Run every wave; returns per-wave results in submission order
        (each exactly what :meth:`CAMREngine.run` returns for that
        wave — bit-identical to the serial oracle)."""
        specs = list(specs)
        self.last_engines = []
        if not specs:
            self.last_report = StreamReport(
                waves=0, batches=0, cache_hits=0, cache_misses=0,
                pipelined=False)
            return []
        results: list = [None] * len(specs)
        batches = self._plan_batches(specs)
        s0 = SCHEDULE_CACHE.stats()
        ctrl = self.elastic
        migrations = 0
        batch_times: list[float] = []
        t_mark = [time.perf_counter()]

        def prepare(bi, idxs):
            # dataset validation + map phase: the prefetch-lane half of
            # the pipeline. Elastic runs map against the survivor set
            # at map time; a later membership change is absorbed by the
            # re-target in finish (the map state is survivor-agnostic —
            # every server maps its stored batches regardless).
            failed = ctrl.wave_start(bi) if ctrl is not None else None
            eng, datasets, widths = self._make_engine(specs, idxs,
                                                      failed=failed)
            eng.map_phase(datasets)
            return eng, widths, idxs

        def finish(bi, eng, widths, idxs):
            nonlocal migrations
            if ctrl is not None:
                # membership may have moved while this batch was in
                # flight: swap the shuffle schedule to the CURRENT
                # survivor set (warm-cache lookup, adopts the mapped
                # aggregates — no map recompute)
                from repro_torch.runtime.fault import retarget_engine
                eng2 = retarget_engine(eng, ctrl.current_failed())
                if eng2 is not eng:
                    migrations += 1
                    eng = eng2
            eng.shuffle_phase()
            res = eng.reduce_phase()
            if ctrl is not None and getattr(eng, "failed", None):
                res = self._logical_slots(eng, res)
            split = self._split_results(res, widths)
            for w, spec_idx in enumerate(idxs):
                results[spec_idx] = split[w]
            self.last_engines.append(eng)
            if ctrl is not None:
                ctrl.wave_timings(bi, eng.map_times)
            now = time.perf_counter()
            batch_times.append(now - t_mark[0])
            t_mark[0] = now

        pipelined = self.pipeline and len(batches) > 1
        if pipelined:
            # double buffer: while batch t shuffles+reduces here, batch
            # t+1 maps on the worker — at most 2 engines alive
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(prepare, 0, batches[0])
                for t in range(len(batches)):
                    eng, widths, idxs = fut.result()
                    if t + 1 < len(batches):
                        fut = pool.submit(prepare, t + 1, batches[t + 1])
                    finish(t, eng, widths, idxs)
        else:
            for t, idxs in enumerate(batches):
                finish(t, *prepare(t, idxs))

        if ctrl is not None:
            ctrl.migrations += migrations
        s1 = SCHEDULE_CACHE.stats()
        self.last_report = StreamReport(
            waves=len(specs), batches=len(batches),
            cache_hits=s1["hits"] - s0["hits"],
            cache_misses=s1["misses"] - s0["misses"],
            pipelined=pipelined, migrations=migrations,
            batch_times=batch_times)
        return results

    @staticmethod
    def _logical_slots(eng, results) -> list:
        """Degraded engine results -> logical per-server slots.

        A degraded reduce leaves a failed server's functions on its
        migrate target (``results[failed] == {}``). Elastic callers are
        owed the HEALTHY result shape — server ``s``'s functions in
        slot ``s`` — and since degraded values are bitwise-identical to
        healthy values (the canonical-order contract, DESIGN.md §11),
        relocating them restores the exact serial-oracle output."""
        K = eng.cfg.K
        return [{key: val
                 for key, val in results[eng.migrate_target(s)].items()
                 if key[1] % K == s}
                for s in range(K)]
