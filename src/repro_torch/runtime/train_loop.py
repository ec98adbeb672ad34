"""Training loops of the port.

* :class:`Trainer` — the single-model loop, the twin of
  ``repro.runtime.train_loop.Trainer``: microbatch gradient accumulation,
  the cosine schedule and AdamW (global-norm clip), on the trainer's
  device, async checkpoints in the JAX trainer's format and crash-resume.
* :class:`MultiModelCAMRTrainer` — the paper's setting: J = q^(k-1)
  models whose per-batch gradients are aggregated through the CAMR
  coded shuffle, on the f32 or the bf16 grad-sync lane.

The multi-model step, in ``mode="camr_spmd"``:

1. **map** — every (job, subfile) batch is mapped once to the gradient of
   its model's loss w.r.t. the flat f32 parameter row (computation
   redundancy k-1 is served from a per-step memo); on the bf16 lane each
   memo row is rounded to bf16 once, to nearest even;
2. **aggregate** — each worker compresses the gradients of its stored
   (job, batch) pairs with the alpha-combiner kernel
   (:func:`repro_torch.kernels.aggregate`, one launch per worker, f32 or
   bf16) into its rows of the stacked contribution tensor
   ``[K, J_own, k-1, K, d]`` in the sync dtype; the memo is dropped once
   the contributions are built;
3. **shuffle** — the 3-stage coded shuffle of all K virtual workers
   (:class:`repro_torch.core.collective.ShuffleStream`; on the default
   fused codec one encode and one decode kernel launch per coded stage,
   the 16-bit codec kernels on the bf16 lane at half the wire bytes; on
   the ``codec="multipass"`` oracle one ``xor_fold`` and one
   ``xor_decode`` launch per coded stage, bitwise the same result);
4. **update** — the synced gradient upcast to f32 (exact), then the
   worker-sharded AdamW update of the flat f32 ``[J, Dpad]`` master,
   moments updated in place.

The paper's two host wires run the same map on the device and send
each memo row to the host once: ``mode="camr"`` drives the numpy
:class:`~repro_torch.core.engine.CAMREngine` through a
:class:`~repro_torch.runtime.jobstream.JobStream` wave (byte-exact
accounting), ``mode="uncoded"`` the unicast baseline
:class:`~repro_torch.core.baselines.UncodedAggregatedEngine`. Their
``[K, J, d]`` result goes back to the device into the same update. On
the bf16 lane the engines see the rows as ``uint16`` bit patterns and
combine them with :func:`bf16_add` (numpy has no bf16). All three modes
give bitwise the same parameters on each lane: the XOR transport is
lossless and every executor folds in the engine's canonical order. In
the host modes, ``phase_ms``'s "aggregate" is the copy of the memo to
the host and "shuffle" the engine's run (its per-batch combine, the
shuffle and the reduce) with the copy back.

A failed-worker set (``failed=``, :meth:`MultiModelCAMRTrainer
.set_failed`) keeps every worker's map and aggregate: failed workers are
silent only in the shuffle. ``camr_spmd`` then runs the stream's
degraded survivor-set executor in place of the coded shuffle (no gather
launch), ``camr`` the numpy ``DegradedCAMREngine``; a shard of a failed
worker is reduced on its migrate target.

The camr_spmd step stays on the card: the JAX trainer's host round trip
of each gradient is not carried over there. Float32 products run in full
f32: while a trainer runs on a card, TF32 and reduced-precision bf16
reductions are switched off, and the caller's settings are restored when
it returns. The synced gradient of the same per-subfile gradients is
bitwise the JAX trainer's, on both lanes; parameters match it within
tolerance (the clip norm sums in another order).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import ModelConfig
from ..core import loads as Lo
from ..core.baselines import UncodedAggregatedEngine
from ..core.collective import (CODECS, ShuffleStream, camr_collective_bytes,
                               make_plan)
from ..core.engine import CAMRConfig, CAMREngine
from ..core.spans import Recorder, span
from ..data.pipeline import ShardedTokenPipeline, make_camr_job_datasets
from ..device import resolve_device
from ..kernels.aggregate import aggregate
from ..models import lm
from ..optim import AdamWState, adamw_update, cosine_schedule
from ..weights import flat_spec, leaves, ravel, split, tree, unravel
from .jobstream import JobSpec, JobStream

__all__ = ["CAMRTrainReport", "MultiModelCAMRTrainer", "PHASES", "SPANS",
           "Trainer", "bf16_add"]

#: the multi-model trainer's grad-sync wires
MODES = ("camr", "camr_spmd", "uncoded")

#: the step's phases, in order, as timed in ``CAMRTrainReport.phase_ms``
PHASES = ("map", "aggregate", "shuffle", "update")
#: the spans inside the phases (:mod:`repro_torch.core.spans`), in the
#: order ``CAMRTrainReport.phase_ms`` reports them
SPANS = ("map.feed", "map.upload", "map.forward", "map.backward", "map.row",
         "aggregate.upload", "aggregate.stack", "aggregate.kernel",
         "shuffle.wire", "shuffle.encode", "shuffle.exchange",
         "shuffle.decode", "shuffle.stage3", "shuffle.assemble",
         "update.gather", "update.clip", "update.adamw")


@dataclass
class CAMRTrainReport:
    loads: dict = field(default_factory=dict)
    bytes_total: int = 0
    losses: list = field(default_factory=list)
    mode: str = ""
    sync: dict = field(default_factory=dict)   # executor-reuse stats
    grad_sync_dtype: str = "float32"           # shuffle payload dtype
    #: per step, a dict of milliseconds: first each of :data:`PHASES`
    #: (CUDA events on a card, the host clock on the CPU; consecutive
    #: phases share their marks), then for each of :data:`SPANS` in order
    #: ``<span>`` (its device ms, timed as a phase is) and ``<span>:host``
    #: (the host clock from enter to exit), each summed over the step's
    #: calls. Every key is present in every step of every mode, 0.0
    #: where the span did not run (the shuffle's parts in the host
    #: modes, for one).
    phase_ms: list = field(default_factory=list)


def _phase_ms(times: dict) -> dict:
    """A read :class:`~repro_torch.core.spans.Recorder` -> one step's
    ``phase_ms`` dict."""
    ms = {p: times[p][0] for p in PHASES}
    for name in SPANS:
        ms[name], ms[name + ":host"] = times.get(name, (0.0, 0.0))
    return ms


def _mean_losses(per_job: list) -> list[float]:
    """Per-job mean loss for one step (keyed by subfile index, so every
    grad-sync mode averages in the same order; an empty map is NaN)."""
    return [float(np.mean([d[n] for n in sorted(d)])) if d
            else float("nan") for d in per_job]


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (``uint16``), rounded to nearest even."""
    u = x.view(np.uint32)
    return ((u + ((u >> 16) & 1) + 0x7FFF) >> 16).astype(np.uint16)


def bf16_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The engines' combiner on the bf16 lane: ``a`` and ``b`` are bf16
    bit patterns (``uint16``); their sum is taken in f32 and rounded to
    nearest even, as ``np.add`` on ``ml_dtypes.bfloat16`` arrays (the JAX
    trainer's combiner) rounds it. One module-level function, so that
    :meth:`JobSpec.shape_key`, which keys on the combiner, sees one
    object."""
    f = lambda h: (np.asarray(h).astype(np.uint32) << 16).view(np.float32)
    return _bf16_bits(f(a) + f(b))


@contextlib.contextmanager
def _full_f32(device: torch.device):
    """No TF32 products and no reduced-precision bf16 reductions on a
    card for the duration; the process-wide flags are restored after."""
    if device.type != "cuda":
        yield
        return
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


class MultiModelCAMRTrainer:
    """Train J = q^(k-1) models with CAMR-coded gradient aggregation.

    ``params`` optionally gives the J initial parameter trees (e.g. from
    :func:`repro_torch.weights.params_from_jax`); otherwise each job's
    parameters are drawn from a ``torch.Generator`` seeded from
    ``(seed, job)`` on the trainer's device. ``device=None`` is the
    current CUDA device and raises when there is none.

    ``codec`` is the shuffle's XOR codec: ``"fused"`` (the gather
    kernels) or ``"multipass"`` (the oracle that materializes the chunk
    and cancellation tables; the same synced gradient, bitwise).

    ``failed`` (and :meth:`set_failed`, between steps) takes a
    failed-worker set: the failed workers map but are silent in the
    shuffle. ``camr_spmd`` then syncs through the stream's degraded
    survivor-set executor on the device (no gather launch), ``camr``
    through the numpy ``DegradedCAMREngine``; ``uncoded`` has no
    degraded mode and raises. Recovery is exact: a degraded step leaves
    the parameters bitwise those of the healthy step.

    ``spmd_oracle=True`` makes every ``camr_spmd`` step also run the
    numpy :class:`~repro_torch.core.engine.CAMREngine` on the same
    memoized gradients (the host rows the host wires take) and assert
    that the device's synced gradient equals it bitwise; the step's
    loads and bytes are then the engine's measured ones. Off by default:
    the engine is the oracle, not the fast path.

    ``grad_sync_dtype`` is the shuffle payload dtype: ``"float32"`` or
    ``"bfloat16"`` (mixed-precision grad sync: gradients rounded to bf16
    once at the map memo, synced on the packed 16-bit wire lane at half
    the bytes, upcast to f32 for the master update); ``None`` reads
    ``cfg.grad_sync_dtype``. ``float16`` is refused: raw gradients
    overflow and flush its 5-bit exponent, and there is no loss scaling.

    State layout (the JAX trainer's): parameters, moments and synced
    gradients are flat padded f32 rows of ``Dpad = K * d_shard`` elements
    per job, ``(k-1) | d_shard``; worker s owns shard s of every job.
    """

    def __init__(self, cfg: ModelConfig, *, q: int, k: int,
                 lr: float = 1e-3, seed: int = 0, params=None,
                 codec: str = "fused", router: str = "all_to_all",
                 device=None, grad_sync_dtype: str | None = None,
                 failed=None, spmd_oracle: bool = False):
        gsd = (cfg.grad_sync_dtype if grad_sync_dtype is None
               else grad_sync_dtype)
        name = str(gsd).removeprefix("torch.")
        if name == "float16":
            raise ValueError(
                "grad_sync_dtype=float16 is unsafe for raw gradients: "
                "the 5-bit exponent overflows above 65504 and flushes "
                "below ~6e-5, and this trainer implements no loss "
                "scaling. Use grad_sync_dtype='bfloat16' (same exponent "
                "range as float32, same 2x wire savings) or 'float32'.")
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"grad_sync_dtype must be float32 or "
                             f"bfloat16, got {name}")
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}")
        self.failed = set(failed) if failed else None
        self.spmd_oracle = spmd_oracle
        self.device = resolve_device(device)
        self.grad_sync_dtype = name
        self._sync_dtype = getattr(torch, name)
        #: the host engines' value dtype: f32, or the bf16 bit patterns
        self._sync_np = np.dtype(np.float32 if name == "float32"
                                 else np.uint16)
        self._combine = np.add if name == "float32" else bf16_add
        self.camr = CAMRConfig(q=q, k=k, gamma=1)
        self.cfg, self.q, self.k = cfg, q, k
        self.K, self.J, self.N = q * k, q ** (k - 1), k   # gamma = 1
        J, K = self.J, self.K
        if params is None:
            params = []
            for j in range(J):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(np.random.SeedSequence([seed, j])
                                    .generate_state(1)[0]))
                params.append(lm.init_params(cfg, gen))
        if len(params) != J:
            raise ValueError(f"params: need {J} trees (one per job), got "
                             f"{len(params)}")
        self._spec = flat_spec(params[0])
        self.D = self._spec.size
        # pad so the K function-shards are equal AND each shard splits
        # into k-1 codec packets
        d = -(-self.D // K)
        d += (-d) % (k - 1)
        self.d_shard = d
        self.Dpad = K * d
        self.flat = torch.zeros((J, self.Dpad), dtype=torch.float32,
                                device=self.device)    # f32 master [J, Dpad]
        for j in range(J):
            self.flat[j, :self.D] = ravel(params[j]).to(self.device,
                                                        torch.float32)
        del params
        self.opt = AdamWState(
            step=torch.zeros((J,), dtype=torch.int32, device=self.device),
            mu=torch.zeros_like(self.flat), nu=torch.zeros_like(self.flat))
        self.lr = lr
        self.step = 0
        self.codec, self.router = codec, router
        self._stream = None                    # lazy ShuffleStream
        self.map_calls = 0                     # gradient computations paid
        self.plan = make_plan(q, k, d)

    # ------------------------------------------------------------------ #
    @property
    def params(self) -> list:
        """Per-job parameter trees (cast views of the master rows)."""
        return [unravel(self.flat[j], self._spec) for j in range(self.J)]

    def _grad_vec(self, j: int, n: int, batch) -> torch.Tensor:
        """Loss gradient of job j on one subfile as a flat row ``[Dpad]``
        in the sync dtype (zero past ``D``): autograd to each cast leaf,
        then one concatenation in flat order. The gradient of
        ``ravel_pytree``'s f32 -> leaf-dtype cast is the leaf gradient
        cast back to f32; a flat row with ``requires_grad`` and sliced
        views would cost one zero-filled ``[Dpad]`` buffer per leaf in
        the backward pass. On the bf16 lane the concatenation rounds each
        leaf gradient to nearest even straight into the bf16 row (exact
        for bf16 leaves, one rounding for f32 ones): the JAX trainer's
        rounding of its f32 flat gradient, with no f32 row in between."""
        with span("map.upload"):         # from pageable memory: blocks
            b = {key: torch.as_tensor(v, device=self.device)
                 for key, v in batch.items()}
        with span("map.forward"):
            ps = [t.detach().requires_grad_(True)
                  for t in split(self.flat[j], self._spec)]
            loss, _ = lm.train_loss(self.cfg, tree(self._spec, ps), b)
        with span("map.backward"):
            grads = torch.autograd.grad(loss, ps)
        self._last_loss[j][n] = loss.detach()
        self.map_calls += 1
        with span("map.row"):
            row = torch.empty(self.Dpad, dtype=self._sync_dtype,
                              device=self.device)
            torch.cat([g.reshape(-1) for g in grads], out=row[:self.D])
            row[self.D:] = 0
        return row

    def _build_contribs(self, map_fn, datasets) -> torch.Tensor:
        """The map lane of the SPMD path: per worker, the alpha-combiner
        kernel compresses the gradients of the stored (job, batch)
        subfiles into the stacked contribution tensor
        ``[K, J_own, k-1, K, d]`` in the sync dtype (gamma == 1: one
        subfile per segment, bit-exact)."""
        prog = self.plan.program
        K, k = self.K, self.k
        J_own = self.q ** (self.k - 2)
        S = J_own * (k - 1)
        out = torch.empty((K, J_own, k - 1, K, self.d_shard),
                          dtype=self._sync_dtype, device=self.device)
        for s in range(K):
            vals, ids = [], []
            for a in range(J_own):
                j = int(prog.owned_jobs[s, a])
                for b in range(k - 1):
                    t = int(prog.stored_batches[s, a, b])
                    for n in prog.placement.batch_subfiles(t):
                        vals.append(map_fn(j, datasets[j][n]))
                        ids.append(a * (k - 1) + b)
            with span("aggregate.upload"):
                seg = torch.tensor(ids, dtype=torch.int32, device=self.device)
            with span("aggregate.stack"):
                stacked = torch.stack(vals)
            del vals
            with span("aggregate.kernel"):
                aggregate(stacked, seg, S, out=out[s].view(S, -1))
            del stacked
        return out

    def _spmd_stream(self) -> ShuffleStream:
        if self._stream is None:
            self._stream = ShuffleStream(self.q, self.k, self.d_shard,
                                         device=self.device,
                                         router=self.router,
                                         codec=self.codec)
        # reconcile with the trainer's failed set (a first build under
        # failure, or a direct ``self.failed`` mutation)
        want = frozenset(self.failed or ())
        if want != self._stream.failed:
            self._stream.degrade(want) if want else self._stream.restore()
        return self._stream

    def _sync_spmd(self, contribs, report, datasets=None,
                   host=None) -> torch.Tensor:
        """The coded shuffle on the device; given the memo's ``host``
        rows, the engine oracle checks it bitwise and measures the
        step's loads and bytes."""
        stream = self._spmd_stream()
        out = stream.sync(contribs)             # [K, J, d] on the card
        if host is None:
            report.loads = {"L_total_bus": Lo.camr_load(self.q, self.k),
                            "L_total_p2p": Lo.camr_load_p2p(self.q, self.k)}
            report.bytes_total += camr_collective_bytes(
                self.plan, dtype=self._sync_dtype)["camr_total"]
        else:
            eng = CAMREngine(self.camr, lambda j, sf: host[(j, sf[0])],
                             combine=self._combine)
            want = self._assemble(eng.run(datasets))
            if out.dtype == torch.bfloat16:
                got = out.view(torch.int16).cpu().numpy().view(np.uint16)
            else:
                got = out.cpu().numpy().view(np.uint32)
            np.testing.assert_array_equal(
                got, want.view(got.dtype),
                err_msg="camr_spmd shuffle diverged from the engine oracle")
            report.loads = eng.measured_loads()
            report.bytes_total += eng.trace.total_bytes()
        report.sync = stream.stats()
        return out

    # -- the host wires ------------------------------------------------ #
    def _host_row(self, row: torch.Tensor) -> np.ndarray:
        """A memo row ``[Dpad]`` -> the engines' map value ``[K, d]`` on
        the host (f32, or bf16 bit patterns as ``uint16``)."""
        row = row.view(self.K, self.d_shard)
        if row.dtype == torch.bfloat16:
            return row.view(torch.int16).cpu().numpy().view(np.uint16)
        return row.cpu().numpy()

    def _device_sync(self, gs: np.ndarray) -> torch.Tensor:
        """The host wires' ``[K, J, d]`` back on the device, in the sync
        dtype."""
        if gs.dtype == np.uint16:
            return torch.from_numpy(gs.view(np.int16)).view(
                torch.bfloat16).to(self.device)
        return torch.from_numpy(gs).to(self.device)

    def _assemble(self, results, migrate=None) -> np.ndarray:
        """Engine result dicts -> gsync ``[K, J, d]`` (pure data
        movement); a failed worker's shard is read from its migrate
        target."""
        J, K = self.J, self.K
        gs = np.empty((K, J, self.d_shard), self._sync_np)
        for s in range(K):
            src = migrate(s) if migrate else s
            for j in range(J):
                gs[s, j] = results[src][(j, s)]
        return gs

    def _sync_interpreter(self, map_fn, datasets, report) -> np.ndarray:
        """``mode="camr"``: one :class:`JobStream` wave over the numpy
        :class:`~repro_torch.core.engine.CAMREngine`, or over the
        ``DegradedCAMREngine`` of the failed set."""
        stream = JobStream(failed=self.failed, pipeline=False)
        spec = JobSpec(self.camr, map_fn, datasets, combine=self._combine,
                       name=f"train-step{self.step}",
                       value_dtype=self._sync_np)
        results = stream.run([spec])[0]
        eng = stream.last_engines[0]
        report.loads = eng.measured_loads()
        report.bytes_total += eng.trace.total_bytes()
        migrate = eng.migrate_target if self.failed else None
        return self._assemble(results, migrate)

    def _sync_uncoded(self, map_fn, datasets, report) -> np.ndarray:
        """``mode="uncoded"``: the paper's unicast baseline."""
        if self.failed:
            raise ValueError("the uncoded baseline has no degraded mode; "
                             "failed-worker steps need mode='camr'")
        eng = UncodedAggregatedEngine(self.q, self.k, 1, map_fn,
                                      combine=self._combine)
        results = eng.run(datasets)
        report.loads = {"L_total_bus": eng.measured_load()}
        report.bytes_total += eng.trace.total_bytes()
        return self._assemble(results)

    def set_failed(self, failed) -> None:
        """Membership change between steps: later ``camr`` steps re-lower
        from the warm schedule cache, and an existing SPMD stream swaps
        to its degraded lane (or back) without building its healthy
        executor again (``stream.compiles`` stays flat across
        kill/rejoin)."""
        self.failed = set(failed) if failed else None
        if self._stream is not None:
            if self.failed:
                self._stream.degrade(self.failed)
            else:
                self._stream.restore()

    def _apply(self, gsync: torch.Tensor) -> None:
        """The worker-sharded AdamW update from ``gsync [K, J, d]`` (worker
        s holds shard s of every job's summed gradient; consumed). The
        transpose is pure data movement, fused with the exact upcast of a
        bf16 sync to f32; /N and AdamW are elementwise plus the per-job
        clip norm."""
        with span("update.gather"):
            grads = torch.empty((self.J, self.Dpad), dtype=torch.float32,
                                device=self.device)
            grads.view(self.J, self.K, self.d_shard).copy_(
                gsync.transpose(0, 1))
            grads.div_(self.N)
        adamw_update(self.flat, grads, self.opt, lr=self.lr)

    # ------------------------------------------------------------------ #
    def train_steps(self, pipeline: ShardedTokenPipeline, steps: int,
                    mode: str = "camr_spmd") -> CAMRTrainReport:
        """Run ``steps`` training steps over the grad-sync wire ``mode``
        (``"camr_spmd"``, ``"camr"`` or ``"uncoded"``); ``self.step``
        advances, so consecutive calls continue the same data stream."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from "
                             f"{list(MODES)}")
        report = CAMRTrainReport(mode=mode,
                                 grad_sync_dtype=self.grad_sync_dtype)
        with _full_f32(self.device):
            for _ in range(steps):
                self._step(pipeline, report, mode)
        return report

    def _step(self, pipeline: ShardedTokenPipeline, report: CAMRTrainReport,
              mode: str) -> None:
        J, N = self.J, self.N
        with Recorder(self.device) as rec:
            with rec.phase("map"):
                self._last_loss = [dict() for _ in range(J)]
                with span("map.feed"):
                    base = make_camr_job_datasets(pipeline, J, N, self.step)
                # subfile payloads carry their index: the memo is keyed by
                # (job, subfile_index)
                datasets = [[(n, base[j][n]) for n in range(N)]
                            for j in range(J)]
                cache: dict = {}

                def map_fn(j, subfile):
                    n, batch = subfile
                    if (j, n) not in cache:   # each (job, subfile) mapped once
                        cache[(j, n)] = self._grad_vec(j, n, batch)
                    return cache[(j, n)]

                for j in range(J):
                    for n in range(N):
                        map_fn(j, datasets[j][n])
            with rec.phase("aggregate"):
                # the host wires and the oracle take each memo row on the
                # host once
                host = ({key: self._host_row(row)
                         for key, row in cache.items()}
                        if mode != "camr_spmd" or self.spmd_oracle else None)
                if mode == "camr_spmd":
                    contribs = self._build_contribs(map_fn, datasets)
                cache.clear()         # drop the memo: contribs or host hold it
            with rec.phase("shuffle"):
                if mode == "camr_spmd":
                    gsync = (self._sync_spmd(contribs, report) if host is None
                             else self._sync_spmd(contribs, report, datasets,
                                                  host))
                    del contribs
                else:
                    sync = (self._sync_interpreter if mode == "camr"
                            else self._sync_uncoded)
                    gsync = self._device_sync(sync(
                        lambda j, subfile: host[(j, subfile[0])], datasets,
                        report))
                del host
            with rec.phase("update"):
                self._apply(gsync)
                del gsync
        report.phase_ms.append(_phase_ms(rec.read()))
        report.losses.append(_mean_losses(
            [{n: float(v) for n, v in d.items()} for d in self._last_loss]))
        self.step += 1


class Trainer:
    """The single-model loop: the twin of ``repro.runtime.train_loop
    .Trainer``. A step maps the pipeline's batch in ``microbatches``
    equal groups (the loss and gradient averaged over them, summed in
    f32), clips by the global norm, and applies AdamW at the cosine
    schedule's rate of the step.

    ``params`` gives the initial tree (e.g. the JAX ``init_params``
    through :func:`repro_torch.weights.params_from_jax`); else it is
    drawn from a ``torch.Generator`` seeded with ``seed``. The state is
    the flat f32 row of ``ravel(params)`` with its moments; after each
    update every leaf is rounded back to its own dtype, as the JAX loop
    keeps its parameters in theirs. ``device=None`` is the current CUDA
    device.

    ``ckpt_dir`` turns on checkpointing (:class:`~repro_torch.checkpoint
    .CheckpointManager`): ``run(ckpt_every=n)`` saves every n-th step
    asynchronously, and :meth:`resume` restores the newest intact step.
    What is saved is the JAX trainer's tree, ``{"params": <the parameter
    tree, each leaf in its dtype>, "opt": AdamWState(step=<() int32>,
    mu=<f32 tree>, nu=<f32 tree>)}`` with metadata ``{"pipeline_step":
    step}``, so a directory written by either package's ``Trainer``
    resumes in the other's.
    """

    def __init__(self, cfg: ModelConfig, *, lr: float = 3e-4,
                 warmup: int = 20, total_steps: int = 1000,
                 ckpt_dir: str | None = None, seed: int = 0, params=None,
                 microbatches: int = 1, device=None):
        if microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got "
                             f"{microbatches}")
        self.device = resolve_device(device)
        self.cfg, self.microbatches = cfg, microbatches
        self.lr, self.warmup, self.total = lr, warmup, total_steps
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(np.random.SeedSequence([seed])
                                .generate_state(1)[0]))
            params = lm.init_params(cfg, gen)
        self._spec = flat_spec(params)
        self._all_f32 = all(dt == torch.float32 for dt in self._spec.dtypes)
        self.flat = ravel(params).to(self.device, torch.float32)[None]
        self.opt = AdamWState(
            step=torch.zeros((1,), dtype=torch.int32, device=self.device),
            mu=torch.zeros_like(self.flat), nu=torch.zeros_like(self.flat))
        self.step = 0
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None

    @property
    def params(self) -> dict:
        return unravel(self.flat[0], self._spec)

    def state_tree(self) -> dict:
        """The JAX trainer's checkpoint tree of this state: views of the
        flat row and moments (the parameters cast to their dtypes)."""
        spec = self._spec
        f32 = lambda row: tree(spec, [
            row[off:off + int(np.prod(shape, dtype=np.int64))].view(shape)
            for off, shape in zip(spec.offsets, spec.shapes)])
        return {"params": self.params,
                "opt": AdamWState(step=self.opt.step[0],
                                  mu=f32(self.opt.mu[0]),
                                  nu=f32(self.opt.nu[0]))}

    def _loss_grad(self, batch: dict):
        """Loss and the flat f32 gradient of one microbatch."""
        ps = [t.detach().requires_grad_(True)
              for t in split(self.flat[0], self._spec)]
        loss, _ = lm.train_loss(self.cfg, tree(self._spec, ps), batch)
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), torch.cat([g.reshape(-1).float()
                                         for g in grads])

    def _round_leaves(self, flat: torch.Tensor) -> torch.Tensor:
        """Each leaf's segment of ``flat`` rounded to the leaf's dtype."""
        return torch.cat([t.reshape(-1).float()
                          for t in split(flat, self._spec)])

    def _train_step(self, batch: dict) -> dict:
        nmb = self.microbatches
        if nmb == 1:
            loss, g = self._loss_grad(batch)
        else:
            B = batch["tokens"].shape[0]
            if B % nmb:
                raise ValueError(f"batch {B} must divide by microbatches "
                                 f"{nmb}")
            loss = torch.zeros((), device=self.device)
            g = torch.zeros(self._spec.size, device=self.device)
            for i in range(nmb):
                mb = {key: v[i * (B // nmb):(i + 1) * (B // nmb)]
                      for key, v in batch.items()}
                ml, mg = self._loss_grad(mb)
                loss, g = loss + ml, g + mg
            loss, g = loss / nmb, g / nmb
        # the global-norm clip, in each gradient leaf's dtype (a single
        # microbatch's gradient leaves are in the parameters' dtypes)
        gnorm = torch.sqrt(torch.sum(torch.square(g)))
        g = g * torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        if nmb == 1 and not self._all_f32:
            g = self._round_leaves(g)
        lr = cosine_schedule(self.step, peak=self.lr,
                             warmup_steps=self.warmup,
                             total_steps=self.total).to(self.device)
        adamw_update(self.flat, g[None], self.opt, lr=lr,
                     max_grad_norm=None)
        if not self._all_f32:
            self.flat[0] = self._round_leaves(self.flat[0])
        return {"loss": loss, "gnorm": gnorm, "lr": lr}

    def run(self, pipeline: ShardedTokenPipeline, steps: int,
            log_every: int = 10, ckpt_every: int = 0) -> list:
        """``steps`` steps; returns the metrics of step 1 and of every
        ``log_every``-th step. With a ``ckpt_dir``, every step that
        ``ckpt_every`` divides is saved, and the run ends by waiting for
        the writes (re-raising a failed one)."""
        metrics = []
        with _full_f32(self.device):
            for _ in range(steps):
                batch = {key: torch.as_tensor(v, device=self.device)
                         for key, v in pipeline.batch(self.step).items()}
                m = self._train_step(batch)
                self.step += 1
                if self.step % log_every == 0 or self.step == 1:
                    metrics.append({key: float(v) for key, v in m.items()}
                                   | {"step": self.step})
                if self.ckpt and ckpt_every and self.step % ckpt_every == 0:
                    self.ckpt.save(self.state_tree(), step=self.step,
                                   metadata={"pipeline_step": self.step})
        if self.ckpt:
            # the last chance to learn that an async write failed
            self.ckpt.wait()
        return metrics

    def resume(self) -> bool:
        """Crash-resume from the newest intact checkpoint (its data
        cursor included): False when there is none. The restored state
        replaces the constructor's, whatever its seed."""
        if not self.ckpt or self.ckpt.latest_step() is None:
            return False
        got, meta = self.ckpt.restore(self.state_tree())
        row = lambda t: torch.cat([leaf.reshape(-1).float()
                                   for _, leaf in leaves(t)])
        self.flat[0] = row(got["params"])
        self.opt.mu[0] = row(got["opt"].mu)
        self.opt.nu[0] = row(got["opt"].nu)
        self.opt.step[0] = got["opt"].step
        self.step = meta["step"]
        return True
