"""CAMR coded shuffle on one device: the stacked-device executor of the
compiled :class:`~repro_torch.core.schedule.ShuffleProgram`.

Counterpart of the JAX package's ``repro.core.collective``, whose
executor is a per-device ``shard_map`` body that picks its rows of each
``[K, ...]`` table with ``lax.axis_index``. Here the ``K = q*k`` workers
are virtual and the body runs for all of them at once, along a leading
device axis:

* a round's tiled ``all_to_all`` is a swap of the first two axes of the
  ``[K_src, K_dst, R, ...]`` send buffer;
* a ``ppermute`` moves ``out[dst] = buf[src]`` over its pairs, and every
  device no pair names as a destination receives zeros.

Both routers are applied to packet ROW IDS once per plan (host numpy,
:func:`_route_rows`), which yields for every received round packet the
row of the stacked Δ buffer it came from; the exchange on the card is
then one row gather. The fused codec kernels of
:mod:`repro_torch.kernels.xor_code` take the device axis as a grid
dimension, so each coded stage is one encode launch and one decode
launch for all K workers.

Semantics (as in the JAX package): ``contribs [K, J_own, k-1, K, d]``
-> ``out [K, J, d]``, device ``s`` receiving the fully aggregated shard
``s`` of every job, BITWISE equal to the numpy engine's reduce results.
The port runs the flat topology, ``mode="batched"`` and the fused codec,
on both wire lanes: 4-byte payloads (f32/u32) one value per u32 wire
word, and 16-bit payloads (bf16/f16) packed two per word by the 16-bit
codec kernels, with stage 3 and assembly at native width.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.xor_code import (xor_decode_gather, xor_decode_gather16,
                                xor_encode_gather, xor_encode_gather16)
from .schedule import (SCHEDULE_CACHE, ShuffleProgram, StageTables,
                       payload_words)

__all__ = ["CAMRPlan", "make_plan", "camr_shuffle", "scatter_contributions",
           "camr_shuffle_reference", "camr_collective_bytes",
           "ShuffleStream", "CODEC_DTYPES", "PACKED_DTYPES",
           "check_codec_dtype"]

# --------------------------------------------------------------------- #
# plan — a thin handle on the compiled program
# --------------------------------------------------------------------- #
@dataclass(frozen=True, eq=False)
class CAMRPlan:
    q: int
    k: int
    d: int                       # function-shard width (elements)
    program: ShuffleProgram = field(repr=False)
    #: per-(device, router) index tables on the device (built lazily)
    _tables: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def owned_jobs(self) -> np.ndarray:
        return self.program.owned_jobs

    @property
    def stored_batches(self) -> np.ndarray:
        return self.program.stored_batches

    @property
    def K(self) -> int:
        return self.q * self.k

    @property
    def J(self) -> int:
        return self.q ** (self.k - 1)

    @property
    def J_own(self) -> int:
        return self.q ** (self.k - 2)


def make_plan(q: int, k: int, d: int) -> CAMRPlan:
    """Lower the flat schedule of a (q, k) CAMR cluster (served from the
    structural :data:`~repro_torch.core.schedule.SCHEDULE_CACHE`)."""
    if k < 3:
        raise ValueError("the coded collective path requires k >= 3")
    if d % (k - 1):
        raise ValueError(f"shard width d={d} must be divisible by k-1={k - 1}")
    program = SCHEDULE_CACHE.program(q, k, Q=q * k, d=d)
    return CAMRPlan(q=q, k=k, d=d, program=program)


# --------------------------------------------------------------------- #
# wire words
# --------------------------------------------------------------------- #
#: payload dtypes the XOR codec can move (the JAX package's list):
#: 4-byte dtypes one value per u32 wire word, :data:`PACKED_DTYPES` two
#: 16-bit values per word at half the bytes on the wire
CODEC_DTYPES = ("float32", "uint32", "bfloat16", "float16")
PACKED_DTYPES = ("bfloat16", "float16")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def check_codec_dtype(dtype, where: str) -> None:
    """Entry guard: fail fast, with a fix, on a payload the codec cannot
    move."""
    name = _dtype_name(dtype)
    if name not in CODEC_DTYPES:
        raise TypeError(
            f"{where}: the CAMR XOR codec moves 32-bit wire words; "
            f"supported payload dtypes are {', '.join(CODEC_DTYPES)} "
            "(bf16/f16 ride the packed 16-bit lane, two values per "
            f"word), got {name}. Cast the contributions to a supported "
            "dtype first (e.g. contribs.float()).")


def _wire_buffer(x: torch.Tensor, wp: int) -> torch.Tensor:
    """Contributions -> the codec's chunk buffer: f32/u32 payloads as
    their int32 wire words (a bitcast); 16-bit payloads as int16 lanes,
    zero-padded per shard from ``d`` to ``2*wp`` lanes (the JAX package's
    trailing-lane pad rule) and handed to the 16-bit kernels as they are,
    so no value widens to 4 bytes."""
    if x.element_size() == 4:
        return x.view(torch.int32)
    lanes = x.view(torch.int16)
    pad = 2 * wp - x.shape[-1]
    return torch.nn.functional.pad(lanes, (0, pad)) if pad else lanes


def _from_wire(dec: torch.Tensor, dtype: torch.dtype,
               d: int) -> torch.Tensor:
    """Decoded chunk slots ``[K, n, wp]`` words or ``[K, n, 2*wp]`` lanes
    -> payload values ``[K, n, d]`` in the dtype assembly adds in (the
    inverse of :func:`_wire_buffer`; a strided view, no copy)."""
    if dec.dtype == torch.int16:
        return dec[..., :d].view(dtype)
    return dec.view(_arith_dtype(dtype))


def _arith_dtype(dtype: torch.dtype) -> torch.dtype:
    """Where assembly adds: f32, bf16 and f16 payloads in their own dtype
    (16-bit adds round at every step, as the JAX executor's do); u32
    payloads on their int32 view (two's-complement adds wrap like u32
    adds, same bits)."""
    return torch.int32 if dtype == torch.uint32 else dtype


# --------------------------------------------------------------------- #
# index tables of the stacked executor (host numpy -> device, per plan)
# --------------------------------------------------------------------- #
def _route_rows(T: StageTables, router: str, q: int, k: int,
                K: int) -> np.ndarray:
    """The stacked exchange of both routers, run on packet row ids.

    Returns ``[K, n, k-1]``: for device ``s``, group row ``i`` and round
    ``r``, the row of the stacked Δ buffer ``[K*n, pk]`` whose packet
    lands in ``recv[s, i, r-1]``, or -1 where the exchange delivers a
    zero block. Mirrors ``_stage_coded_batched`` of the JAX package line
    for line, with row ids in place of packet words.
    """
    n, R = T.n, int(T.R)
    ar = np.arange(K)
    ids = np.arange(K * n).reshape(K, n)              # my Δ rows, stacked
    src = np.empty((K, n, k - 1), np.int64)
    for r in range(1, k):
        if router == "all_to_all":
            idx = T.a2a_send[r - 1]                   # [K_src, K_dst, R]
            buf = np.where(idx >= 0,
                           ids[ar[:, None, None], np.clip(idx, 0, None)], -1)
            got = buf.swapaxes(0, 1)                  # tiled all_to_all
            flat = got.reshape(K, K * R)
            slot = T.a2a_recv[r - 1]                  # [K, n]
        elif router == "ppermute":
            parts = []
            for dd in range(q):
                idx = T.pp_send[r - 1, dd]            # [K, R]
                buf = np.where(idx >= 0,
                               ids[ar[:, None], np.clip(idx, 0, None)], -1)
                moved = np.full_like(buf, -1)         # unnamed dst -> zeros
                for a, b in T.pp_perms[r - 1][dd]:
                    moved[b] = buf[a]
                parts.append(moved)
            flat = np.concatenate(parts, axis=1)      # [K, q*R]
            slot = T.pp_recv[r - 1]
        else:
            raise ValueError(f"unknown router {router!r}")
        src[:, :, r - 1] = flat[ar[:, None], slot]
    return src


def _device_tables(plan: CAMRPlan, device: torch.device, router: str) -> dict:
    key = (str(device), router)
    tabs = plan._tables.get(key)
    if tabs is not None:
        return tabs
    prog = plan.program
    q, k, K, J, J_own = plan.q, plan.k, plan.K, plan.J, plan.J_own

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    stages = {}
    for stage in (1, 2):
        T = prog.stage_tables(stage)
        n = T.n
        rows = _route_rows(T, router, q, k, K).reshape(-1)
        ok = rows >= 0
        stages[stage] = dict(
            n=n,
            enc_src=t(T.enc_src, torch.int32),
            src_ok=t(T.src_ok, torch.bool),
            dec_recv=t(T.dec_recv.reshape(K, n * (k - 1)), torch.int32),
            dec_src=t(T.dec_src.reshape(K, n * (k - 1), k), torch.int32),
            dec_mask=t(T.dec_mask.reshape(K, n * (k - 1), k), torch.bool),
            recv_rows=t(np.clip(rows, 0, None), torch.int64),
            recv_zero=None if ok.all() else t(~ok, torch.bool))
    # stage 3: device s sends the fold of its stored batches of shard
    # dst = classmate at offset o; ppermute pairs move it to dst
    ar = np.arange(K)
    s3_dst, s3_src = [], []
    for o in range(1, q):
        s3_dst.append((ar // q) * q + (ar % q + o) % q)
        src = np.full(K, -1)
        for a, b in prog.s3_perms[o - 1]:
            src[b] = a
        s3_src.append(src)
    # assembly: owners add their own fold to the stage-1 value, the
    # others add the stage-3 unicast to the stage-2 value
    s_of, j_of = np.nonzero(prog.is_own)
    sn, jn = np.nonzero(~prog.is_own)
    slot = prog.own_slot
    tabs = dict(
        stages=stages,
        ar=t(ar, torch.int64),
        s3_dst=[t(x, torch.int64) for x in s3_dst],
        s3_src=[t(np.clip(x, 0, None), torch.int64) for x in s3_src],
        s3_zero=[None if (x >= 0).all() else t(x < 0, torch.bool)
                 for x in s3_src],
        own_rows=t(s_of * J + j_of, torch.int64),
        own_sum_rows=t(s_of * J_own + slot[s_of, j_of], torch.int64),
        non_rows=t(sn * J + jn, torch.int64),
        non_s2_rows=t(sn * prog.n_s2 + prog.s2_ord[sn, jn], torch.int64),
        non_s3_rows=t((sn * (q - 1) + prog.s3_off[sn, jn]) * J_own
                      + slot[sn, jn], torch.int64),
    )
    plan._tables[key] = tabs
    return tabs


# --------------------------------------------------------------------- #
# the coded exchange of stages 1 and 2
# --------------------------------------------------------------------- #
def _encode_stage(wire, st, *, K, pk):
    """Sender side: Δ = XOR_p pkt(G[p], pos(me, G[p])) for every device.
    Returns ``(flat, delta)``: the flat packet view of the chunk buffers
    (the decode context; ``[K, P, pk]`` words, or ``[K, P, 2pk]`` lanes
    on the packed lane) and Δ ``[K, n, pk]`` in int32 wire words."""
    if wire.dtype == torch.int16:       # packed lane: lane pairs
        flat = wire.reshape(K, -1, 2 * pk)
        delta = xor_encode_gather16(flat, st["enc_src"], st["src_ok"])
        return flat, delta.view(torch.int32)
    flat = wire.reshape(K, -1, pk)      # free view: packets are contiguous
    return flat, xor_encode_gather(flat, st["enc_src"], st["src_ok"])


def _exchange(delta, st, *, K, k, pk):
    """The round exchange: ``recv [K, n*(k-1), pk]``, round packets in
    the ``[n, k-1]`` order the decode's ``dec_recv`` indexes."""
    recv = delta.reshape(-1, pk).index_select(0, st["recv_rows"])
    if st["recv_zero"] is not None:
        recv.masked_fill_(st["recv_zero"][:, None], 0)
    return recv.view(K, st["n"] * (k - 1), pk)


def _decode_stage(recv, flat, st, *, K, k, pk):
    """Receiver side: pkt(me, pos(m_r, me)) = recv[r] XOR the cancellation
    packets, decoded words landing in chunk-slot order -> ``[K, n, wp]``
    words (``[K, n, 2*wp]`` lanes on the packed lane)."""
    tabs = (st["dec_recv"], st["dec_src"], st["dec_mask"])
    if flat.dtype == torch.int16:
        dec = xor_decode_gather16(recv.view(torch.int16), flat, *tabs)
    else:
        dec = xor_decode_gather(recv, flat, *tabs)
    return dec.view(K, st["n"], -1)


def _stage_coded_batched(wire, st, *, K, k, pk):
    flat, delta = _encode_stage(wire, st, K=K, pk=pk)
    recv = _exchange(delta, st, K=K, k=k, pk=pk)
    del delta
    return _decode_stage(recv, flat, st, K=K, k=k, pk=pk)


def _fold_stored(vals, ar, shard):
    """``vals[s, :, :, shard[s]]`` folded over the stored-batch axis ->
    ``[K, J_own, d]``: a sequential ascending left fold, the canonical
    combine order of the engine's reduce phase (a ``.sum()`` would pick
    its own reduction order and break the bitwise contract)."""
    acc = vals[ar, :, 0, shard]
    for b in range(1, vals.shape[2]):
        acc = acc + vals[ar, :, b, shard]
    return acc


# --------------------------------------------------------------------- #
# the shuffle
# --------------------------------------------------------------------- #
def camr_shuffle(plan: CAMRPlan, contribs: torch.Tensor, *,
                 router: str = "all_to_all") -> torch.Tensor:
    """3-stage CAMR coded shuffle of all K virtual devices at once:
    ``contribs [K, J_own, k-1, K, d] -> [K, J, d]``.

    Runs on the device of ``contribs``: the CUDA codec kernels on a card,
    their plain versions on the CPU. Outputs are BITWISE equal to the
    numpy engine's reduce results: XOR delivery is lossless and assembly
    folds the stored batches in the engine's canonical order. bf16/f16
    contributions take the packed lane: two values per u32 wire word
    through stages 1 and 2 (half the bytes of an f32 shuffle of the same
    ``d``), stage 3 and assembly in the payload dtype. This is the JAX
    executor's ``mode="batched"``, ``codec="fused"``; the looped router,
    the multipass codec and ``debug`` are not ported yet (ROADMAP.md,
    Queue 1).
    """
    prog = plan.program
    q, k, K, J, J_own, d = (plan.q, plan.k, plan.K, plan.J, plan.J_own,
                            plan.d)
    check_codec_dtype(contribs.dtype, "camr_shuffle")
    if tuple(contribs.shape) != (K, J_own, k - 1, K, d):
        raise ValueError(f"contribs shape {tuple(contribs.shape)} != "
                         f"{(K, J_own, k - 1, K, d)}")
    if router not in ("all_to_all", "ppermute"):
        raise ValueError(f"unknown router {router!r}")
    dtype = contribs.dtype
    contribs = contribs.contiguous()
    tabs = _device_tables(plan, contribs.device, router)
    # wp u32 words per shard: d for 4-byte dtypes, ceil(d/2) padded to a
    # packet multiple for packed 16-bit ones
    wp = payload_words(d, contribs.element_size(), k)
    pk = wp // (k - 1)
    wire = _wire_buffer(contribs, wp)   # [K, J_own, k-1, K, wp | 2*wp]

    # ========== stages 1 + 2: one shared coded-exchange machine ======== #
    arith = _arith_dtype(dtype)
    stage_vals = {}
    for stage in (1, 2):
        dec = _stage_coded_batched(wire, tabs["stages"][stage], K=K, k=k,
                                   pk=pk)
        stage_vals[stage] = _from_wire(dec, dtype, d)   # [K, n, d]
    del wire
    vals = contribs.view(arith)

    # ========== stage 3: intra-class unicasts (q-1 permutations) ======= #
    s3_out = torch.empty((K, q - 1, J_own, d), dtype=arith,
                         device=contribs.device)
    for o in range(q - 1):
        pay = _fold_stored(vals, tabs["ar"], tabs["s3_dst"][o])
        got = pay.index_select(0, tabs["s3_src"][o])
        if tabs["s3_zero"][o] is not None:
            got.masked_fill_(tabs["s3_zero"][o][:, None, None], 0)
        s3_out[:, o] = got
        del pay, got        # free before the next offset's payload

    # ========== assemble (reduce-side tables of the program) ========== #
    own_sum = _fold_stored(vals, tabs["ar"], tabs["ar"])   # [K, J_own, d]
    out = torch.empty((K * J, d), dtype=arith, device=contribs.device)
    s1 = stage_vals.pop(1).reshape(K * J, d)
    out[tabs["own_rows"]] = (s1.index_select(0, tabs["own_rows"])
                             + own_sum.reshape(-1, d).index_select(
                                 0, tabs["own_sum_rows"]))
    del s1, own_sum         # free before the non-owner gathers
    s2 = stage_vals.pop(2).reshape(K * prog.n_s2, d)
    out[tabs["non_rows"]] = (s2.index_select(0, tabs["non_s2_rows"])
                             + s3_out.reshape(-1, d).index_select(
                                 0, tabs["non_s3_rows"]))
    return out.view(K, J, d).view(dtype)


# --------------------------------------------------------------------- #
# helpers for callers & tests
# --------------------------------------------------------------------- #
def scatter_contributions(plan: CAMRPlan,
                          batch_grads: np.ndarray) -> np.ndarray:
    """batch_grads [J, k, K, d] -> per-device contribs [K, J_own, k-1, K, d]
    per the placement (device s gets the batches it stores)."""
    K, J_own, k = plan.K, plan.J_own, plan.k
    out = np.zeros((K, J_own, k - 1, K, plan.d), dtype=batch_grads.dtype)
    for s in range(K):
        for a, j in enumerate(plan.owned_jobs[s]):
            for b, t in enumerate(plan.stored_batches[s, a]):
                out[s, a, b] = batch_grads[j, t]
    return out


def camr_shuffle_reference(plan: CAMRPlan,
                           batch_grads: np.ndarray) -> np.ndarray:
    """Oracle: out[s, j] = sum over batches of shard s of job j."""
    total = batch_grads.sum(axis=1)               # [J, K, d]
    return np.transpose(total, (1, 0, 2))         # [K, J, d]


def camr_collective_bytes(plan: CAMRPlan, itemsize: int = 4,
                          dtype=None) -> dict[str, int]:
    """On-wire bytes per device-step of the schedule (p2p model), for the
    comparison against a psum-based reduce-scatter (the JAX package's
    formula; ``dtype`` selects the wire lane by its item size)."""
    if dtype is not None:
        name = _dtype_name(dtype)
        if name not in CODEC_DTYPES:
            raise TypeError(f"camr_collective_bytes: {name} is not a codec "
                            f"payload dtype ({', '.join(CODEC_DTYPES)})")
        itemsize = 2 if name in PACKED_DTYPES else 4
    k, q, J, J_own, K, d = (plan.k, plan.q, plan.J, plan.J_own, plan.K,
                            plan.d)
    # coded packets move as u32 wire words regardless of payload dtype
    pk_b = (payload_words(d, itemsize, k) // (k - 1)) * 4
    s1 = J * (k - 1) * pk_b * k            # J groups, k-1 rounds, k senders
    s2 = plan.program.n_s2 * (k - 1) * pk_b * k
    s3 = (q - 1) * J_own * d * itemsize * K
    # uncoded alternative: psum of [J, K, d] dense gradient (ring):
    ring = 2 * (K - 1) * J * K * d * itemsize
    return dict(stage1=s1, stage2=s2, stage3=s3,
                camr_total=s1 + s2 + s3, psum_ring_total=ring)


# --------------------------------------------------------------------- #
# multi-step reuse (the training grad-sync path)
# --------------------------------------------------------------------- #
class ShuffleStream:
    """Reusable runner of :func:`camr_shuffle` for the training path.

    One lowered plan and one set of device index tables, reused by
    every :meth:`sync`; ``compiles`` counts executor builds (plan
    lowering + tables), ``dispatches`` the shuffles run. This slice
    ports the flat, healthy stream with ``sync``; wave submission,
    degrade/restore and the two-level topology are still to port
    (ROADMAP.md, Queue 1).
    """

    def __init__(self, q: int, k: int, d: int, *, device=None,
                 router: str = "all_to_all"):
        if k < 3:
            raise ValueError("the coded collective path requires k >= 3")
        if d % (k - 1):
            raise ValueError(f"shard width d={d} must be divisible by "
                             f"k-1={k - 1}")
        if router not in ("all_to_all", "ppermute"):
            raise ValueError(f"unknown router {router!r}")
        self.q, self.k, self.d = q, k, d
        self.K = q * k
        self.device = resolve_device(device)
        self.router = router
        self._plan: CAMRPlan | None = None
        self.dispatches = 0
        self.compiles = 0

    def _executor(self) -> CAMRPlan:
        if self._plan is None:
            plan = make_plan(self.q, self.k, self.d)
            _device_tables(plan, self.device, self.router)
            self._plan = plan
            self.compiles += 1
        return self._plan

    def _check_wave(self, contribs) -> None:
        shape = (self.K, self.q ** (self.k - 2), self.k - 1, self.K,
                 self.d)
        if tuple(contribs.shape) != shape:
            raise ValueError(f"wave shape {tuple(contribs.shape)} != "
                             f"{shape}")
        check_codec_dtype(contribs.dtype, "ShuffleStream")
        if contribs.device != self.device:
            raise ValueError(f"wave lies on {contribs.device}, the stream "
                             f"on {self.device}")

    def sync(self, contribs: torch.Tensor) -> torch.Tensor:
        """Run ONE wave ``[K, J_own, k-1, K, d]`` through the stream's
        executor; returns the ``[K, J, d]`` output on the stream's device
        (no host copy)."""
        self._check_wave(contribs)
        self.dispatches += 1
        return camr_shuffle(self._executor(), contribs, router=self.router)

    def stats(self) -> dict:
        """Executor-reuse counters (``compiles`` stays flat while
        ``dispatches`` grows on a steady-state stream)."""
        return dict(dispatches=self.dispatches, compiles=self.compiles,
                    router=self.router, device=str(self.device))
