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

Execution modes (the JAX executor's): ``mode="batched"`` applies both
routers to packet ROW IDS once per plan (host numpy,
:func:`_route_rows`), which yields for every received round packet the
row of the stacked Δ buffer it came from, so a stage's exchange on the
card is one row gather; ``mode="looped"`` is the legacy per-group
schedule, one permutation per (group, round), counted on the plan
(:attr:`CAMRPlan.permutations`).

Codecs: ``codec="fused"`` runs the gather-XOR kernels of
:mod:`repro_torch.kernels.xor_code`, which take the device axis as a grid
dimension (one encode and one decode launch per coded stage for all K
workers); ``codec="multipass"`` is the original gather -> take-along ->
fold pipeline, kept as the independent oracle of the fused codec: it
materializes the chunk table ``[K, n, k, wp]`` and the cancellation
packets ``[K, n, k-1, k, pk]`` and folds them with the dense kernels
``xor_fold`` and ``xor_decode`` (one launch each per coded stage).

Semantics (as in the JAX package): ``contribs [K, J_own, k-1, K, d]``
-> ``out [K, J, d]``, device ``s`` receiving the fully aggregated shard
``s`` of every job, BITWISE equal to the numpy engine's reduce results
in every mode and codec. The port runs the flat topology on both wire
lanes: 4-byte payloads (f32/u32) one value per u32 wire word, and 16-bit
payloads (bf16/f16) packed two per word (by the 16-bit gather kernels on
the fused codec, as u32 words on the multipass codec), with stage 3 and
assembly at native width.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from itertools import combinations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.xor_code import (xor_decode, xor_decode_gather,
                                xor_decode_gather16, xor_encode_gather,
                                xor_encode_gather16, xor_fold)
from .schedule import (EXEC_CACHE, SCHEDULE_CACHE, ShuffleProgram,
                       StageTables, payload_words, resolve_topology)

__all__ = ["CAMRPlan", "make_plan", "camr_shuffle", "scatter_contributions",
           "camr_shuffle_reference", "uncoded_reduce_scatter",
           "camr_collective_bytes", "expected_collective_calls",
           "ShuffleStream", "CODEC_DTYPES", "PACKED_DTYPES",
           "check_codec_dtype"]

MODES = ("batched", "looped")
CODECS = ("fused", "multipass")

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
    #: device-axis permutations the executor has run with this plan, by
    #: stage: one per (group, round) of the looped exchange and one per
    #: stage-3 offset (the batched exchange is one routed row gather)
    permutations: dict = field(
        default_factory=lambda: {"stage12": 0, "stage3": 0}, repr=False,
        compare=False)

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


def _wire_buffer(x: torch.Tensor, wp: int, codec: str) -> torch.Tensor:
    """Contributions -> the codec's chunk buffer: f32/u32 payloads as
    their int32 wire words (a bitcast); 16-bit payloads as int16 lanes,
    zero-padded per shard from ``d`` to ``2*wp`` lanes (the JAX package's
    trailing-lane pad rule). The fused codec's 16-bit kernels take the
    lanes as they are; the multipass codec takes them as int32 wire words,
    a view in which lane ``2i`` is the low half of word ``i`` (JAX
    ``_u16_pairs_to_u32``). No value widens to 4 bytes either way."""
    if x.element_size() == 4:
        return x.view(torch.int32)
    lanes = x.view(torch.int16)
    pad = 2 * wp - x.shape[-1]
    if pad:
        lanes = torch.nn.functional.pad(lanes, (0, pad))
    return lanes if codec == "fused" else lanes.view(torch.int32)


def _from_wire(dec: torch.Tensor, dtype: torch.dtype,
               d: int) -> torch.Tensor:
    """Decoded chunk slots ``[K, n, wp]`` words or ``[K, n, 2*wp]`` lanes
    -> payload values ``[K, n, d]`` in the dtype assembly adds in (the
    inverse of :func:`_wire_buffer`; a strided view, no copy)."""
    if dtype.itemsize == 2:
        return dec.view(torch.int16)[..., :d].view(dtype)
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


def _fused_tables(plan: CAMRPlan, stage: int, router: str, t) -> dict:
    """Fused codec: the flat packet-row tables of the gathers."""
    T, K, k = plan.program.stage_tables(stage), plan.K, plan.k
    rows = T.n * (k - 1)
    return dict(enc_src=t(T.enc_src, torch.int32),
                dec_recv=t(T.dec_recv.reshape(K, rows), torch.int32),
                dec_src=t(T.dec_src.reshape(K, rows, k), torch.int32),
                dec_mask=t(T.dec_mask.reshape(K, rows, k), torch.bool))


def _multipass_tables(plan: CAMRPlan, stage: int, router: str, t) -> dict:
    """Multipass codec: chunk-table coordinates and packet positions."""
    T, K, k = plan.program.stage_tables(stage), plan.K, plan.k
    return dict(src_jslot=t(T.src_jslot, torch.int64),
                src_bslot=t(T.src_bslot, torch.int64),
                shard=t(T.shard[None], torch.int64),
                delta_pos=t(T.delta_pos, torch.int64),
                cancel_pos=t(T.cancel_pos, torch.int64),
                cancel_mask=t(T.cancel_mask.reshape(K * T.n * (k - 1), k),
                              torch.bool),
                dec_order=t(np.argsort(T.dec_gather, axis=2, kind="stable"),
                            torch.int64))


def _batched_tables(plan: CAMRPlan, stage: int, router: str, t) -> dict:
    """Batched exchange: the routed row of every received round packet."""
    T = plan.program.stage_tables(stage)
    rows = _route_rows(T, router, plan.q, plan.k, plan.K).reshape(-1)
    ok = rows >= 0
    return dict(recv_rows=t(np.clip(rows, 0, None), torch.int64),
                recv_zero=None if ok.all() else t(~ok, torch.bool))


def _looped_tables(plan: CAMRPlan, stage: int, router: str, t) -> dict:
    """Looped exchange: per (group, round), the source of every
    destination of the round's permutation (-1: not a destination)."""
    prog, K, k = plan.program, plan.K, plan.k
    T = prog.stage_tables(stage)
    loop_src = np.full((T.n, k - 1, K), -1)
    for gi, rounds in enumerate(prog.round_perms(stage)):
        for r, pairs in enumerate(rounds):
            for a, b in pairs:
                loop_src[gi, r, b] = a
    return dict(valid=t(T.valid, torch.bool),
                loop_src=t(np.clip(loop_src, 0, None), torch.int64),
                loop_zero=t(loop_src < 0, torch.bool))


#: the stage tables each codec and each exchange mode reads
_STAGE_PARTS = {"fused": _fused_tables, "multipass": _multipass_tables,
                "batched": _batched_tables, "looped": _looped_tables}


def _device_tables(plan: CAMRPlan, device: torch.device, router: str,
                   codec: str = "fused", mode: str = "batched") -> dict:
    """The executor's index tables on ``device``, cached on the plan per
    (device, router): the shared ones on first use, each coded stage's
    tables of a codec or an exchange mode the first time a shuffle runs
    that codec or mode."""
    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    key = (str(device), router)
    tabs = plan._tables.get(key)
    if tabs is None:
        tabs = plan._tables[key] = _shared_tables(plan, t)
    for stage, st in tabs["stages"].items():
        for part in (codec, mode):
            if part not in st["parts"]:
                st.update(_STAGE_PARTS[part](plan, stage, router, t))
                st["parts"].add(part)
    return tabs


def _shared_tables(plan: CAMRPlan, t) -> dict:
    """Tables of every codec and mode: each coded stage's group count and
    chunk mask, stage 3 and assembly."""
    prog = plan.program
    q, K, J, J_own = plan.q, plan.K, plan.J, plan.J_own
    stages = {}
    for stage in (1, 2):
        T = prog.stage_tables(stage)
        stages[stage] = dict(n=T.n, src_ok=t(T.src_ok, torch.bool),
                             parts=set())
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
        is_own=t(prog.is_own, torch.bool),
        own_slot=t(slot, torch.int64),
        s2_ord=t(prog.s2_ord, torch.int64),
        s3_off=t(prog.s3_off, torch.int64),
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
    return tabs


# --------------------------------------------------------------------- #
# the coded exchange of stages 1 and 2
# --------------------------------------------------------------------- #
def _encode_stage(wire, st, *, K, k, pk, codec):
    """Sender side: Δ = XOR_p pkt(G[p], pos(me, G[p])) for every device.
    Returns ``(ctx, delta)``: what the matching :func:`_decode_stage`
    cancels packets from, and Δ ``[K, n, pk]`` in int32 wire words. On the
    fused codec ``ctx`` is the flat packet view of the chunk buffers
    (``[K, P, pk]`` words, or ``[K, P, 2pk]`` lanes on the packed lane); on
    the multipass codec it is the materialized packet table ``[K, n, k,
    k-1, pk]``, each group's k chunks (zero where the device stores no
    chunk), from which Δ folds the device's own packet of each."""
    if codec == "fused":
        if wire.dtype == torch.int16:       # packed lane: lane pairs
            flat = wire.reshape(K, -1, 2 * pk)
            delta = xor_encode_gather16(flat, st["enc_src"], st["src_ok"])
            return flat, delta.view(torch.int32)
        flat = wire.reshape(K, -1, pk)      # free view: packets contiguous
        return flat, xor_encode_gather(flat, st["enc_src"], st["src_ok"])
    n = st["n"]
    dev = torch.arange(K, device=wire.device).view(K, 1, 1)
    chunks = wire[dev, st["src_jslot"], st["src_bslot"], st["shard"]]
    chunks.masked_fill_(~st["src_ok"][..., None], 0)     # [K, n, k, wp]
    packets = chunks.view(K, n, k, k - 1, pk)
    pos = torch.arange(k, device=wire.device).view(1, 1, k)
    row = torch.arange(n, device=wire.device).view(1, n, 1)
    mine = packets[dev, row, pos, st["delta_pos"]]       # [K, n, k, pk]
    return packets, xor_fold(mine.view(K * n, k, pk)).view(K, n, pk)


def _cancellations(packets, st, *, K, k):
    """Multipass receiver context: the cancellation packets ``[K, n, k-1,
    k, pk]``, ``canc[v, i, r, p] = packets[v, i, p, cancel_pos[v, i, r,
    p]]`` (the JAX executor's take-along of the broadcast packet table)."""
    n = st["n"]
    dev = torch.arange(K, device=packets.device).view(K, 1, 1, 1)
    row = torch.arange(n, device=packets.device).view(1, n, 1, 1)
    pos = torch.arange(k, device=packets.device).view(1, 1, 1, k)
    return packets[dev, row, pos, st["cancel_pos"]]


def _exchange(delta, st, *, K, k, pk):
    """The batched round exchange: ``recv [K, n*(k-1), pk]``, round
    packets in the ``[n, k-1]`` order the decode indexes."""
    recv = delta.reshape(-1, pk).index_select(0, st["recv_rows"])
    if st["recv_zero"] is not None:
        recv.masked_fill_(st["recv_zero"][:, None], 0)
    return recv.view(K, st["n"] * (k - 1), pk)


def _exchange_looped(delta, st, calls, *, K, k, pk):
    """The legacy exchange: one permutation per (group, round), each
    moving ``out[dst] = payload[src]`` (zeros to devices it does not
    name), kept where the RECEIVER is a group member. Same ``recv``
    layout as :func:`_exchange`."""
    n = st["n"]
    recv = torch.zeros((K, n, k - 1, pk), dtype=delta.dtype,
                       device=delta.device)
    for gi in range(n):
        valid = st["valid"][:, gi, None]
        payload = torch.where(valid, delta[:, gi], 0)
        for r in range(k - 1):
            got = payload.index_select(0, st["loop_src"][gi, r])
            got.masked_fill_(st["loop_zero"][gi, r][:, None], 0)
            calls["stage12"] += 1
            recv[:, gi, r] = torch.where(valid, got, recv[:, gi, r])
    return recv.view(K, n * (k - 1), pk)


def _decode_stage(recv, ctx, st, *, K, k, pk, codec):
    """Receiver side: pkt(me, pos(m_r, me)) = recv[r] XOR the cancellation
    packets, decoded words landing in chunk-slot order -> ``[K, n, wp]``
    words (``[K, n, 2*wp]`` lanes on the fused packed lane). ``ctx`` is
    the flat chunk view (fused) or the cancellation packets (multipass,
    :func:`_cancellations`)."""
    n = st["n"]
    if codec == "fused":
        tabs = (st["dec_recv"], st["dec_src"], st["dec_mask"])
        if ctx.dtype == torch.int16:
            dec = xor_decode_gather16(recv.view(torch.int16), ctx, *tabs)
        else:
            dec = xor_decode_gather(recv, ctx, *tabs)
        return dec.view(K, n, -1)
    rows = K * n * (k - 1)
    dec = xor_decode(recv.reshape(rows, pk), ctx.view(rows, k, pk),
                     st["cancel_mask"]).view(K, n, k - 1, pk)
    dev = torch.arange(K, device=dec.device).view(K, 1, 1)
    row = torch.arange(n, device=dec.device).view(1, n, 1)
    return dec[dev, row, st["dec_order"]].view(K, n, -1)


def _stage_coded(wire, st, calls, *, K, k, pk, mode, codec):
    """One coded stage of every device: encode, exchange (batched or
    looped), decode."""
    ctx, delta = _encode_stage(wire, st, K=K, k=k, pk=pk, codec=codec)
    if mode == "batched":
        recv = _exchange(delta, st, K=K, k=k, pk=pk)
    else:
        recv = _exchange_looped(delta, st, calls, K=K, k=k, pk=pk)
    del delta
    if codec == "multipass":    # rebinding frees the chunk table
        ctx = _cancellations(ctx, st, K=K, k=k)
    return _decode_stage(recv, ctx, st, K=K, k=k, pk=pk, codec=codec)


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
                 mode: str = "batched", router: str = "all_to_all",
                 codec: str = "fused", debug: bool = False):
    """3-stage CAMR coded shuffle of all K virtual devices at once:
    ``contribs [K, J_own, k-1, K, d] -> [K, J, d]``.

    Runs on the device of ``contribs``: the CUDA codec kernels on a card,
    their plain versions on the CPU. Outputs are BITWISE equal to the
    numpy engine's reduce results in every ``mode`` (``"batched"``, or the
    legacy ``"looped"`` per-group exchange, which ignores ``router``) and
    every ``codec`` (``"fused"`` gathers, or the ``"multipass"`` oracle):
    XOR delivery is lossless and assembly folds the stored batches in the
    engine's canonical order. bf16/f16 contributions take the packed
    lane: two values per u32 wire word through stages 1 and 2 (half the
    bytes of an f32 shuffle of the same ``d``), stage 3 and assembly in
    the payload dtype.

    ``debug=True`` returns the JAX executor's debug dict, stacked over the
    device axis: ``out``, ``stage1``, ``stage2``, ``stage3`` and
    ``own_sum`` ``[K, J, d]`` (each device's selections of every job row,
    garbage where the row is not its own to decode) and ``is_own``
    ``bool[K, J]``.
    """
    prog = plan.program
    q, k, K, J, J_own, d = (plan.q, plan.k, plan.K, plan.J, plan.J_own,
                            plan.d)
    check_codec_dtype(contribs.dtype, "camr_shuffle")
    if tuple(contribs.shape) != (K, J_own, k - 1, K, d):
        raise ValueError(f"contribs shape {tuple(contribs.shape)} != "
                         f"{(K, J_own, k - 1, K, d)}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    if router not in ("all_to_all", "ppermute"):
        raise ValueError(f"unknown router {router!r}")
    dtype = contribs.dtype
    contribs = contribs.contiguous()
    tabs = _device_tables(plan, contribs.device, router, codec, mode)
    # wp u32 words per shard: d for 4-byte dtypes, ceil(d/2) padded to a
    # packet multiple for packed 16-bit ones
    wp = payload_words(d, contribs.element_size(), k)
    pk = wp // (k - 1)
    wire = _wire_buffer(contribs, wp, codec)   # [K, J_own, k-1, K, ...]

    # ========== stages 1 + 2: one shared coded-exchange machine ======== #
    arith = _arith_dtype(dtype)
    stage_vals = {}
    for stage in (1, 2):
        dec = _stage_coded(wire, tabs["stages"][stage], plan.permutations,
                           K=K, k=k, pk=pk, mode=mode, codec=codec)
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
        plan.permutations["stage3"] += 1
        s3_out[:, o] = got
        del pay, got        # free before the next offset's payload

    # ========== assemble (reduce-side tables of the program) ========== #
    own_sum = _fold_stored(vals, tabs["ar"], tabs["ar"])   # [K, J_own, d]
    s1 = stage_vals.pop(1)                                  # [K, J, d]
    s2 = stage_vals.pop(2)                                  # [K, n_s2, d]
    if debug:
        ar = tabs["ar"][:, None]
        slot = tabs["own_slot"]
        info = dict(stage1=s1, stage2=s2[ar, tabs["s2_ord"]],
                    stage3=s3_out[ar, tabs["s3_off"], slot],
                    own_sum=own_sum[ar, slot])
        info = {key: v.contiguous().view(dtype) for key, v in info.items()}
    out = torch.empty((K * J, d), dtype=arith, device=contribs.device)
    s1 = s1.reshape(K * J, d)
    out[tabs["own_rows"]] = (s1.index_select(0, tabs["own_rows"])
                             + own_sum.reshape(-1, d).index_select(
                                 0, tabs["own_sum_rows"]))
    del s1, own_sum         # free before the non-owner gathers
    s2 = s2.reshape(K * prog.n_s2, d)
    out[tabs["non_rows"]] = (s2.index_select(0, tabs["non_s2_rows"])
                             + s3_out.reshape(-1, d).index_select(
                                 0, tabs["non_s3_rows"]))
    out = out.view(K, J, d).view(dtype)
    if debug:
        return dict(out=out, **info, is_own=tabs["is_own"])
    return out


def expected_collective_calls(plan: CAMRPlan, mode: str = "batched",
                              router: str = "all_to_all") -> dict[str, int]:
    """Collectives per shuffle of the JAX executor, flat topology: the
    batched rounds (one ``all_to_all``, or ``q`` ppermutes, per round of
    each coded stage) or the looped per-group permutations, plus the
    ``q-1`` stage-3 unicasts. The port's looped lane and stage 3 run
    exactly these permutations (:attr:`CAMRPlan.permutations`)."""
    q, k = plan.q, plan.k
    if mode == "batched":
        s12 = 2 * (k - 1) if router == "all_to_all" else 2 * (k - 1) * q
    else:
        s12 = (plan.J + plan.program.n_s2) * (k - 1)
    return dict(stage12=s12, stage3=q - 1, total=s12 + q - 1)


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


def uncoded_reduce_scatter(contribs: torch.Tensor, *,
                           plan: CAMRPlan) -> torch.Tensor:
    """The paper's uncoded baseline, stacked over the device axis:
    ``contribs [K, J_own, k-1, K, d] -> [K, J, d]``. Every duplicate batch
    copy but the first is masked off, each device sums its stored batches
    of its owned jobs, adding those sums into the job rows of one dense
    ``[J, K, d]`` stands in for ``psum``, and device ``s`` keeps shard
    ``s`` of every job."""
    K, J, J_own, k = plan.K, plan.J, plan.J_own, plan.k
    first = np.zeros((K, J_own, k - 1), dtype=bool)
    seen = set()
    for s in range(K):
        for a, j in enumerate(plan.owned_jobs[s]):
            for b, t in enumerate(plan.stored_batches[s, a]):
                if (j, t) not in seen:
                    seen.add((j, t))
                    first[s, a, b] = True
    dev = contribs.device
    mask = torch.as_tensor(first, device=dev)
    part = torch.where(mask[..., None, None], contribs, 0).sum(dim=2)
    total = torch.zeros((J, K, plan.d), dtype=contribs.dtype, device=dev)
    jobs = torch.as_tensor(plan.owned_jobs.reshape(-1).astype(np.int64),
                           device=dev)
    total.index_put_((jobs,), part.reshape(K * J_own, K, plan.d),
                     accumulate=True)
    return total.transpose(0, 1).contiguous()


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
# multi-wave streaming and the degraded lane (the training grad-sync path)
# --------------------------------------------------------------------- #
#: where the arguments of the JAX stream that are not ported yet point
_ITEM7 = ("is not ported yet (ROADMAP.md, Queue 1 item 7: the two-level "
          "topology, gateway failover and verify_wire)")


class ShuffleStream:
    """Multi-wave, double-buffered runner of :func:`camr_shuffle`, with a
    degraded lane for a failed-worker set: the JAX stream's flat,
    unverified lanes.

    * **sync** — one wave ``[K, J_own, k-1, K, d]`` through the stream's
      executor, output left on the device: the training grad-sync path.
    * **wave batching** — :meth:`submit` stacks ``wave_batch`` waves
      along the value axis (``torch.cat`` on the device) and runs them
      as ONE shuffle of width ``W*d``. Every step of the codec is
      elementwise per value column, so the split outputs are bitwise the
      per-wave outputs.
    * **depth** — each dispatch records a CUDA event after its kernels;
      once more than ``depth`` dispatches are in flight the oldest one's
      event is waited on and its output copied to the host, so the host
      prepares wave ``t+1`` while the card runs wave ``t``.
      :meth:`drain` returns host tensors ``[K, J, d]`` in submission
      order (tensors, not numpy arrays: numpy has no bf16). On the CPU
      the same code runs without events.
    * **degraded lane** — :meth:`degrade` swaps later dispatches to the
      survivor-set executor of :func:`repro_torch.runtime.fault
      .build_degraded_executor` (``degraded_lane="device"``, served from
      the process-wide :data:`~repro_torch.core.schedule.EXEC_CACHE`;
      zero builds after :meth:`warm_degraded_execs`), or to the fault
      runtime's host interpreter ``degraded_shuffle_host``
      (``degraded_lane="host"``, the oracle the device lane is held to;
      it runs only when asked for). Both fold in the engine's canonical
      order, so their output is bitwise the healthy shuffle of the same
      contributions. :meth:`restore` returns to the healthy executors,
      which stay built.

    ``compiles`` counts healthy executor builds (one plan and one set of
    device tables per stacked width), ``degraded_compiles`` degraded
    executor builds, ``dispatches`` the shuffles run and ``swaps`` the
    degrade/restore events. The two-level ``topology``,
    ``gateway_avoid``, ``verify_wire`` and ``max_replays`` are refused
    (ROADMAP.md, Queue 1 item 7).
    """

    def __init__(self, q: int, k: int, d: int, *, device=None,
                 depth: int = 2, wave_batch: int = 1,
                 mode: str = "batched", router: str = "all_to_all",
                 codec: str = "fused", degraded_lane: str = "device",
                 topology=None, gateway_avoid=frozenset(),
                 verify_wire: bool = False, max_replays: int = 2):
        if k < 3:
            raise ValueError("the coded collective path requires k >= 3")
        if d % (k - 1):
            # every stacked width W*d inherits divisibility from d, so a
            # stream never fails mid-flight on a partial trailing batch
            raise ValueError(f"shard width d={d} must be divisible by "
                             f"k-1={k - 1}")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if wave_batch < 1:
            raise ValueError("wave_batch must be >= 1")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if router not in ("all_to_all", "ppermute"):
            raise ValueError(f"unknown router {router!r}")
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}")
        if degraded_lane not in ("device", "host"):
            raise ValueError(f"unknown degraded_lane {degraded_lane!r}")
        if resolve_topology(topology, q, k) is not None:
            raise NotImplementedError(f"topology={topology!r} {_ITEM7}")
        if gateway_avoid:
            raise NotImplementedError(f"gateway_avoid {_ITEM7}")
        if verify_wire:
            raise NotImplementedError(f"verify_wire {_ITEM7}")
        if max_replays != 2:
            raise NotImplementedError(f"max_replays (of verify_wire) "
                                      f"{_ITEM7}")
        self.q, self.k, self.d = q, k, d
        self.K = q * k
        self.device = resolve_device(device)
        self.depth, self.wave_batch = depth, wave_batch
        self.mode, self.router, self.codec = mode, router, codec
        self.degraded_lane = degraded_lane
        self._plans: dict = {}                 # stacked width W -> plan
        self._pending: list = []               # waves awaiting dispatch
        self._in_flight: deque = deque()       # (out, W, t0, event)
        self._done: list = []                  # host [K, J, d] outputs
        self._failed: frozenset = frozenset()  # current survivor-set gap
        self.dispatches = 0
        self.compiles = 0
        self.degraded_compiles = 0
        self.swaps = 0
        self.wave_times: list[float] = []      # dispatch -> collect, s

    # -- healthy executor per stacked width ----------------------------- #
    def _executor(self, W: int = 1) -> CAMRPlan:
        plan = self._plans.get(W)
        if plan is None:
            plan = make_plan(self.q, self.k, W * self.d)
            _device_tables(plan, self.device, self.router, self.codec,
                           self.mode)
            self._plans[W] = plan
            self.compiles += 1
        return plan

    def _run(self, buf: torch.Tensor, W: int) -> torch.Tensor:
        if self._failed:
            return self._degraded_exec(buf, W)
        return camr_shuffle(self._executor(W), buf, mode=self.mode,
                            router=self.router, codec=self.codec)

    # -- live elasticity ------------------------------------------------ #
    @property
    def failed(self) -> frozenset:
        return self._failed

    def _program(self, W: int = 1):
        return SCHEDULE_CACHE.program(self.q, self.k, Q=self.K,
                                      d=W * self.d)

    def degrade(self, failed) -> None:
        """Swap later dispatches to the survivor set ``failed``.
        Unrecoverable sets raise ``ValueError`` here, as
        ``lower_degraded`` does; the re-lowering comes from the warm
        :data:`SCHEDULE_CACHE`. Waves already in flight complete as they
        were dispatched."""
        failed = frozenset(int(s) for s in failed)
        if not failed:
            self.restore()
            return
        SCHEDULE_CACHE.degraded(self._program(), set(failed))
        if failed != self._failed:
            self._failed = failed
            self.swaps += 1

    def restore(self) -> None:
        """Re-admit everyone: later dispatches run the healthy executors
        again, which stayed built (``compiles`` flat)."""
        if self._failed:
            self._failed = frozenset()
            self.swaps += 1

    def _degraded_fn(self, W: int, dtype: torch.dtype, failed=None):
        """The degraded executor for stack width ``W``, value ``dtype``
        and the survivor set, from the process-wide EXEC_CACHE: a later
        stream of the same shape, or a :meth:`warm_degraded_execs` before
        any failure, makes a mid-stream degrade build-free."""
        from ..runtime.fault import build_degraded_executor
        failed = self._failed if failed is None else failed
        key = ("spmd_degraded", self.q, self.k, self.K, W * self.d,
               _dtype_name(dtype), tuple(sorted(failed)), None,
               str(self.device))

        def build():
            self.degraded_compiles += 1
            return build_degraded_executor(self._program(W), failed,
                                           W * self.d, dtype, self.device)

        return EXEC_CACHE.get(key, build)

    def warm_degraded_execs(self, *, max_failures: int = 1, widths=(1,),
                            dtype=torch.float32) -> int:
        """Build the degraded executor of every recoverable survivor set
        with up to ``max_failures`` failures (x stack ``widths`` x
        ``dtype``) after the schedule warm-up of
        ``ScheduleCache.warm_survivors``: a later :meth:`degrade` then
        builds nothing. Returns the number of executors now resident."""
        prog = self._program()
        SCHEDULE_CACHE.warm_survivors(prog, max_failures=max_failures)
        warmed = 0
        for r in range(1, max_failures + 1):
            for combo in combinations(range(self.K), r):
                fs = frozenset(combo)
                try:
                    SCHEDULE_CACHE.degraded(prog, set(fs))
                except ValueError:
                    continue                   # unrecoverable: skip
                for W in widths:
                    self._degraded_fn(W, dtype, failed=fs)
                    warmed += 1
        return warmed

    def _degraded_exec(self, buf: torch.Tensor, W: int) -> torch.Tensor:
        """A degraded wave over the stacked ``[K, J_own, k-1, K, W*d]``
        tensor, in logical slots, on the stream's device.
        ``degraded_lane="device"`` runs the device executor;
        ``"host"`` copies the wave to the host and interprets the
        re-lowering there (bf16 as ``uint16`` bits combined with
        ``bf16_add``, u32 as ``uint32`` words), then copies the result
        back."""
        if self.degraded_lane == "device":
            return self._degraded_fn(W, buf.dtype)(buf)
        from ..runtime.fault import degraded_shuffle_host
        from ..runtime.train_loop import bf16_add
        # bf16 (no numpy dtype) and u32 (no numpy bridge) cross as bits
        word, host, combine = {
            torch.bfloat16: (torch.int16, np.uint16, bf16_add),
            torch.uint32: (torch.int32, np.uint32, np.add),
        }.get(buf.dtype, (buf.dtype, None, np.add))
        x = buf.view(word).cpu().numpy()
        out = degraded_shuffle_host(self._program(W), self._failed,
                                    x.view(host or x.dtype), combine=combine)
        return torch.from_numpy(out.view(x.dtype)).view(buf.dtype).to(
            self.device)

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
        executor (the degraded one while workers are failed); returns the
        ``[K, J, d]`` output on the stream's device (no host copy).
        Independent of the submit/drain window."""
        self._check_wave(contribs)
        self.dispatches += 1
        return self._run(contribs, 1)

    # -- streaming ------------------------------------------------------ #
    def submit(self, contribs: torch.Tensor) -> None:
        """Queue one wave ``[K, J_own, k-1, K, d]``; dispatches as soon as
        ``wave_batch`` waves are pending. Blocks only when more than
        ``depth`` dispatches are in flight."""
        self._check_wave(contribs)
        if self._pending and contribs.dtype != self._pending[0].dtype:
            raise ValueError(f"wave dtype {contribs.dtype} != the pending "
                             f"waves' {self._pending[0].dtype}: stacked "
                             "waves share one dtype")
        self._pending.append(contribs)
        if len(self._pending) >= self.wave_batch:
            self._dispatch()

    def _dispatch(self) -> None:
        waves, self._pending = self._pending, []
        if not waves:
            return
        W = len(waves)
        buf = waves[0] if W == 1 else torch.cat(waves, dim=-1)
        del waves
        t0 = time.perf_counter()
        out = self._run(buf, W)
        del buf
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self.dispatches += 1
        self._in_flight.append((out, W, t0, event))
        while len(self._in_flight) > self.depth:
            self._collect_oldest()

    def _collect_oldest(self) -> None:
        out, W, t0, event = self._in_flight.popleft()
        if event is not None:
            event.synchronize()
        host = out.cpu()                                  # [K, J, W*d]
        self.wave_times.append(time.perf_counter() - t0)
        if W == 1:
            self._done.append(host)
        else:
            self._done.extend(host[..., w * self.d:(w + 1) * self.d]
                              for w in range(W))

    def drain(self) -> list[torch.Tensor]:
        """Flush pending waves, wait for everything in flight, and return
        every completed ``[K, J, d]`` output (on the host) in submission
        order."""
        self._dispatch()
        while self._in_flight:
            self._collect_oldest()
        done, self._done = self._done, []
        return done

    def run_waves(self, waves) -> list[torch.Tensor]:
        """Submit every wave, then drain."""
        for w in waves:
            self.submit(w)
        return self.drain()

    def stats(self) -> dict:
        """Executor-reuse counters (``compiles`` stays flat while
        ``dispatches`` grows on a steady-state stream, across
        degrade/restore ``swaps`` too)."""
        return dict(dispatches=self.dispatches, compiles=self.compiles,
                    widths=sorted(self._plans), swaps=self.swaps,
                    failed=tuple(sorted(self._failed)),
                    degraded_compiles=self.degraded_compiles,
                    degraded_lane=self.degraded_lane, mode=self.mode,
                    router=self.router, codec=self.codec,
                    device=str(self.device))
