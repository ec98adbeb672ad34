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
in every mode and codec, on both wire lanes: 4-byte payloads (f32/u32)
one value per u32 wire word, and 16-bit payloads (bf16/f16) packed two
per word (by the 16-bit gather kernels on the fused codec, as u32 words
on the multipass codec), with stage 3 and assembly at native width.

Two-level topology (a plan made with ``topology=``): phase A is the
flat round exchange driven by the primary-masked send tables of
:class:`~repro_torch.core.schedule.HostTables` (one copy of a packet
per remote host, the gateway's), phase B relays each gateway's copy to
the other receivers on its host, one row gather per live (round,
shift) lane (:func:`_route_rows_two_level`). The rebuilt receive buffer
is word for word the flat one, so the output is bitwise the flat
schedule's. ``verify_wire=True`` widens every packet row by one u32
checksum word and counts the decoded rows whose checksum mismatches.

Process lane (``camr_shuffle(..., mesh=)``, a
:class:`~repro_torch.launch.mesh.CAMRMesh`): each ``torch.distributed``
process holds one block of workers and runs the same body with every
table sliced to its block, in every mode and option; the rows whose
sender and receiver lie in different processes cross over
``all_to_all_single`` (one a batched stage, one a looped permutation
that crosses; the JAX executor's ``shard_map`` over a mesh that spans
processes), and the outputs are bitwise the stacked executor's.
``ShuffleStream(mesh=)`` streams a block's waves.

Collective ledger: each place that stands in for a collective of the
JAX executor reports its kind and per-device result bytes to
:func:`repro_torch.core.collective_stats.note`, which records them
only inside a ``record_collectives()`` block (the counterpart of the JAX
package's HLO parse).
"""

from __future__ import annotations

import contextlib
import math
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
from .collective_stats import note
from .spans import Recorder, current, span
from .schedule import (EXEC_CACHE, SCHEDULE_CACHE, HostTables,
                       ShuffleProgram, StageTables, Topology, payload_words,
                       resolve_topology)

__all__ = ["CAMRPlan", "make_plan", "camr_shuffle", "scatter_contributions",
           "camr_shuffle_reference", "uncoded_reduce_scatter",
           "camr_collective_bytes", "camr_edge_bytes",
           "expected_collective_calls",
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
    #: stage: one per (group, round) of the looped exchange, one per live
    #: relay lane of the two-level exchange and one per stage-3 offset
    #: (the batched exchange is one routed row gather)
    permutations: dict = field(
        default_factory=lambda: {"stage12": 0, "stage3": 0}, repr=False,
        compare=False)
    #: the process lane's record of its last shuffle with this plan, by
    #: stage: bytes and rows sent to other processes, the exchange's host
    #: staging and gloo ms, and the encode / exchange / decode ms
    process_stats: dict = field(default_factory=dict, repr=False,
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

    @property
    def topology(self) -> Topology | None:
        """The topology the program was lowered for (None == flat)."""
        return self.program.topology


def make_plan(q: int, k: int, d: int, topology: Topology | None = None, *,
              gateway_avoid=frozenset()) -> CAMRPlan:
    """Lower the schedule of a (q, k) CAMR cluster (served from the
    structural :data:`~repro_torch.core.schedule.SCHEDULE_CACHE`).

    ``topology=None`` (or flat) lowers the flat schedule; a two-level
    :class:`~repro_torch.core.schedule.Topology` also lowers the
    host-aware relay overlay (an ``AutoTopology`` marker resolves through
    the cost model first). ``gateway_avoid`` re-homes phase-A gateways
    away from the named devices. Outputs are bitwise identical for every
    topology and gateway assignment."""
    if k < 3:
        raise ValueError("the coded collective path requires k >= 3")
    if d % (k - 1):
        raise ValueError(f"shard width d={d} must be divisible by k-1={k - 1}")
    program = SCHEDULE_CACHE.program(q, k, Q=q * k, d=d, topology=topology,
                                     gateway_avoid=gateway_avoid)
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
def _route_rows(T: StageTables, router: str, q: int, k: int, K: int,
                a2a_send=None, pp_send=None) -> np.ndarray:
    """The stacked exchange of both routers, run on packet row ids.

    Returns ``[K, n, k-1]``: for device ``s``, group row ``i`` and round
    ``r``, the row of the stacked Δ buffer ``[K*n, pk]`` whose packet
    lands in ``recv[s, i, r-1]``, or -1 where the exchange delivers a
    zero block. Mirrors ``_stage_coded_batched`` of the JAX package line
    for line, with row ids in place of packet words. ``a2a_send`` /
    ``pp_send`` replace the stage's send tables (phase A of the two-level
    exchange passes the primary-masked ones of its ``HostTables``).
    """
    a2a_send = T.a2a_send if a2a_send is None else a2a_send
    pp_send = T.pp_send if pp_send is None else pp_send
    n, R = T.n, int(T.R)
    ar = np.arange(K)
    ids = np.arange(K * n).reshape(K, n)              # my Δ rows, stacked
    src = np.empty((K, n, k - 1), np.int64)
    for r in range(1, k):
        if router == "all_to_all":
            idx = a2a_send[r - 1]                     # [K_src, K_dst, R]
            buf = np.where(idx >= 0,
                           ids[ar[:, None, None], np.clip(idx, 0, None)], -1)
            got = buf.swapaxes(0, 1)                  # tiled all_to_all
            flat = got.reshape(K, K * R)
            slot = T.a2a_recv[r - 1]                  # [K, n]
        elif router == "ppermute":
            parts = []
            for dd in range(q):
                idx = pp_send[r - 1, dd]              # [K, R]
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


def _route_rows_two_level(T: StageTables, X: HostTables, router: str,
                          q: int, k: int, K: int):
    """The two-level exchange of one coded stage, run on packet row ids:
    ``_stage_coded_two_level`` of the JAX package line for line.

    Returns ``(a_rows, lanes)``. ``a_rows [K, n, k-1]`` is phase A: the
    flat round exchange driven by the primary-masked send tables
    ``X.a2a_send`` / ``X.pp_send``, -1 where a slot receives a zero block.
    ``lanes`` holds one ``(dst, src)`` pair of row arrays per live
    (round, shift) lane of phase B, both rows of the stacked phase-A
    buffer ``[K*n*(k-1), pk]``: the relay (``X.b_send`` gathered on the
    gateway, moved over ``X.b_perms``) fills slot ``dst`` of the lane's
    round with the phase-A packet in slot ``src``, at the slots
    ``X.b_mask`` marks and ``X.b_recv`` points into the lane's part of
    the round's relay buffer.
    """
    a_rows = _route_rows(T, router, q, k, K, X.a2a_send, X.pp_send)
    n, Rb = T.n, int(X.Rb)
    ar = np.arange(K)
    ids = np.arange(K * n * (k - 1)).reshape(K, n * (k - 1))
    lanes = []
    for r in range(1, k):
        live = X.b_live[r - 1]
        if not live:
            continue
        parts = []
        for di in live:
            idx = X.b_send[r - 1, di]                 # [K, Rb]
            buf = np.where(idx >= 0,
                           ids[ar[:, None], np.clip(idx, 0, None)], -1)
            moved = np.full_like(buf, -1)
            for a, b in X.b_perms[di]:
                moved[b] = buf[a]
            parts.append(moved)
        relay = np.concatenate(parts, axis=1)         # [K, len(live)*Rb]
        slot, mask = X.b_recv[r - 1], X.b_mask[r - 1]  # [K, n]
        for j in range(len(live)):                    # lane j's slots
            s, i = np.nonzero(mask & (slot // Rb == j))
            lanes.append(((s * n + i) * (k - 1) + r - 1,
                          relay[s, slot[s, i]]))
    # a relay source is a primary slot phase A filled, never a slot phase
    # B fills: so phase B may write its slots in place in any lane order
    dst = np.concatenate([d for d, _ in lanes] or [np.zeros(0, np.int64)])
    src = np.concatenate([s for _, s in lanes] or [np.zeros(0, np.int64)])
    flat_a = a_rows.reshape(-1)
    if not ((src >= 0).all() and (flat_a[src] >= 0).all()
            and (flat_a[dst] < 0).all() and len(np.unique(dst)) == len(dst)):
        raise RuntimeError("two-level relay tables break phase B's in-place "
                           "invariant: every source must be a slot phase A "
                           "filled, every destination a distinct slot it "
                           "left zero")
    return a_rows, lanes


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


def _round_ops(T: StageTables, router: str, K: int, q: int) -> list:
    """The collectives of one round of the JAX executor's batched
    exchange, as ``(kind, packet rows of its per-device result)``: one
    ``all_to_all`` of ``[K, R, pk]``, or ``q`` ppermutes of ``[R, pk]``
    (the ledger of :mod:`repro_torch.core.collective_stats`)."""
    R = int(T.R)
    if router == "all_to_all":
        return [("all-to-all", K * R)]
    return [("collective-permute", R)] * q


def _batched_tables(plan: CAMRPlan, stage: int, router: str, t) -> dict:
    """Batched exchange: the routed row of every received round packet."""
    T = plan.program.stage_tables(stage)
    return dict(_recv_tables(_route_rows(T, router, plan.q, plan.k, plan.K),
                             t),
                round_ops=_round_ops(T, router, plan.K, plan.q))


def _recv_tables(rows: np.ndarray, t) -> dict:
    """Routed rows -> the gather index and the zero-block mask."""
    rows = rows.reshape(-1)
    ok = rows >= 0
    return dict(recv_rows=t(np.clip(rows, 0, None), torch.int64),
                recv_zero=None if ok.all() else t(~ok, torch.bool))


def _two_level_tables(plan: CAMRPlan, stage: int, router: str, t) -> dict:
    """Two-level exchange: phase A's routed rows (under the batched
    exchange's names, as :func:`_exchange` runs it) and phase B's relay
    lanes."""
    prog = plan.program
    T = prog.stage_tables(stage)
    a_rows, lanes = _route_rows_two_level(
        T, prog.host_tables(stage), router, plan.q, plan.k, plan.K)
    return dict(_recv_tables(a_rows, t),
                round_ops=_round_ops(T, router, plan.K, plan.q),
                relay=[(t(d, torch.int64), t(s, torch.int64))
                       for d, s in lanes],
                relay_rows=int(prog.host_tables(stage).Rb))


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
    return dict(loop_src=t(np.clip(loop_src, 0, None), torch.int64),
                loop_zero=t(loop_src < 0, torch.bool))


#: the stage tables each codec and each exchange reads
_STAGE_PARTS = {"fused": _fused_tables, "multipass": _multipass_tables,
                "batched": _batched_tables, "looped": _looped_tables,
                "two_level": _two_level_tables}


def _device_tables(plan: CAMRPlan, device: torch.device, router: str,
                   codec: str = "fused", mode: str = "batched") -> dict:
    """The executor's index tables on ``device``, cached on the plan per
    (device, router): the shared ones on first use, each coded stage's
    tables of a codec or an exchange the first time a shuffle runs that
    codec or exchange (a two-level plan's batched mode is the
    ``"two_level"`` exchange)."""
    if mode == "batched" and plan.topology is not None:
        mode = "two_level"

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
    """Tables of every codec and mode: each coded stage's group count,
    chunk mask and group membership, stage 3 and assembly."""
    prog = plan.program
    q, K, J, J_own = plan.q, plan.K, plan.J, plan.J_own
    stages = {}
    for stage in (1, 2):
        T = prog.stage_tables(stage)
        stages[stage] = dict(n=T.n, src_ok=t(T.src_ok, torch.bool),
                             valid=t(T.valid, torch.bool), parts=set())
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


def _note_rounds(st, *, k, pk) -> None:
    """The ledger's record of a stage's ``k-1`` batched rounds."""
    for _ in range(k - 1):
        for kind, rows in st["round_ops"]:
            note(kind, rows * pk * 4)


def _exchange(delta, st, *, K, k, pk):
    """The batched round exchange (phase A of the two-level one):
    ``recv [K, n*(k-1), pk]``, round packets in the ``[n, k-1]`` order the
    decode indexes."""
    _note_rounds(st, k=k, pk=pk)
    recv = delta.reshape(-1, pk).index_select(0, st["recv_rows"])
    if st["recv_zero"] is not None:
        recv.masked_fill_(st["recv_zero"][:, None], 0)
    return recv.view(K, st["n"] * (k - 1), pk)


def _relay(recv, st, calls, *, pk):
    """Phase B of the two-level exchange, in place on phase A's ``recv``:
    per live (round, shift) lane, one row gather of gateway copies that
    fills the slots phase A left zero. Every source is a slot phase A
    filled and no lane writes one (:func:`_route_rows_two_level` checks
    it), so each lane reads the phase-A buffer as phase A left it."""
    rows = recv.view(-1, pk)
    for dst, src in st["relay"]:
        rows.index_copy_(0, dst, rows.index_select(0, src))
        calls["stage12"] += 1
        note("collective-permute",
             st["relay_rows"] * pk * rows.element_size())
    return recv


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
            note("collective-permute", pk * got.element_size())
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


def _stage_coded(wire, st, calls, *, K, k, pk, mode, codec, corrupt=None,
                 check=None):
    """One coded stage of every device: encode, exchange (batched,
    two-level or looped), decode, each a span (``shuffle.encode``,
    ``shuffle.exchange``, ``shuffle.decode``). ``corrupt = (device, row,
    word, bits)`` XORs ``bits`` (an int32 pattern) into one word of that
    device's Δ after the encode, as a bit flip in transit would: every
    receiver of the packet, relayed ones included, gets the tampered
    word. ``check(dec)``, the verified wire's receiver check, runs in the
    decode's span."""
    with span("shuffle.encode"):
        ctx, delta = _encode_stage(wire, st, K=K, k=k, pk=pk, codec=codec)
        _tamper(delta, corrupt, 0, K)
    with span("shuffle.exchange"):
        if mode == "looped":
            recv = _exchange_looped(delta, st, calls, K=K, k=k, pk=pk)
        else:
            recv = _exchange(delta, st, K=K, k=k, pk=pk)
            if "relay" in st:
                recv = _relay(recv, st, calls, pk=pk)
    del delta
    with span("shuffle.decode"):
        if codec == "multipass":    # rebinding frees the chunk table
            ctx = _cancellations(ctx, st, K=K, k=k)
        dec = _decode_stage(recv, ctx, st, K=K, k=k, pk=pk, codec=codec)
        return dec if check is None else check(dec)


def _tamper(delta, corrupt, lo: int, hi: int) -> None:
    """XOR a fault spec ``(device, row, word, bits)`` into Δ ``[hi-lo, n,
    pk]`` of the workers ``[lo, hi)``, when its device is one of them."""
    if corrupt is not None and lo <= corrupt[0] < hi:
        cdev, crow, cword, cbits = corrupt
        delta[cdev - lo, crow, cword] ^= cbits


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of the words along the last axis (int32): a halving tree of
    ``bitwise_xor``, the odd tail folded into the first column. XOR is
    associative and commutative, so the bits are those of any order."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = torch.bitwise_xor(x[..., :h], x[..., h:2 * h])
        if x.shape[-1] % 2:
            y[..., :1] ^= x[..., 2 * h:]
        x = y
    return x[..., 0]


def _widen(wire: torch.Tensor, k: int, pk: int) -> torch.Tensor:
    """int32 wire words ``[..., (k-1)*pk]`` -> ``[..., (k-1)*(pk+1)]``:
    each packet followed by its checksum word, the XOR of its words. The
    fused tables index packet ROWS, so they drive the widened buffer."""
    w4 = wire.view(*wire.shape[:-1], k - 1, pk)
    wide = torch.cat([w4, _xor_reduce(w4)[..., None]], dim=-1)
    return wide.view(*wire.shape[:-1], (k - 1) * (pk + 1))


def _check_corrupt(stage: int, device: int, row, bits: int, K: int,
                   n_rows) -> None:
    """Range checks of a wire-fault spec, shared by :func:`camr_shuffle`
    and :meth:`ShuffleStream.inject_corruption`. ``n_rows(stage)`` is the
    stage's group-row count; ``row=None`` (the stream's "first group row
    of ``device``") is not checked. The word's range depends on the
    wave's dtype, so :func:`camr_shuffle` checks it alone."""
    if stage not in (1, 2):
        raise ValueError(f"corrupt stage {stage} is not a coded stage "
                         "(1 or 2)")
    if not 0 <= device < K:
        raise ValueError(f"corrupt device {device} outside [0, {K})")
    if row is not None and not 0 <= row < n_rows(stage):
        raise ValueError(f"corrupt row {row} outside stage {stage}'s "
                         f"[0, {n_rows(stage)})")
    if not 0 < bits < 2 ** 32:
        raise ValueError("corrupt bits must be a nonzero u32 pattern")


def _int32_bits(bits: int) -> int:
    """A u32 pattern in [1, 2**32) as the int32 of the same bits."""
    return bits - 2 ** 32 if bits >= 2 ** 31 else bits


def _check_call(plan: CAMRPlan, *, mode, router, codec, debug,
                verify_wire, corrupt) -> None:
    """The argument checks of :func:`camr_shuffle`, shared by both
    lanes."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")
    if router not in ("all_to_all", "ppermute"):
        raise ValueError(f"unknown router {router!r}")
    if plan.topology is not None and mode != "batched":
        raise ValueError("two-level topology requires mode='batched' "
                         "(the looped legacy router has no host-aware "
                         "relay lane)")
    if verify_wire:
        if codec != "fused" or mode != "batched":
            raise ValueError("verify_wire requires codec='fused' and "
                             "mode='batched' (the checksum word rides "
                             "the row-oriented fused index tables)")
        if debug:
            raise ValueError("verify_wire and debug are mutually "
                             "exclusive (different return shapes)")
    elif corrupt is not None:
        raise ValueError("corrupt injection without verify_wire would "
                         "silently mis-reduce — exactly the failure mode "
                         "the integrity lane exists to rule out")


def _corrupt_spec(corrupt, K: int, n_rows, pkv: int) -> dict:
    """``corrupt=(stage, device, row, word, bits)`` -> ``{stage: (device,
    row, word, int32 bits)}``, range-checked (``{}`` for None)."""
    if corrupt is None:
        return {}
    cst, cdev, crow, cword, cbits = (int(x) for x in corrupt)
    _check_corrupt(cst, cdev, crow, cbits, K, n_rows)
    if not 0 <= cword < pkv:
        raise ValueError(f"corrupt word {cword} outside packet "
                         f"[0, {pkv})")
    return {cst: (cdev, crow, cword, _int32_bits(cbits))}


def _verify_rows(dec, st, bad, *, k, pk, wp):
    """The receiver's check of a verified stage: recompute each decoded
    row's checksum and add the mismatching rows of groups the worker is
    a member of (the others decode garbage) to ``bad``; returns the
    payload words ``[K_b, n, wp]``, bit for bit the unverified decode's."""
    Kb, n = dec.shape[0], st["n"]
    dec = dec.view(Kb, n, k - 1, pk + 1)
    payload = dec[..., :pk]
    wrong = (_xor_reduce(payload) != dec[..., pk]) & st["valid"][..., None]
    bad += wrong.sum(dim=(1, 2), dtype=torch.int32)
    return payload.reshape(Kb, n, wp).contiguous()


def _fold_stored(vals, ar, shard):
    """``vals[s, :, :, shard[s]]`` folded over the stored-batch axis ->
    ``[K, J_own, d]``: a sequential ascending left fold, the canonical
    combine order of the engine's reduce phase (a ``.sum()`` would pick
    its own reduction order and break the bitwise contract)."""
    acc = vals[ar, :, 0, shard]
    for b in range(1, vals.shape[2]):
        acc = acc + vals[ar, :, b, shard]
    return acc


def _stage3(vals, ar, dst, deliver, permutations):
    """Stage 3, the intra-class unicasts, for the workers ``ar``: for each
    offset ``o`` every worker folds its stored batches of shard
    ``dst[o]`` (its classmate's at that offset), and ``deliver(o, pay)``
    hands each worker the fold its sender made for it -> ``[len(ar), q-1,
    J_own, d]``. One permutation an offset (``permutations``)."""
    s3_out = torch.empty((len(ar), len(dst), vals.shape[1], vals.shape[-1]),
                         dtype=vals.dtype, device=vals.device)
    for o, shard in enumerate(dst):
        pay = _fold_stored(vals, ar, shard)
        s3_out[:, o] = deliver(o, pay)
        permutations["stage3"] += 1
        note("collective-permute", pay[0].numel() * pay.element_size())
        del pay             # free before the next offset's payload
    return s3_out


def _assemble(stage_vals, s3_out, vals, ar, own, t, *, J, d):
    """Reduce-side assembly of the workers ``ar``: an owner adds its own
    fold (its stored batches of shard ``own``) to its stage-1 value, the
    others add the stage-3 unicast to their stage-2 value -> ``[len(ar),
    J, d]`` in the arithmetic dtype. ``t`` holds the block's rows
    (``own_rows``, ``own_sum_rows``, ``non_rows``, ``non_s2_rows``,
    ``non_s3_rows``); each stage's value is popped from ``stage_vals``,
    and freed, once used."""
    own_sum = _fold_stored(vals, ar, own)                   # [., J_own, d]
    out = torch.empty((len(ar) * J, d), dtype=vals.dtype, device=vals.device)
    s1 = stage_vals.pop(1).reshape(-1, d)
    out[t["own_rows"]] = (s1.index_select(0, t["own_rows"])
                          + own_sum.reshape(-1, d).index_select(
                              0, t["own_sum_rows"]))
    del s1, own_sum         # free before the non-owner gathers
    s2 = stage_vals.pop(2).reshape(-1, d)
    out[t["non_rows"]] = (s2.index_select(0, t["non_s2_rows"])
                          + s3_out.reshape(-1, d).index_select(
                              0, t["non_s3_rows"]))
    return out.view(len(ar), J, d)


# --------------------------------------------------------------------- #
# the shuffle
# --------------------------------------------------------------------- #
def camr_shuffle(plan: CAMRPlan, contribs: torch.Tensor, *,
                 mode: str = "batched", router: str = "all_to_all",
                 codec: str = "fused", debug: bool = False,
                 verify_wire: bool = False, corrupt=None, mesh=None):
    """3-stage CAMR coded shuffle of all K virtual devices at once:
    ``contribs [K, J_own, k-1, K, d] -> [K, J, d]``.

    Runs on the device of ``contribs``: the CUDA codec kernels on a card,
    their plain versions on the CPU. Outputs are BITWISE equal to the
    numpy engine's reduce results in every ``mode`` (``"batched"``, or the
    legacy ``"looped"`` per-group exchange, which ignores ``router``),
    every ``codec`` (``"fused"`` gathers, or the ``"multipass"`` oracle)
    and every topology of the plan (a two-level plan runs the batched
    mode only): XOR delivery is lossless and assembly folds the stored
    batches in the engine's canonical order. bf16/f16 contributions take
    the packed lane: two values per u32 wire word through stages 1 and 2
    (half the bytes of an f32 shuffle of the same ``d``), stage 3 and
    assembly in the payload dtype.

    ``debug=True`` returns the JAX executor's debug dict, stacked over the
    device axis: ``out``, ``stage1``, ``stage2``, ``stage3`` and
    ``own_sum`` ``[K, J, d]`` (each device's selections of every job row,
    garbage where the row is not its own to decode) and ``is_own``
    ``bool[K, J]``.

    ``verify_wire=True`` runs the self-verifying wire: every coded packet
    row carries one more u32 word, the XOR of its payload words, through
    the u32 gather kernels on both lanes (16-bit payloads as their wire
    words), and the receiver recomputes the checksum of each decoded row
    it is a member for. Returns ``(out, bad)``, ``bad`` ``int32[K]`` the
    mismatching rows per device: 0 on a clean wire, and any single
    corrupted word of stages 1 and 2 (payload or checksum, flat or relay
    edge) is counted. ``corrupt=(stage, device, row, word, bits)`` XORs
    the u32 pattern ``bits`` into word ``word`` of row ``row`` of
    ``device``'s Δ in coded stage ``stage``, after the encode. Both need
    the fused codec and the batched mode.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.CAMRMesh`) runs the
    process lane: this process holds only its block of workers,
    ``contribs [K_local, J_own, k-1, K, d] -> [K_local, J, d]``, bitwise
    the same rows as the single-process shuffle, and the rows that cross
    processes go over ``torch.distributed`` (:func:`_shuffle_process`).

    Inside an open :class:`~repro_torch.core.spans.Recorder` the parts are
    timed as spans: ``shuffle.wire`` (the wire buffer), ``shuffle.encode``,
    ``shuffle.exchange`` and ``shuffle.decode`` (once a coded stage; the
    verified wire's checksum check in the decode's), ``shuffle.stage3``
    and ``shuffle.assemble``.
    """
    _check_call(plan, mode=mode, router=router, codec=codec, debug=debug,
                verify_wire=verify_wire, corrupt=corrupt)
    check_codec_dtype(contribs.dtype, "camr_shuffle")
    if mesh is not None:
        return _shuffle_process(plan, contribs, mesh, mode=mode,
                                router=router, codec=codec, debug=debug,
                                verify_wire=verify_wire, corrupt=corrupt)
    k, K, J, J_own, d = plan.k, plan.K, plan.J, plan.J_own, plan.d
    if tuple(contribs.shape) != (K, J_own, k - 1, K, d):
        raise ValueError(f"contribs shape {tuple(contribs.shape)} != "
                         f"{(K, J_own, k - 1, K, d)}")
    dtype = contribs.dtype
    contribs = contribs.contiguous()
    tabs = _device_tables(plan, contribs.device, router, codec, mode)
    # wp u32 words per shard: d for 4-byte dtypes, ceil(d/2) padded to a
    # packet multiple for packed 16-bit ones
    wp = payload_words(d, contribs.element_size(), k)
    pk = wp // (k - 1)
    pkv = pk + 1 if verify_wire else pk
    spec = _corrupt_spec(corrupt, K, lambda s: tabs["stages"][s]["n"], pkv)
    # [K, J_own, k-1, K, ...]; the verify lane takes every payload as its
    # int32 wire words (the multipass codec's view) and widens the rows
    with span("shuffle.wire"):
        wire = _wire_buffer(contribs, wp,
                            "multipass" if verify_wire else codec)
        if verify_wire:
            wire = _widen(wire, k, pk)
    if verify_wire:
        bad = torch.zeros(K, dtype=torch.int32, device=contribs.device)

    # ========== stages 1 + 2: one shared coded-exchange machine ======== #
    stage_vals = {}
    for stage in (1, 2):
        st = tabs["stages"][stage]
        check = ((lambda dec, st=st: _verify_rows(dec, st, bad, k=k, pk=pk,
                                                  wp=wp))
                 if verify_wire else None)
        dec = _stage_coded(wire, st, plan.permutations, K=K, k=k, pk=pkv,
                           mode=mode, codec=codec, corrupt=spec.get(stage),
                           check=check)
        stage_vals[stage] = _from_wire(dec, dtype, d)   # [K, n, d]
    del wire
    vals = contribs.view(_arith_dtype(dtype))

    # ========== stage 3: intra-class unicasts (q-1 permutations) ======= #
    def deliver(o, pay):
        got = pay.index_select(0, tabs["s3_src"][o])
        if tabs["s3_zero"][o] is not None:
            got.masked_fill_(tabs["s3_zero"][o][:, None, None], 0)
        return got

    with span("shuffle.stage3"):
        s3_out = _stage3(vals, tabs["ar"], tabs["s3_dst"], deliver,
                         plan.permutations)              # [K, q-1, J_own, d]
    if debug:
        info = _debug_info(stage_vals, s3_out, vals, tabs["ar"], tabs, 0, K,
                           dtype)

    # ========== assemble (reduce-side tables of the program) ========== #
    with span("shuffle.assemble"):
        out = _assemble(stage_vals, s3_out, vals, tabs["ar"], tabs["ar"],
                        tabs, J=J, d=d).view(dtype)
    if debug:
        return dict(out=out, **info)
    if verify_wire:
        return out, bad
    return out


def _debug_info(stage_vals, s3_out, vals, ar, tabs, lo: int, hi: int,
                dtype) -> dict:
    """The JAX executor's debug dict of the workers ``[lo, hi)`` (rows
    ``ar`` of the block's tensors): ``stage1``, ``stage2``, ``stage3``,
    ``own_sum`` ``[., J, d]`` (each worker's selections of every job
    row) and ``is_own``."""
    r = ar[:, None]
    slot = tabs["own_slot"][lo:hi]
    own_sum = _fold_stored(vals, ar, ar + lo)
    info = dict(stage1=stage_vals[1],
                stage2=stage_vals[2][r, tabs["s2_ord"][lo:hi]],
                stage3=s3_out[r, tabs["s3_off"][lo:hi], slot],
                own_sum=own_sum[r, slot])
    info = {key: v.contiguous().view(dtype) for key, v in info.items()}
    return dict(info, is_own=tabs["is_own"][lo:hi])


# --------------------------------------------------------------------- #
# the process lane: one block of workers per torch.distributed process
# --------------------------------------------------------------------- #
#: per-device stage tables, sliced to a process's block of workers
_PER_DEVICE = ("src_ok", "valid", "enc_src", "dec_recv", "dec_src",
               "dec_mask", "src_jslot", "src_bslot", "delta_pos",
               "cancel_pos", "dec_order")


def _local_stage(st: dict, lo: int, hi: int, k: int) -> dict:
    """A coded stage's codec tables for the workers ``[lo, hi)`` only
    (views of the stacked executor's tables)."""
    out = {name: st[name][lo:hi] for name in _PER_DEVICE if name in st}
    out["n"] = st["n"]
    if "shard" in st:
        out["shard"] = st["shard"]
    if "cancel_mask" in st:
        out["cancel_mask"] = st["cancel_mask"].view(
            -1, st["n"] * (k - 1), k)[lo:hi].reshape(-1, k)
    return out


def _blocks(rows: np.ndarray, proc: np.ndarray, me: int, world: int,
            per: int):
    """Split routed rows by the process that holds their source.

    ``rows [world, m]`` holds, for every process's ``m`` receive slots in
    order, ``per`` slots a worker, the source row in its sender's
    numbering, ``proc`` the sender's process (-1: a zero slot). A row
    crosses once for each worker that takes it (one delivery of the
    lowered send tables; slots of groups a worker does not decode may
    take a delivered row again). Returns this process's local ``(slots,
    rows)``; the slots it fills from each other process in rank order
    with, for each, its index among the rows received (``recv_index``)
    and their counts; the rows it sends to each, in the order their
    receiver takes them; and whether any process receives a row from
    another (``active``: the exchange runs, in every process, or in
    none)."""
    def deliveries(dst, src):
        slots = np.nonzero(proc[dst] == src)[0]
        got = rows[dst][slots]
        key = (slots // per) * (int(rows.max()) + 1) + got
        _, first, inv = np.unique(key, return_index=True,
                                  return_inverse=True)
        return slots, got[first], inv.reshape(-1)

    others = [p for p in range(world) if p != me]
    local = np.nonzero(proc[me] == me)[0]
    recv = {p: deliveries(me, p) for p in others}
    send = {p: deliveries(p, me)[1] for p in others}
    rcount = [len(recv[p][1]) if p != me else 0 for p in range(world)]
    cat = lambda xs: np.concatenate(list(xs) or [np.zeros(0, np.int64)])
    start = np.cumsum([0] + rcount)
    return dict(local_slots=local, local_rows=rows[me][local],
                recv_slots=cat(recv[p][0] for p in others),
                recv_index=cat(recv[p][2] + start[p] for p in others),
                recv_counts=rcount,
                send_rows=cat(send[p] for p in others),
                send_counts=[len(send[p]) if p != me else 0
                             for p in range(world)],
                active=bool(((proc >= 0) & (proc != np.arange(world)[:, None])
                             ).any()))


def _perm_blocks(src: np.ndarray, Kl: int, W: int, me: int) -> dict:
    """A device-axis permutation, ``src[b]`` the sender of receiver ``b``
    (-1: none), split by process (:func:`_blocks`, one slot a worker)."""
    proc = np.where(src >= 0, src // Kl, -1)
    rows = np.where(src >= 0, src % Kl, -1)
    return _blocks(rows.reshape(W, Kl), proc.reshape(W, Kl), me, W, 1)


def _process_tables(plan: CAMRPlan, mesh, router: str, glob: dict,
                    device: torch.device) -> dict:
    """The process lane's exchange tables, cached on the plan per (world,
    rank, device, router): for each coded stage, the slots of this
    block's receive buffer filled from its own Δ rows, those filled by
    each other process and the rows it sends to each (the batched or
    two-level exchange of every worker, run on row ids, split by the
    process of the source), and the relay lanes of phase B (inside a
    process: host blocks must nest in process blocks); for each stage-3
    offset the same split of its intra-class unicasts; the assembly rows
    of the block, from the stacked executor's tables ``glob``."""
    key = ("process", mesh.world, mesh.rank, str(device), router)
    tabs = plan._tables.get(key)
    if tabs is not None:
        return tabs
    prog = plan.program
    q, k, K, W, me = plan.q, plan.k, plan.K, mesh.world, mesh.rank
    Kl = K // W
    lo = me * Kl
    proc_of = np.arange(K) // Kl

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def on(x):      # a _blocks split, its index arrays on the device
        return {name: v if name.endswith("counts") or name == "active"
                else idx(v) for name, v in x.items()}

    stages = {}
    for stage in (1, 2):
        T = prog.stage_tables(stage)
        n, S = T.n, T.n * (k - 1)
        if plan.topology is None:
            rows, lanes = _route_rows(T, router, q, k, K), []
        else:
            rows, lanes = _route_rows_two_level(
                T, prog.host_tables(stage), router, q, k, K)
        rows = rows.reshape(W, Kl * S)
        proc = np.where(rows >= 0, proc_of[np.clip(rows, 0, None) // n], -1)
        x = _blocks(np.where(rows >= 0, rows - proc * Kl * n, -1), proc, me,
                    W, S)
        # every relay lane, also one with no slot in this block: each
        # process runs (and counts) the lanes of the JAX executor
        relay = []
        for dst, src in lanes:
            if (proc_of[dst // S] != proc_of[src // S]).any():
                raise ValueError(
                    "the process lane needs each host block of the "
                    "two-level topology inside one process's block of "
                    f"workers (hosts {plan.topology.hosts}, {W} "
                    "processes)")
            m = proc_of[dst // S] == me
            relay.append((idx(dst[m] - lo * S), idx(src[m] - lo * S)))
        stages[stage] = dict(on(x), n=n, relay=relay,
                             round_ops=_round_ops(T, router, K, q))
        if plan.topology is not None:
            stages[stage]["relay_rows"] = int(prog.host_tables(stage).Rb)
        # the looped exchange, per (group, round): the permutation's
        # deliveries split by process, as stage 3's below
        loop = np.full((n, k - 1, K), -1, np.int64)
        for gi, rounds in enumerate(prog.round_perms(stage)):
            for r, pairs in enumerate(rounds):
                for a, b in pairs:
                    loop[gi, r, b] = a
        stages[stage]["loop"] = [[on(_perm_blocks(src, Kl, W, me))
                                  for src in rounds] for rounds in loop]
    # stage 3, per offset: receiver b takes sender a's fold of shard b,
    # row a-lo of the sender's block payload
    s3 = []
    for perms in prog.s3_perms:
        src = np.full(K, -1, np.int64)
        for a, b in perms:
            src[b] = a
        s3.append(on(_perm_blocks(src, Kl, W, me)))
    # assembly: the stacked executor's rows of this block's workers,
    # renumbered from the block's first
    J, J_own = plan.J, plan.J_own
    own = glob["own_rows"] // J
    own = (own >= lo) & (own < lo + Kl)
    non = glob["non_rows"] // J
    non = (non >= lo) & (non < lo + Kl)
    tabs = plan._tables[key] = dict(
        stages=stages, s3=s3,
        own_rows=glob["own_rows"][own] - lo * J,
        own_sum_rows=glob["own_sum_rows"][own] - lo * J_own,
        non_rows=glob["non_rows"][non] - lo * J,
        non_s2_rows=glob["non_s2_rows"][non] - lo * prog.n_s2,
        non_s3_rows=glob["non_s3_rows"][non] - lo * (q - 1) * J_own)
    return tabs


def _all_to_all(send: torch.Tensor, send_counts, recv_counts, active):
    """One ``all_to_all_single`` of whole rows over the default group:
    ``send`` holds the rows for each other process in rank order
    (``send_counts``), the result the rows from each (``recv_counts``),
    on ``send``'s device. The group is gloo, so rows on a card are
    staged through pinned host buffers here, explicitly: ``staging_ms``
    is the device-to-host and host-to-device copy, ``gloo_ms`` the
    collective. No collective runs when no process sends anything
    (``active`` False: every process knows it from the same tables)."""
    rec = dict(bytes=0, rows=int(sum(send_counts)), staging_ms=0.0,
               gloo_ms=0.0, exchanges=int(active))
    if not active:
        return send[:0], rec
    shape = send.shape[1:]
    dev = send.device
    rows = send.reshape(len(send), math.prod(shape)).view(torch.uint8)
    pin = dev.type == "cuda"
    t0 = time.perf_counter()
    host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=pin)
    host.copy_(rows)
    got = torch.empty((sum(recv_counts), rows.shape[1]), dtype=torch.uint8,
                      pin_memory=pin)
    t1 = time.perf_counter()
    torch.distributed.all_to_all_single(
        got, host, output_split_sizes=list(recv_counts),
        input_split_sizes=list(send_counts))
    t2 = time.perf_counter()
    got = got.to(dev)
    t3 = time.perf_counter()
    rec.update(bytes=host.numel(), staging_ms=(t1 - t0 + t3 - t2) * 1e3,
               gloo_ms=(t2 - t1) * 1e3)
    return got.view(send.dtype).view(-1, *shape), rec


def _deliver(pay: torch.Tensor, x: dict, recs: list,
             slots: int | None = None) -> torch.Tensor:
    """One exchange of the block's rows ``pay`` by a :func:`_blocks`
    split ``x`` into ``slots`` receive slots (default: one a row of
    ``pay``, a device-axis permutation): each slot gets its row from
    this process's ``pay`` or over ``torch.distributed``, zeros where it
    has none; the exchange's record goes to ``recs``."""
    got = pay.new_zeros((len(pay) if slots is None else slots,)
                        + pay.shape[1:])
    got.index_copy_(0, x["local_slots"], pay.index_select(0, x["local_rows"]))
    moved, rec = _all_to_all(pay.index_select(0, x["send_rows"]),
                             x["send_counts"], x["recv_counts"], x["active"])
    got.index_copy_(0, x["recv_slots"], moved.index_select(0, x["recv_index"]))
    recs.append(rec)
    return got


def _sum_recs(recs: list) -> dict:
    return {key: sum(r[key] for r in recs) for key in recs[0]}


def _exchange_process(delta, x, calls, *, k, pk):
    """The batched (phase A of the two-level) exchange of the block:
    ``recv [K_local, n*(k-1), pk]`` filled from the block's own Δ rows
    and those of the other processes (one ``all_to_all_single``), then
    phase B's relay lanes, inside the process. Returns ``(recv,
    record)``."""
    _note_rounds(x, k=k, pk=pk)
    Kl, S = delta.shape[0], x["n"] * (k - 1)
    recs = []
    recv = _deliver(delta.reshape(-1, pk), x, recs, slots=Kl * S)
    return _relay(recv.view(Kl, S, pk), x, calls, pk=pk), recs[0]


def _exchange_looped_process(delta, st, x, calls, *, k, pk):
    """The looped exchange of the block: :func:`_exchange_looped` with
    each (group, round) permutation run by :func:`_deliver`, one
    ``all_to_all_single`` for each permutation that has a pair across
    processes. Returns ``(recv, record)``."""
    Kl, n = delta.shape[0], st["n"]
    recv = torch.zeros((Kl, n, k - 1, pk), dtype=delta.dtype,
                       device=delta.device)
    recs = []
    for gi in range(n):
        valid = st["valid"][:, gi, None]
        payload = torch.where(valid, delta[:, gi], 0)
        for r in range(k - 1):
            got = _deliver(payload, x["loop"][gi][r], recs)
            calls["stage12"] += 1
            note("collective-permute", pk * got.element_size())
            recv[:, gi, r] = torch.where(valid, got, recv[:, gi, r])
    return recv.view(Kl, n * (k - 1), pk), _sum_recs(recs)


def degraded_block_rows(a_idx, g_idx, g_mask, mesh, J: int, device):
    """The process lane of the degraded executor
    (``runtime.fault.build_degraded_executor(mesh=)``): the dense plan's
    rows of this process's block of outputs, their indices renumbered
    into a buffer of the flat rows they read, and ``gather(flat_local)
    -> buffer``, which takes this process's own rows and receives the
    others' in one ``all_to_all_single`` (sending each other process the
    rows of its block's needs that this one holds). Every process works
    out every block's needs from the same plan. Padding indices point at
    row 0 of the buffer (their selects keep the accumulator)."""
    W, me, Kl = mesh.world, mesh.rank, mesh.K_local
    per = J * Kl                         # flat rows a process holds
    rows = a_idx.shape[0] // W           # output rows of a block

    def needs(p):
        r = slice(p * rows, (p + 1) * rows)
        return np.unique(np.concatenate([a_idx[r], g_idx[r][g_mask[r]]]))

    need = [needs(p) for p in range(W)]
    mine, others = need[me], [p for p in range(W) if p != me]
    owner = mine // per
    order = np.concatenate([mine[owner == me]]
                           + [mine[owner == p] for p in others])
    pos = np.zeros(J * mesh.K, np.int64)
    pos[order] = np.arange(len(order))
    sl = slice(me * rows, (me + 1) * rows)
    g_m = g_mask[sl]
    idx = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
    local = idx(mine[owner == me] - me * per)
    send = [need[p][need[p] // per == me] - me * per for p in others]
    send_idx = idx(np.concatenate(send or [np.zeros(0, np.int64)]))
    send_counts = [0] * W
    for p, x in zip(others, send):
        send_counts[p] = len(x)
    recv_counts = [int((owner == p).sum()) if p != me else 0
                   for p in range(W)]
    active = any((need[p] // per != p).any() for p in range(W))

    def gather(flat: torch.Tensor) -> torch.Tensor:
        got, _ = _all_to_all(flat.index_select(0, send_idx), send_counts,
                             recv_counts, active)
        return torch.cat([flat.index_select(0, local), got])

    return (pos[a_idx[sl]], np.where(g_m, pos[g_idx[sl]], 0), g_m, gather)


def _shuffle_process(plan: CAMRPlan, contribs: torch.Tensor, mesh, *,
                     mode, router, codec, debug, verify_wire, corrupt):
    """:func:`camr_shuffle`'s process lane: the stacked executor's body
    (encode, exchange, relay, decode, stage 3, the fold) for this
    process's block of workers only, every table sliced to the block, so
    the codec kernels launch over ``K_local`` workers. Only rows whose
    sender and receiver lie in different processes cross: in the batched
    mode one ``all_to_all_single`` a coded stage (one row per delivery
    of the lowered send tables: ``camr_edge_bytes``' inter-host bytes
    when the hosts are the processes; a two-level plan's phase B stays
    inside the process), in the looped mode one for each (group, round)
    permutation with a pair across processes, and one a stage-3 offset
    where a class straddles two blocks. The verified wire moves its rows
    of ``pk+1`` words the same way; a fault spec is XORed in by the
    process that holds its device, and ``bad`` comes back as
    ``int32[K_local]``. Every mode, codec and option of the stacked
    executor runs, with its bits, its permutation counts and its ledger.
    Records, in ``plan.process_stats``, each stage's bytes and rows sent,
    its ``all_to_all_single`` calls (``exchanges``) and its encode /
    exchange / decode ms (the exchange's host staging and gloo time
    apart), stage 3's with the assembly's as ``ms``. The ms are the
    device ms of the lane's spans (as :func:`camr_shuffle` names them):
    set before the call returns, or, inside a caller's open
    :class:`~repro_torch.core.spans.Recorder`, once that is read."""
    k, K, J, J_own, d = plan.k, plan.K, plan.J, plan.J_own, plan.d
    if mesh.K != K:
        raise ValueError(f"mesh of {mesh.K} workers for a plan of {K}")
    Kl, lo, hi = mesh.K_local, mesh.lo, mesh.hi
    if tuple(contribs.shape) != (Kl, J_own, k - 1, K, d):
        raise ValueError(f"contribs shape {tuple(contribs.shape)} != "
                         f"{(Kl, J_own, k - 1, K, d)} (this process's "
                         f"workers {lo}..{hi - 1})")
    dtype, dev = contribs.dtype, contribs.device
    contribs = contribs.contiguous()
    glob = _device_tables(plan, dev, router, codec, "batched")
    px = _process_tables(plan, mesh, router, glob, dev)
    wp = payload_words(d, contribs.element_size(), k)
    pk = wp // (k - 1)
    pkv = pk + 1 if verify_wire else pk
    spec = _corrupt_spec(corrupt, K, lambda s: glob["stages"][s]["n"], pkv)
    if verify_wire:
        bad = torch.zeros(Kl, dtype=torch.int32, device=dev)
    # timed by spans: into the caller's recorder (read at its end), else
    # into one of this call's own, read before it returns
    own = Recorder(dev) if current() is None else None
    stats, stage_vals, timed = {}, {}, {}
    with own or contextlib.nullcontext():
        with span("shuffle.wire"):
            wire = _wire_buffer(contribs, wp,
                                "multipass" if verify_wire else codec)
            if verify_wire:
                wire = _widen(wire, k, pk)
        for stage in (1, 2):
            st = _local_stage(glob["stages"][stage], lo, hi, k)
            x = px["stages"][stage]
            with span("shuffle.encode") as enc:
                ctx, delta = _encode_stage(wire, st, K=Kl, k=k, pk=pkv,
                                           codec=codec)
                _tamper(delta, spec.get(stage), lo, hi)
            with span("shuffle.exchange") as exc:
                if mode == "looped":
                    recv, stats[f"stage{stage}"] = _exchange_looped_process(
                        delta, st, x, plan.permutations, k=k, pk=pkv)
                else:
                    recv, stats[f"stage{stage}"] = _exchange_process(
                        delta, x, plan.permutations, k=k, pk=pkv)
            del delta
            with span("shuffle.decode") as dcd:
                if codec == "multipass":
                    ctx = _cancellations(ctx, st, K=Kl, k=k)
                dec = _decode_stage(recv, ctx, st, K=Kl, k=k, pk=pkv,
                                    codec=codec)
                if verify_wire:
                    dec = _verify_rows(dec, st, bad, k=k, pk=pk, wp=wp)
            stage_vals[stage] = _from_wire(dec, dtype, d)
            timed[f"stage{stage}"] = dict(encode_ms=(enc,), exchange_ms=(exc,),
                                          decode_ms=(dcd,))
        del wire
        vals = contribs.view(_arith_dtype(dtype))
        s3_recs = []
        ar = torch.arange(Kl, device=dev)
        with span("shuffle.stage3") as s3:
            s3_out = _stage3(vals, ar, [t[lo:hi] for t in glob["s3_dst"]],
                             lambda o, pay: _deliver(pay, px["s3"][o],
                                                     s3_recs),
                             plan.permutations)
        if debug:
            info = _debug_info(stage_vals, s3_out, vals, ar, glob, lo, hi,
                               dtype)
        with span("shuffle.assemble") as asm:
            out = _assemble(stage_vals, s3_out, vals, ar, ar + lo, px, J=J,
                            d=d)
    # stage 3 and the assembly
    stats["stage3"] = _sum_recs(s3_recs)
    timed["stage3"] = dict(ms=(s3, asm))

    def fill():                 # each record's ms, once the calls are read
        for name, keys in timed.items():
            stats[name].update({key: sum(c.device_ms for c in calls)
                                for key, calls in keys.items()})

    (own or current()).after_read(fill)
    if own:
        own.read()
    plan.process_stats.clear()
    plan.process_stats.update(stats)
    out = out.view(dtype)
    if debug:
        return dict(out=out, **info)
    if verify_wire:
        return out, bad
    return out


def expected_collective_calls(plan: CAMRPlan, mode: str = "batched",
                              router: str = "all_to_all") -> dict[str, int]:
    """Collectives per shuffle of the JAX executor: the batched rounds
    (one ``all_to_all``, or ``q`` ppermutes, per round of each coded
    stage) or the looped per-group permutations, plus the ``q-1``
    stage-3 unicasts; on a two-level topology, one intra-host relay
    ppermute more per live (round, shift) lane of each coded stage. The
    port's looped lane, its relay lanes and stage 3 run exactly these
    permutations (:attr:`CAMRPlan.permutations`); its batched rounds are
    one routed row gather each stage."""
    q, k = plan.q, plan.k
    if mode == "batched":
        s12 = 2 * (k - 1) if router == "all_to_all" else 2 * (k - 1) * q
        if plan.topology is not None:
            s12 += sum(len(live) for X in (plan.program.hx1,
                                           plan.program.hx2)
                       for live in X.b_live)
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
    note("all-reduce", total.numel() * total.element_size())
    return total.transpose(0, 1).contiguous()


def _wire_itemsize(dtype, itemsize: int, where: str) -> int:
    """The payload item size that picks the wire lane: ``dtype``'s (a
    codec payload dtype) when given, else ``itemsize``."""
    if dtype is None:
        return itemsize
    name = _dtype_name(dtype)
    if name not in CODEC_DTYPES:
        raise TypeError(f"{where}: {name} is not a codec payload dtype "
                        f"({', '.join(CODEC_DTYPES)})")
    return 2 if name in PACKED_DTYPES else 4


def camr_collective_bytes(plan: CAMRPlan, itemsize: int = 4,
                          dtype=None) -> dict[str, int]:
    """On-wire bytes per device-step of the schedule (p2p model), for the
    comparison against a psum-based reduce-scatter (the JAX package's
    formula; ``dtype`` selects the wire lane by its item size)."""
    itemsize = _wire_itemsize(dtype, itemsize, "camr_collective_bytes")
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


def camr_edge_bytes(plan: CAMRPlan, itemsize: int = 4,
                    dtype=None) -> dict[str, int]:
    """Per-edge bytes of the flat and the two-level schedules, counted
    from the lowered send tables (the JAX package's function): every kept
    ``a2a_send`` entry is one packet delivery, classified by the host
    blocks of its sender and receiver under the plan's two-level
    topology; phase-B relay hops (``b_send``) are intra-host by
    construction. Stage-3 unicasts are intra-class and classes sit inside
    host blocks, so stage 3 never crosses a host under either schedule.
    Needs a plan lowered with a two-level topology; ``dtype`` (a torch
    dtype or its name) selects the wire lane by its item size."""
    prog = plan.program
    topo = prog.topology
    if topo is None:
        raise ValueError("camr_edge_bytes needs a plan lowered with a "
                         "two-level topology (make_plan(..., topology="
                         "Topology.two_level(hosts)))")
    itemsize = _wire_itemsize(dtype, itemsize, "camr_edge_bytes")
    k, q, K, d, J_own = plan.k, plan.q, plan.K, plan.d, plan.J_own
    pk_b = (payload_words(d, itemsize, k) // (k - 1)) * 4
    host = np.arange(K) // topo.devices_per_host(K)
    cross = host[:, None] != host[None, :]                  # [K, K]
    flat = dict(inter=0, intra=0)
    two = dict(inter=0, intra=0)
    for stage in (1, 2):
        T = prog.stage_tables(stage)
        X = prog.host_tables(stage)
        for tab, acc in ((T.a2a_send, flat), (X.a2a_send, two)):
            kept = (tab >= 0).sum(axis=3).sum(axis=0)       # [K, K]
            acc["inter"] += int(kept[cross].sum())
            acc["intra"] += int(kept[~cross].sum())
        two["intra"] += int((X.b_send >= 0).sum())          # relay hops
    s3_b = (q - 1) * J_own * d * itemsize * K               # intra-host
    return dict(
        hosts=topo.hosts, packet_bytes=pk_b,
        flat_inter_bytes=flat["inter"] * pk_b,
        flat_intra_bytes=flat["intra"] * pk_b + s3_b,
        two_level_inter_bytes=two["inter"] * pk_b,
        two_level_intra_bytes=two["intra"] * pk_b + s3_b,
        s3_inter_bytes=0)


# --------------------------------------------------------------------- #
# multi-wave streaming, the degraded lane, topology re-homing and the
# self-verifying wire (the training grad-sync path)
# --------------------------------------------------------------------- #
class ShuffleStream:
    """Multi-wave, double-buffered runner of :func:`camr_shuffle`, with a
    degraded lane for a failed-worker set, two-level topologies that a
    host loss re-homes, and the self-verifying wire.

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
      the process-wide :data:`~repro_torch.core.schedule.EXEC_CACHE`,
      keyed per topology; zero builds after :meth:`warm_degraded_execs`),
      or to the fault runtime's host interpreter ``degraded_shuffle_host``
      (``degraded_lane="host"``, the oracle the device lane is held to;
      it runs only when asked for). Both fold in the engine's canonical
      order, so their output is bitwise the healthy shuffle of the same
      contributions. :meth:`restore` returns to the healthy executors,
      which stay built. A degraded wave has no coded wire and is not
      verified.
    * **topology** — ``topology`` (two-level, or an ``AutoTopology``
      marker) runs the relay exchange; :meth:`set_topology` re-homes
      later dispatches (after ``HostMembership.kill_host``, pass its
      ``current_topology()``), :meth:`set_gateway_avoid` moves phase-A
      gateways off straggling devices, and :meth:`warm_host_survivors`
      lowers every surviving-host topology ahead, so a re-homing is a
      cache hit. Outputs are bitwise the same under every topology.
    * **self-verifying wire** — ``verify_wire=True`` runs each healthy
      wave with packet checksums; a wave with a mismatching row is run
      again, bitwise, through the clean executor, up to ``max_replays``
      times, then ``WireCorruptionError`` is raised. :meth:`sync`
      verifies before it returns, a streamed wave when it is collected.
      :meth:`inject_corruption` arms a one-shot fault on the next
      dispatch.

    * **process lane** — ``mesh`` (a
      :class:`~repro_torch.launch.mesh.CAMRMesh`) runs every dispatch
      through ``camr_shuffle(mesh=)``: each process submits and gets
      back its block's rows, ``[K_local, J_own, k-1, K, d] -> [K_local,
      J, d]``, every process makes the same calls in the same order
      (``inject_corruption`` with the same arguments: the process that
      holds the device XORs the fault in), a verified wave's mismatch
      count is summed over the processes before the replay decision,
      and the degraded lane exchanges the rows each block's survivors
      need before its fold (``build_degraded_executor(mesh=)``; the
      ``"host"`` lane needs every row and is refused). Outputs and
      :meth:`stats` are bitwise the single-process stream's rows. The
      group is gloo, whose calls block the host thread: a dispatch
      returns only after its exchanges, so ``depth`` overlaps the host
      work of the next wave with the card's work of this one only past
      the last exchange of the shuffle.

    ``compiles`` counts healthy executor builds (one plan and one set of
    device tables per stacked width, topology and gateway set; a fault
    spec is an argument of the executor, not a build of its own),
    ``degraded_compiles`` degraded executor builds, ``dispatches`` the
    shuffles run (replays included), ``swaps`` the degrade/restore
    events, ``host_swaps`` the topology changes, ``wire_faults`` the
    waves a checksum flagged and ``wire_replays`` the replays.
    """

    def __init__(self, q: int, k: int, d: int, *, device=None,
                 depth: int = 2, wave_batch: int = 1,
                 mode: str = "batched", router: str = "all_to_all",
                 codec: str = "fused", degraded_lane: str = "device",
                 topology=None, gateway_avoid=frozenset(),
                 verify_wire: bool = False, max_replays: int = 2,
                 mesh=None):
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
        self.q, self.k, self.d = q, k, d
        self.K = q * k
        self.mesh = mesh
        if mesh is not None:
            if mesh.K != self.K:
                raise ValueError(f"mesh of {mesh.K} workers for a stream "
                                 f"of {self.K}")
            if degraded_lane == "host":
                raise ValueError("degraded_lane='host' interprets every "
                                 "worker's rows on one host; the process "
                                 "lane holds a block of them")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.mode, self.router, self.codec = mode, router, codec
        self.topology = self._checked_topology(topology)
        self._gateway_avoid = self._checked_avoid(gateway_avoid)
        self.verify_wire = bool(verify_wire)
        if self.verify_wire and (codec != "fused" or mode != "batched"):
            raise ValueError("verify_wire requires codec='fused' and "
                             "mode='batched'")
        if max_replays < 0:
            raise ValueError("max_replays must be >= 0")
        self.max_replays = max_replays
        self.device = resolve_device(device)
        self.depth, self.wave_batch = depth, wave_batch
        self.degraded_lane = degraded_lane
        self._plans: dict = {}                 # executor key -> plan
        self._pending: list = []               # waves awaiting dispatch
        self._in_flight: deque = deque()       # (out, W, t0, event, buf)
        self._done: list = []                  # host [K, J, d] outputs
        self._failed: frozenset = frozenset()  # current survivor-set gap
        self._corrupt = None                   # one-shot fault spec
        self.dispatches = 0
        self.compiles = 0
        self.degraded_compiles = 0
        self.swaps = 0
        self.host_swaps = 0
        self.wire_faults = 0
        self.wire_replays = 0
        self.wave_times: list[float] = []      # dispatch -> collect, s

    # -- healthy executor per (width, topology, gateways) --------------- #
    def _gw(self) -> frozenset:
        """Gateway preference in effect — flat has no gateways."""
        return (self._gateway_avoid if self.topology is not None
                else frozenset())

    def _executor(self, W: int = 1) -> CAMRPlan:
        key = (W, None if self.topology is None else self.topology.key(),
               tuple(sorted(self._gw())))
        plan = self._plans.get(key)
        if plan is None:
            plan = make_plan(self.q, self.k, W * self.d, self.topology,
                             gateway_avoid=self._gw())
            _device_tables(plan, self.device, self.router, self.codec,
                           self.mode)
            self._plans[key] = plan
            self.compiles += 1
        return plan

    def _shuffle(self, buf: torch.Tensor, W: int, corrupt=None):
        """The healthy executor: ``out``, or ``(out, bad)`` on a verified
        stream."""
        return camr_shuffle(self._executor(W), buf, mode=self.mode,
                            router=self.router, codec=self.codec,
                            verify_wire=self.verify_wire, corrupt=corrupt,
                            mesh=self.mesh)

    def _program(self, W: int = 1):
        return SCHEDULE_CACHE.program(self.q, self.k, Q=self.K,
                                      d=W * self.d, topology=self.topology,
                                      gateway_avoid=self._gw())

    # -- fault domains and gateway failover ----------------------------- #
    def _checked_topology(self, topology):
        t = resolve_topology(topology, self.q, self.k)
        if t is not None:
            t.check(self.q, self.k)
            if self.mode != "batched":
                raise ValueError("two-level topology requires "
                                 "mode='batched'")
        return t

    def _checked_avoid(self, avoid) -> frozenset:
        fs = frozenset(int(x) for x in (avoid or ()))
        if any(not 0 <= x < self.K for x in fs):
            raise ValueError(f"gateway_avoid {sorted(fs)} has devices "
                             f"outside [0, {self.K})")
        return fs

    @property
    def gateway_avoid(self) -> frozenset:
        return self._gw()

    def set_topology(self, topology) -> None:
        """Re-home later dispatches onto ``topology`` (after
        ``HostMembership.kill_host``, its ``current_topology()``). A
        re-keying only: executors of other topologies stay built, so a
        rejoin swaps back without a build, and the schedule comes from
        the warm cache (no cold lowering after
        :meth:`warm_host_survivors`). Waves in flight complete as they
        were dispatched; outputs are bitwise the same either way."""
        t = self._checked_topology(topology)
        if t != self.topology:
            self.topology = t
            self.host_swaps += 1

    def set_gateway_avoid(self, avoid) -> None:
        """Prefer phase-A gateways OUTSIDE ``avoid`` for later dispatches
        (straggler failover: feed it ``Membership.gateway_avoid()``).
        Joins the executor and schedule-cache keys; outputs are bitwise
        the same for every assignment."""
        self._gateway_avoid = self._checked_avoid(avoid)

    def warm_host_survivors(self, *, max_host_failures: int = 1) -> int:
        """Lower ahead the surviving-host topology of every loss of up to
        ``max_host_failures`` hosts (``ScheduleCache.warm_host_survivors``),
        so a later :meth:`set_topology` on the kill path is a cache hit.
        Returns the survivor topologies warmed."""
        if self.topology is None:
            raise ValueError("warm_host_survivors needs a two-level "
                             "stream (flat has no hosts to lose)")
        return SCHEDULE_CACHE.warm_host_survivors(
            self._program(), max_host_failures=max_host_failures)

    # -- the self-verifying wire ---------------------------------------- #
    def inject_corruption(self, *, stage: int = 1, device: int = 0,
                          row=None, word: int = 0, bits: int = 1) -> None:
        """Arm a ONE-SHOT wire fault: the next healthy dispatch XORs the
        u32 pattern ``bits`` into word ``word`` of row ``row`` of
        ``device``'s Δ in coded stage ``stage`` (the chaos layer's
        ``CorruptPacket``). The checksum catches it and the wave is
        replayed bitwise through the clean executor. ``row=None`` picks
        the device's first group row in that stage, so the tampered
        packet is really sent."""
        if not self.verify_wire:
            raise ValueError("inject_corruption needs verify_wire=True "
                             "— corrupting an unverified wire would "
                             "silently mis-reduce")
        prog = self._program()
        _check_corrupt(int(stage), int(device),
                       None if row is None else int(row), int(bits), self.K,
                       lambda s: prog.stage_tables(s).n)
        if row is None:
            valid = np.asarray(prog.stage_tables(stage).valid)[device]
            rows = np.flatnonzero(valid)
            if not len(rows):
                raise ValueError(f"device {device} participates in no "
                                 f"stage-{stage} group")
            row = int(rows[0])
        self._corrupt = (int(stage), int(device), int(row), int(word),
                         int(bits))

    def _take_corrupt(self):
        spec, self._corrupt = self._corrupt, None
        return spec

    def _verified(self, res, bad, buf, W: int) -> torch.Tensor:
        """Read the per-device mismatch counts (a host sync; on the
        process lane summed over the processes, so that every process
        takes the same decision); on a fault, run the SAME wave again
        through the clean executor, up to ``max_replays`` times, then
        raise ``WireCorruptionError``. A clean pass decodes exactly the
        unverified lane's payload words, so a replay is bitwise."""
        total = self._mesh_total(bad)
        if total:
            self.wire_faults += 1
        replays = 0
        while total:
            if replays >= self.max_replays:
                from ..runtime.fault import WireCorruptionError
                raise WireCorruptionError(
                    f"wave failed wire verification after {replays} "
                    f"bitwise replays ({total} corrupted packet rows "
                    "persist) — persistent corruption, not a transient "
                    "fault; quarantine the link")
            replays += 1
            self.wire_replays += 1
            self.dispatches += 1
            res, bad = self._shuffle(buf, W)
            total = self._mesh_total(bad)
        return res

    def _mesh_total(self, bad: torch.Tensor) -> int:
        """The mismatching rows of a wave over every worker."""
        total = int(bad.sum())
        if self.mesh is not None and self.mesh.world > 1:
            t = torch.tensor([total], dtype=torch.int64)
            torch.distributed.all_reduce(t)
            total = int(t)
        return total

    # -- live elasticity ------------------------------------------------ #
    @property
    def failed(self) -> frozenset:
        return self._failed

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
        """The degraded executor for stack width ``W``, value ``dtype``,
        the survivor set and the topology, from the process-wide
        EXEC_CACHE: a later stream of the same shape, or a
        :meth:`warm_degraded_execs` before any failure, makes a
        mid-stream degrade build-free."""
        from ..runtime.fault import build_degraded_executor
        failed = self._failed if failed is None else failed
        topo = None if self.topology is None else self.topology.key()
        block = (None if self.mesh is None
                 else (self.mesh.world, self.mesh.rank))
        key = ("spmd_degraded", self.q, self.k, self.K, W * self.d,
               _dtype_name(dtype), tuple(sorted(failed)), topo,
               str(self.device), block)

        def build():
            self.degraded_compiles += 1
            return build_degraded_executor(self._program(W), failed,
                                           W * self.d, dtype, self.device,
                                           mesh=self.mesh)

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
        shape = (self.K if self.mesh is None else self.mesh.K_local,
                 self.q ** (self.k - 2), self.k - 1, self.K, self.d)
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
        ``[K, J, d]`` output on the stream's device (no host copy). A
        verified stream checks the wave, and replays it on a fault,
        before it returns. Independent of the submit/drain window."""
        self._check_wave(contribs)
        self.dispatches += 1
        if self._failed:
            return self._degraded_exec(contribs, 1)
        if self.verify_wire:
            res, bad = self._shuffle(contribs, 1, self._take_corrupt())
            return self._verified(res, bad, contribs, 1)
        return self._shuffle(contribs, 1)

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
        keep = None
        if self._failed:
            # the survivor-set executor: no coded wire, nothing to check
            out = self._degraded_exec(buf, W)
        elif self.verify_wire:
            out = self._shuffle(buf, W, self._take_corrupt())
            keep = buf                  # kept for a bitwise replay
        else:
            out = self._shuffle(buf, W)
        del buf
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.dispatches += 1
        self._in_flight.append((out, W, t0, event, keep))
        while len(self._in_flight) > self.depth:
            self._collect_oldest()

    def _collect_oldest(self) -> None:
        out, W, t0, event, buf = self._in_flight.popleft()
        if event is not None:
            event.synchronize()
        if buf is not None:                               # verified wave
            out = self._verified(*out, buf, W)
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
        degrade/restore ``swaps`` and topology ``host_swaps`` too) and the
        wire's fault counters."""
        return dict(dispatches=self.dispatches, compiles=self.compiles,
                    widths=sorted({key[0] for key in self._plans}),
                    swaps=self.swaps, failed=tuple(sorted(self._failed)),
                    degraded_compiles=self.degraded_compiles,
                    degraded_lane=self.degraded_lane, mode=self.mode,
                    router=self.router, codec=self.codec,
                    device=str(self.device),
                    topology=(None if self.topology is None
                              else self.topology.key()),
                    gateway_avoid=tuple(sorted(self._gw())),
                    host_swaps=self.host_swaps,
                    verify_wire=self.verify_wire,
                    wire_faults=self.wire_faults,
                    wire_replays=self.wire_replays)
