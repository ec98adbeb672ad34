"""CAMR 3-stage coded shuffle — paper §III-C, Lemma 2, Algorithm 2.

This module implements the *schedule* and the *coding* exactly as in the
paper, with byte-exact accounting. Payloads are raw ``bytes`` (the engine
bitcasts numpy arrays); XOR coding operates on byte strings, so it is
exactly invertible for any dtype.

Two cost models are tracked per transmission (DESIGN.md §3):

* ``bus``  — the paper's shared-medium model: a multicast costs its payload
  size once, regardless of receiver count. Stage loads under this model
  reproduce §IV exactly.
* ``p2p``  — point-to-point links (TPU ICI / commodity switches): a
  multicast to ``r`` receivers costs ``r * payload``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .designs import ResolvableDesign
from .placement import Placement

__all__ = [
    "Transmission",
    "ShuffleTrace",
    "xor_bytes",
    "split_packets",
    "coded_multicast_schedule",
    "decode_coded_multicast",
    "Stage1Chunk",
    "Stage2Chunk",
    "Stage3Chunk",
    "stage1_chunks",
    "stage2_chunks",
    "stage3_chunks",
]


# --------------------------------------------------------------------- #
# byte-level coding primitives
# --------------------------------------------------------------------- #
def xor_bytes(*parts: bytes) -> bytes:
    """XOR of equal-length byte strings."""
    if not parts:
        raise ValueError("need at least one part")
    n = len(parts[0])
    acc = bytearray(parts[0])
    for p in parts[1:]:
        if len(p) != n:
            raise ValueError("length mismatch in xor_bytes")
        for i, b in enumerate(p):
            acc[i] ^= b
    return bytes(acc)


def split_packets(chunk: bytes, m: int) -> list[bytes]:
    """Split ``chunk`` into ``m`` equal packets, zero-padding to a multiple.

    The paper assumes divisibility; padding overhead is accounted by the
    caller (it is the actual on-wire size).
    """
    if m < 1:
        raise ValueError("m must be >= 1")
    plen = -(-len(chunk) // m)  # ceil
    padded = chunk + b"\x00" * (plen * m - len(chunk))
    return [padded[i * plen:(i + 1) * plen] for i in range(m)]


@dataclass(frozen=True)
class Transmission:
    """One on-wire message."""

    stage: int
    sender: int
    receivers: tuple[int, ...]
    payload: bytes = field(repr=False)
    # bookkeeping label for debugging/tests, e.g. ("group", G) or ("job", j)
    tag: tuple = ()

    @property
    def nbytes(self) -> int:
        return len(self.payload)

    @property
    def p2p_bytes(self) -> int:
        return len(self.payload) * len(self.receivers)


@dataclass
class ShuffleTrace:
    """Accumulates transmissions and exposes load accounting."""

    transmissions: list[Transmission] = field(default_factory=list)

    def add(self, t: Transmission) -> None:
        self.transmissions.append(t)

    def bytes_for_stage(self, stage: int, model: str = "bus") -> int:
        sel = (t for t in self.transmissions if t.stage == stage)
        if model == "bus":
            return sum(t.nbytes for t in sel)
        if model == "p2p":
            return sum(t.p2p_bytes for t in sel)
        raise ValueError(f"unknown cost model {model!r}")

    def total_bytes(self, model: str = "bus") -> int:
        return sum(self.bytes_for_stage(s, model) for s in (1, 2, 3))

    def load(self, J: int, Q: int, B_bytes: int, stage: int | None = None,
             model: str = "bus") -> float:
        """Normalized communication load L = bytes / (J*Q*B) (Def. 3)."""
        num = (self.total_bytes(model) if stage is None
               else self.bytes_for_stage(stage, model))
        return num / (J * Q * B_bytes)


# --------------------------------------------------------------------- #
# Algorithm 2 — coded multicast within a group of k machines
# --------------------------------------------------------------------- #
def coded_multicast_schedule(
    group: tuple[int, ...],
    chunks: dict[int, bytes],
    *,
    stage: int,
    tag: tuple = (),
) -> list[Transmission]:
    """Build the k broadcasts of Algorithm 2 for one group.

    ``chunks[k']`` is the data chunk server ``k'`` is missing (and every
    other group member can compute). Packet ``i`` of chunk ``k'`` is
    associated with the i-th machine of ``sorted(group \\ {k'})``.
    Each machine ``m`` broadcasts the XOR of all packets associated with it.
    """
    k = len(group)
    if set(chunks) != set(group):
        raise ValueError("need exactly one chunk per group member")
    lens = {len(c) for c in chunks.values()}
    if len(lens) != 1:
        raise ValueError("all chunks in a group must have equal size")

    packets: dict[int, list[bytes]] = {
        kp: split_packets(chunks[kp], k - 1) for kp in group
    }
    out = []
    for m in group:
        mine = []
        for kp in group:
            if kp == m:
                continue
            others = sorted(s for s in group if s != kp)
            mine.append(packets[kp][others.index(m)])
        out.append(
            Transmission(
                stage=stage,
                sender=m,
                receivers=tuple(s for s in group if s != m),
                payload=xor_bytes(*mine),
                tag=tag,
            )
        )
    return out


def decode_coded_multicast(
    group: tuple[int, ...],
    receiver: int,
    broadcasts: list[Transmission],
    known_chunks: dict[int, bytes],
    chunk_len: int,
) -> bytes:
    """Receiver-side decode (Lemma 2 proof, Appendix).

    ``known_chunks`` must contain chunk ``k'`` for every ``k' != receiver``
    in the group — these are recomputable from the receiver's local map
    outputs (the Lemma-2 storage condition). Returns the recovered chunk.
    """
    k = len(group)
    plen = -(-chunk_len // (k - 1))
    my_others = sorted(s for s in group if s != receiver)
    recovered: dict[int, bytes] = {}
    for t in broadcasts:
        m = t.sender
        if m == receiver:
            continue
        acc = bytearray(t.payload)
        for kp in group:
            if kp in (m, receiver):
                continue
            others = sorted(s for s in group if s != kp)
            pkt = split_packets(known_chunks[kp], k - 1)[others.index(m)]
            for i, b in enumerate(pkt):
                acc[i] ^= b
        # what remains is packet of *receiver's* chunk at receiver-index of m
        recovered[my_others.index(m)] = bytes(acc[:plen])
    chunk = b"".join(recovered[i] for i in range(k - 1))
    return chunk[:chunk_len]


# --------------------------------------------------------------------- #
# stage chunk descriptors — WHICH aggregate flows where
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Stage1Chunk:
    """Stage 1: owners of job ``j`` exchange their missing batch aggregate.

    ``alpha^{(j)}_{[k']}`` = aggregate over batch labeled k' of values for
    reduce-function k' — needed by owner k', computable by all other owners.
    """

    job: int
    receiver: int        # k' (an owner of job)
    batch: int           # batch index carrying k' label

    @property
    def qfunc(self) -> int:
        return self.receiver


@dataclass(frozen=True)
class Stage2Chunk:
    """Stage 2: group member ``k'`` receives, for the job co-owned by the
    rest of the group, the aggregate over the batch its class-mate owner
    misses (Eq. 4)."""

    job: int
    receiver: int        # k' (NOT an owner of job)
    batch: int           # batch labeled by the class-mate owner U_l
    classmate_owner: int  # U_l

    @property
    def qfunc(self) -> int:
        return self.receiver


@dataclass(frozen=True)
class Stage3Chunk:
    """Stage 3: unicast of the complement aggregate (Eq. 5)."""

    job: int
    receiver: int        # U_m, non-owner
    sender: int          # U_k, the job's owner in m's parallel class
    batches: tuple[int, ...]  # the k-1 batches the sender stores


def stage1_chunks(pl: Placement) -> dict[tuple[int, ...], list[Stage1Chunk]]:
    """Group (= owner set) -> chunks, one per owner.

    A read-only view over the compiled :class:`ShuffleProgram` tables —
    the IR in :mod:`repro.core.schedule` is the single source of truth
    for WHICH aggregate flows where.
    """
    from .schedule import lower_program
    prog = lower_program(pl, device_tables=False)
    out: dict[tuple[int, ...], list[Stage1Chunk]] = {}
    for row in prog.s1_rows:
        G = prog.group_members(int(row))
        out[G] = [
            Stage1Chunk(job=j, receiver=kp, batch=t)
            for kp, j, t in prog.coded_chunks(int(row))
        ]
    return out


def stage2_chunks(pl: Placement) -> dict[tuple[int, ...], list[Stage2Chunk]]:
    """Stage-2 group -> chunks, one per member (paper §III-C.2).

    View over the :class:`ShuffleProgram` tables, like
    :func:`stage1_chunks`.
    """
    from .schedule import lower_program
    prog = lower_program(pl, device_tables=False)
    out: dict[tuple[int, ...], list[Stage2Chunk]] = {}
    for row in prog.s2_rows:
        row = int(row)
        G = prog.group_members(row)
        out[G] = [
            Stage2Chunk(job=j, receiver=kp, batch=t,
                        classmate_owner=int(prog.chunk_aux[row, p]))
            for p, (kp, j, t) in enumerate(prog.coded_chunks(row))
        ]
    return out


def stage3_chunks(pl: Placement) -> list[Stage3Chunk]:
    """All stage-3 unicasts: for each non-owner U_m of job j, the unique
    class-mate owner U_k sends the aggregate of its stored batches."""
    from .schedule import lower_program
    prog = lower_program(pl, device_tables=False)
    out = [
        Stage3Chunk(job=int(prog.s3_job[i]), receiver=int(prog.s3_recv[i]),
                    sender=int(prog.s3_send[i]),
                    batches=tuple(int(t) for t in prog.s3_batches[i]))
        for i in range(len(prog.s3_job))
    ]
    # each server misses J - q^{k-2} jobs, one unicast per missing job
    assert len(out) == pl.design.K * (pl.design.J - pl.design.block_size)
    return out
