"""ShuffleProgram — the compiled IR of the CAMR 3-stage coded shuffle.

One lowering of ``(Placement, Q, d)`` produces dense numpy tables that
every executor consumes (DESIGN.md §5):

* :class:`repro.core.engine.CAMREngine` — numpy interpreter (the oracle),
* :func:`repro.core.collective.camr_shuffle` — SPMD shard_map executor,
* :class:`repro.runtime.fault.DegradedCAMREngine` — re-lowered degraded
  schedule for a surviving server set.

The key structural fact the IR exploits: stage-1 groups (owner sets of a
job) and stage-2 groups both contain exactly one server per parallel
class, so a group IS a value vector ``v in Z_q^k`` (member of class ``i``
is server ``i*q + v_i``). The ``q**k`` value vectors split by parity:

* ``sum(v[:-1]) % q == v[-1]``  -> the vector is an SPC codeword, the
  group is the owner set of job ``rank(v[:-1])``  (stage 1),
* otherwise                     -> a stage-2 group of paper §III-C.2.

This unification is what lets stages 1 and 2 share one table builder and
one batched per-round exchange (the seed implementation duplicated ~200
lines between the engine and the collective, and issued one ppermute per
group per round).

Batched round routing
---------------------
In broadcast round ``r`` (of ``k-1``), the class-``i`` member of EVERY
group sends its coded packet Δ to the class-``(i+r) % k`` member.  A
device must therefore deliver to ``q`` distinct peers per round, so a
single ``lax.ppermute`` per round cannot carry the traffic (a ppermute
moves each device's payload to exactly ONE destination).  The program
precomputes two equivalent routings (DESIGN.md §4):

* ``all_to_all`` — one ``lax.all_to_all`` per round: device ``u`` sends,
  for each destination ``w``, the block of packets for the groups where
  ``u`` and ``w`` are round-``r`` partners.  Exactly ``k-1`` collectives
  per stage, independent of ``J``.
* ``ppermute`` — ``q`` sub-rounds per round: sub-round ``δ`` uses the
  global device permutation ``(i, l) -> ((i+r) % k, (l+δ) % q)`` and
  carries the groups whose round-``r`` value shift equals ``δ``.  Every
  byte on the wire is useful (no zero blocks), at ``q`` ppermutes per
  round.

Both routings share the block lists: for an ordered device pair
``(u, w)`` with classes ``i_u != i_w``, the groups where ``u`` sends to
``w`` in round ``r = (i_w - i_u) % k`` are the value vectors with
``v[i_u] = val(u)`` and ``v[i_w] = val(w)`` — exactly ``q**(k-3)`` of
them in stage 1 and ``q**(k-3) * (q-1)`` in stage 2, sorted by group
rank so sender and receiver agree on row order.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from functools import lru_cache

import numpy as np

from .designs import ResolvableDesign, make_design
from .placement import Placement, make_placement

__all__ = [
    "Topology",
    "AutoTopology",
    "resolve_topology",
    "surviving_topology",
    "HostTables",
    "StageTables",
    "ShuffleProgram",
    "lower_program",
    "DegradedProgram",
    "lower_degraded",
    "ScheduleCache",
    "SCHEDULE_CACHE",
    "ExecCache",
    "EXEC_CACHE",
    "payload_words",
    "pack_payload",
    "unpack_payload",
]


# --------------------------------------------------------------------- #
# interconnect topology (DESIGN.md §16)
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Topology:
    """Physical interconnect model the lowering targets.

    ``hosts``  number of hosts; devices are class-major blocks of
               ``dph = K / hosts`` consecutive device ids per host, so
               ``hosts | k`` aligns whole parallel classes to hosts
               (Konstantinidis & Ramamoorthy: resolvable parallel
               classes mapped onto physical groupings).
    ``alpha``  inter-host cost per byte relative to intra-host (>= 1
               in practice; ``alpha = 1`` collapses the cost model to
               the flat per-link one).

    ``hosts <= 1`` IS the flat topology — the identity case: lowering,
    cache keys and executors treat it exactly as ``topology=None``, so
    every existing flat schedule stays bitwise identical.
    """

    hosts: int = 1
    alpha: float = 1.0

    def __post_init__(self):
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if not self.alpha > 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")

    @classmethod
    def flat(cls) -> "Topology":
        return cls(hosts=1, alpha=1.0)

    @classmethod
    def two_level(cls, hosts: int, alpha: float = 4.0) -> "Topology":
        if hosts < 2:
            raise ValueError("two-level topology needs hosts >= 2 "
                             f"(got {hosts}); use Topology.flat()")
        return cls(hosts=hosts, alpha=float(alpha))

    @classmethod
    def auto(cls, hosts: int, alpha: float = 4.0) -> "AutoTopology":
        """Defer the flat-vs-two-level choice to plan time.

        Returns an :class:`AutoTopology` marker that every lowering
        entry point resolves against the configuration's ``(q, k)``
        via the closed-form cost model (DESIGN.md §16 follow-on):
        two-level wins exactly when its hierarchical cost
        ``camr_load_hierarchical`` strictly beats the FLAT schedule
        priced on the same hierarchy (which reduces to
        ``camr_load_p2p`` at ``alpha = 1`` — where the pick is flat).
        """
        return AutoTopology(hosts=hosts, alpha=float(alpha))

    @property
    def is_flat(self) -> bool:
        return self.hosts <= 1

    def check(self, q: int, k: int) -> None:
        """Validate against a CAMR configuration (K = q*k devices)."""
        if self.is_flat:
            return
        if k % self.hosts:
            raise ValueError(
                f"two-level lowering needs hosts | k so parallel "
                f"classes align to host blocks (hosts={self.hosts}, "
                f"k={k})")

    def devices_per_host(self, K: int) -> int:
        if K % self.hosts:
            raise ValueError(f"hosts={self.hosts} must divide K={K}")
        return K // self.hosts

    def host_of(self, s: int, K: int) -> int:
        """Host of device ``s`` under the class-major block layout."""
        return int(s) // self.devices_per_host(K)

    def key(self):
        """Hashable cache-key contribution; flat collapses to None so
        existing flat entries/keys are untouched."""
        if self.is_flat:
            return None
        return (self.hosts, float(self.alpha))


@dataclass(frozen=True)
class AutoTopology:
    """Plan-time marker: pick flat vs two-level from the cost model.

    Not a :class:`Topology` — it has no lowering of its own; every
    entry point that accepts a topology calls :func:`resolve_topology`
    first, which replaces this marker with either ``None`` (flat) or a
    concrete ``Topology.two_level(hosts, alpha)`` for the
    configuration's ``(q, k)``. The decision compares the two
    schedules priced on the SAME hierarchy (``intra + alpha * inter``
    per :func:`repro.core.loads.camr_edge_loads`): ties — including
    ``alpha = 1``, where both collapse to
    :func:`~repro.core.loads.camr_load_p2p`, and ``hosts = k``, where
    no packet has two same-host receivers to deduplicate — go to flat
    (the identity lowering, no overlay to build or relay to run).
    """

    hosts: int
    alpha: float = 4.0

    def resolve(self, q: int, k: int) -> "Topology | None":
        from .loads import camr_edge_loads, camr_load_hierarchical
        if self.hosts < 2 or k % self.hosts:
            return None                      # two-level can't lower
        intra_f, inter_f = camr_edge_loads(q, k, self.hosts,
                                           schedule="flat")
        flat_cost = intra_f + self.alpha * inter_f
        two_cost = camr_load_hierarchical(q, k, self.hosts, self.alpha)
        # strict win with a relative tolerance: at alpha = 1 (or
        # hosts = k) the two costs are EQUAL analytically and differ
        # only by fp association — a tie must resolve to flat
        if flat_cost - two_cost > 1e-9 * flat_cost:
            return Topology.two_level(self.hosts, alpha=self.alpha)
        return None


def resolve_topology(topology, q: int, k: int) -> "Topology | None":
    """Entry-point canonicalization: :class:`AutoTopology` markers
    resolve to their cost-model pick; concrete topologies normalize
    (flat collapses to None)."""
    if isinstance(topology, AutoTopology):
        return topology.resolve(q, k)
    return _normalize_topology(topology)


def surviving_topology(hosts_left: int, k: int,
                       alpha: float = 4.0) -> "Topology | None":
    """Topology to re-lower onto after whole-host loss (DESIGN.md
    §17): two-level over the remaining hosts when that still aligns
    parallel classes to host blocks (``hosts_left >= 2`` and
    ``hosts_left | k``), else flat (``None``) — the bitwise fallback.
    Schedule VALUES are topology-independent, so recovery output is
    bitwise-identical to the healthy lowering either way."""
    if hosts_left < 1:
        raise ValueError("need at least one surviving host, got "
                         f"{hosts_left}")
    if hosts_left >= 2 and k % hosts_left == 0:
        return Topology.two_level(hosts_left, alpha=alpha)
    return None


def _normalize_topology(topology) -> "Topology | None":
    """Canonical form for keys and lowering: flat collapses to None."""
    if topology is None or topology.is_flat:
        return None
    return topology


# --------------------------------------------------------------------- #
# packed payload widths (DESIGN.md §12)
# --------------------------------------------------------------------- #
def payload_words(d: int, itemsize: int, k: int) -> int:
    """u32 words per function shard for a ``d``-element payload of the
    given ``itemsize``, padded so the shard splits into ``k-1`` equal
    codec packets.

    The XOR codec moves 32-bit words; sub-word dtypes (bf16/f16) pack
    ``4 // itemsize`` values per word, so a 16-bit shard costs
    ``ceil(d/2)`` words — HALF the f32 bytes — plus at most ``k-2``
    deterministic zero pad words. For 4-byte dtypes this is exactly
    ``d`` (callers already guarantee ``(k-1) | d``), so every lane
    shares one width formula. The schedule tables are payload-width
    independent (packet units); a word-width program view is the same
    cheap width stamp the :class:`ScheduleCache` already shares.
    """
    if itemsize not in (2, 4):
        raise ValueError(f"payload itemsize must be 2 or 4 bytes, got "
                         f"{itemsize}")
    w = -(-d * itemsize // 4)
    return w + (-w) % (k - 1)


def pack_payload(x: np.ndarray, k: int) -> np.ndarray:
    """Pack a 16-bit payload ``[..., d]`` into u32 words ``[..., wp]``
    (``wp = payload_words(d, 2, k)``) — the numpy mirror of the SPMD
    packing, byte-identical to the device lane (little-endian: value
    ``2i`` is the low half of word ``i``; odd/trailing lanes pad with
    zero u16).
    """
    x = np.asarray(x)
    if x.dtype.itemsize != 2:
        raise TypeError(f"pack_payload packs 16-bit payloads, got "
                        f"{x.dtype}")
    d = x.shape[-1]
    wp = payload_words(d, 2, k)
    u16 = np.zeros(x.shape[:-1] + (2 * wp,), dtype=np.uint16)
    u16[..., :d] = x.view(np.uint16)
    return np.ascontiguousarray(u16).view(np.uint32)


def unpack_payload(w: np.ndarray, dtype, d: int) -> np.ndarray:
    """Inverse of :func:`pack_payload`: u32 words ``[..., wp]`` back to
    the 16-bit payload ``[..., d]`` (pad lanes dropped)."""
    w = np.asarray(w)
    if w.dtype != np.uint32:
        raise TypeError(f"unpack_payload expects uint32 words, got "
                        f"{w.dtype}")
    u16 = np.ascontiguousarray(w).view(np.uint16)
    return np.ascontiguousarray(u16[..., :d]).view(np.dtype(dtype))


# --------------------------------------------------------------------- #
# group <-> value-vector ranking
# --------------------------------------------------------------------- #
def _group_rank(v: tuple[int, ...], q: int) -> int:
    g = 0
    for x in v:
        g = g * q + int(x)
    return g


def _rank_to_vec(g: int, q: int, k: int) -> tuple[int, ...]:
    out = []
    for _ in range(k):
        out.append(g % q)
        g //= q
    return tuple(reversed(out))


# --------------------------------------------------------------------- #
# per-stage device tables
# --------------------------------------------------------------------- #
@dataclass(frozen=True, eq=False)
class StageTables:
    """Dense tables for one coded stage (1 or 2) of the shuffle.

    ``n`` = number of groups in the stage; all index tables are host
    numpy, gathered per-device with ``lax.axis_index`` inside shard_map.
    """

    stage: int
    rows: np.ndarray          # [n]            global group-row ids (rank order)
    R: np.ndarray | int = 0   # rows per (sender, receiver) routing block

    # membership / chunk sources (contribs coords: local job & batch slot)
    valid: np.ndarray = field(default=None, repr=False)      # [K, n] bool
    src_jslot: np.ndarray = field(default=None, repr=False)  # [K, n, k]
    src_bslot: np.ndarray = field(default=None, repr=False)  # [K, n, k]
    src_ok: np.ndarray = field(default=None, repr=False)     # [K, n, k] bool
    shard: np.ndarray = field(default=None, repr=False)      # [n, k] server id

    # Algorithm-2 positions (pos(x, G, kp) over sorted(G \ {kp}))
    delta_pos: np.ndarray = field(default=None, repr=False)  # [K, n, k]
    cancel_pos: np.ndarray = field(default=None, repr=False)  # [K, n, k-1, k]
    cancel_mask: np.ndarray = field(default=None, repr=False)  # [K, n, k-1, k]
    dec_gather: np.ndarray = field(default=None, repr=False)  # [K, n, k-1]

    # fused-codec flat index tables (DESIGN.md §10). Sources are flat
    # packet rows of the local chunk buffer viewed as
    # ``u32.reshape(J_own*(k-1)*K*(k-1), pk)`` — d-independent (packet
    # units), so all shard widths share them like every other table.
    enc_src: np.ndarray = field(default=None, repr=False)    # [K, n, k]
    dec_src: np.ndarray = field(default=None, repr=False)    # [K, n, k-1, k]
    dec_mask: np.ndarray = field(default=None, repr=False)   # [K, n, k-1, k]
    dec_recv: np.ndarray = field(default=None, repr=False)   # [K, n, k-1]
    #   dec_recv[s, row, c] = flat row of recv.reshape(n*(k-1), pk) whose
    #   round packet decodes into chunk slot c — argsort(dec_gather)
    #   baked at lowering time (no per-trace argsort in the executor).

    # batched round routing (see module docstring)
    a2a_send: np.ndarray = field(default=None, repr=False)   # [k-1, K, K, R]
    a2a_recv: np.ndarray = field(default=None, repr=False)   # [k-1, K, n]
    pp_send: np.ndarray = field(default=None, repr=False)    # [k-1, q, K, R]
    pp_recv: np.ndarray = field(default=None, repr=False)    # [k-1, K, n]
    pp_perms: tuple = field(default=(), repr=False)          # [k-1][q] pairs

    @property
    def n(self) -> int:
        return len(self.rows)


# --------------------------------------------------------------------- #
# two-level host-aware relay tables (DESIGN.md §16)
# --------------------------------------------------------------------- #
@dataclass(frozen=True, eq=False)
class HostTables:
    """Two-level relay overlay for one coded stage.

    The flat schedule delivers each coded packet Δ[g, u] (group row
    ``g``, sender ``u``) to its ``k-1`` receivers directly, one per
    broadcast round — so with class-major host blocks, the SAME packet
    crosses the slow inter-host edge once per off-host receiver
    (``k - k/hosts`` times). The two-level schedule deduplicates those
    crossings:

    * **Phase A** is the flat per-round exchange with every delivery
      that is not its packet's GATEWAY copy to a host masked out of
      the send tables (``-1`` -> zero block / dead lane). The gateway
      on each remote host defaults to the first receiver there in
      round order; a ``gateway_avoid`` preference (straggler-aware
      failover, DESIGN.md §17) re-homes it to the first NON-avoided
      receiver instead — same-host deliveries are never masked.
    * **Phase B** relays the masked copies over the fast edge: for
      round ``r`` and intra-host shift ``delta``, a single ppermute
      moves, from each gateway, the packet it received in its own
      primary round ``r0`` to the non-gateway receiver — filling
      exactly the recv slot the flat exchange would have filled.
      Phase B gathers from the COMPLETED phase-A buffer, so ``r0``
      may lie before or after the relay round ``r`` (an avoided
      early receiver relays from a later gateway legally). After A+B
      the receive buffer is WORD-IDENTICAL to the flat one, so decode
      and outputs stay bitwise equal for EVERY gateway assignment.

    Packet counts: per (group row, sender) the flat schedule crosses
    hosts ``k - c`` times (``c = k/hosts`` classes per host) and the
    two-level one ``hosts - 1`` times — a strict cut whenever
    ``hosts < k``. Stage-3 unicasts are intra-class and classes sit
    inside host blocks, so stage 3 never crosses under either schedule.
    """

    hosts: int
    dph: int                      # devices per host (= (k/hosts) * q)
    a2a_send: np.ndarray          # [k-1, K, K, R]   primary-masked
    pp_send: np.ndarray           # [k-1, q, K, R]   primary-masked
    b_deltas: tuple               # intra-host shifts with relay traffic
    b_send: np.ndarray            # [k-1, nd, K, Rb] flat recv rows
    #                               (entry = li*(k-1) + (r0-1); -1 pad)
    b_recv: np.ndarray            # [k-1, K, n] slot into the relay buf
    b_mask: np.ndarray            # [k-1, K, n] round-r slot phase-B fed
    b_perms: tuple                # [nd][K] (src, dst) intra-host cyclic
    b_live: tuple                 # [k-1] delta indices with traffic that
    #                               round (under the DEFAULT gateway
    #                               choice round 1 is always empty: the
    #                               first-in-round-order gateway leaves
    #                               nothing earlier to relay; an avoid
    #                               preference may relay in any round)
    Rb: int                       # relay rows per (round, shift, sender)
    # modeled per-edge delivery counts (packets; DESIGN.md §16)
    flat_inter: int               # cross-host deliveries, flat schedule
    two_level_inter: int          # cross-host gateway copies (phase A)
    relay_intra: int              # phase-B intra-host relay hops
    intra: int                    # same-host phase-A deliveries


def _lower_host_tables(T: StageTables, rows, groups, q, k, K,
                       hosts, avoid=frozenset()) -> HostTables:
    """Build the two-level overlay of one coded stage (see
    :class:`HostTables`). Pure numpy at lowering time, like
    :func:`_lower_stage`.

    ``avoid`` is the gateway preference (DESIGN.md §17): devices a
    straggler-aware caller wants routed AROUND as phase-A gateways.
    Per (sender, remote host) the gateway is the first receiver there
    in round order that is not avoided; when every receiver on the
    host is avoided, the plain round-order first is kept (the packet
    must land somewhere). ``avoid=frozenset()`` reproduces the default
    tables byte-for-byte.
    """
    dph = K // hosts
    c = k // hosts                      # classes per host
    n = len(rows)
    a2a_send = T.a2a_send.copy()
    pp_send = T.pp_send.copy()
    b_mask = np.zeros((k - 1, K, n), dtype=bool)
    moves = {}                          # (r, delta, gateway) -> entries
    flat_inter = two_inter = relay = intra = 0

    for li in range(n):
        g = rows[li]
        G = [int(x) for x in groups[g]]
        for pm, m in enumerate(G):
            hm = m // dph
            remote = {}                 # remote host -> [(r, w)] rnd order
            for r in range(1, k):
                w = G[(pm + r) % k]
                hw = w // dph
                if hw == hm:
                    intra += 1
                    continue            # same-host: always primary
                flat_inter += 1
                remote.setdefault(hw, []).append((r, w))
            for rws in remote.values():
                r0, gw = next(((r, w) for r, w in rws
                               if w not in avoid), rws[0])
                two_inter += 1          # the gateway copy stays primary
                for r, w in rws:
                    if w == gw:
                        continue
                    relay += 1
                    # demote (li, r, m -> w) from phase A ...
                    sl = a2a_send[r - 1, m, w]
                    sl[int(np.flatnonzero(sl == li)[0])] = -1
                    dpp = ((w % q) - (m % q)) % q
                    sl = pp_send[r - 1, dpp, m]
                    sl[int(np.flatnonzero(sl == li)[0])] = -1
                    # ... and relay it intra-host from the gateway
                    b_mask[r - 1, w, li] = True
                    delta = (w - gw) % dph
                    moves.setdefault((r, delta, gw), []).append(
                        (li, r0, w))

    # uniform-count sanity: one member per class, c classes per host
    assert flat_inter == n * k * (k - c)
    assert two_inter == n * k * (hosts - 1)
    assert relay == flat_inter - two_inter
    assert intra == n * k * (c - 1)

    deltas = sorted({delta for (_, delta, _) in moves})
    dmap = {delta: i for i, delta in enumerate(deltas)}
    nd = len(deltas)
    Rb = max((len(v) for v in moves.values()), default=0)
    b_send = np.full((k - 1, max(nd, 1), K, max(Rb, 1)), -1,
                     dtype=np.int32)
    b_recv = np.zeros((k - 1, K, n), dtype=np.int32)
    # per-round live shifts: the executor issues one relay ppermute per
    # (round, shift) WITH traffic and concatenates them in b_live order,
    # so receive slots index the concatenated live lanes only
    b_live = [sorted({dmap[delta] for (rr, delta, _) in moves
                      if rr == r}) for r in range(1, k)]
    for (r, delta, gw), entries in sorted(moves.items()):
        lane = b_live[r - 1].index(dmap[delta])
        for idx, (li, r0, w) in enumerate(sorted(entries)):
            b_send[r - 1, dmap[delta], gw, idx] = li * (k - 1) + (r0 - 1)
            b_recv[r - 1, w, li] = lane * Rb + idx
    b_perms = []
    for delta in deltas:
        pairs = []
        for h in range(hosts):
            for a in range(dph):
                pairs.append((h * dph + a, h * dph + (a + delta) % dph))
        b_perms.append(tuple(pairs))

    return HostTables(
        hosts=hosts, dph=dph,
        a2a_send=a2a_send, pp_send=pp_send,
        b_deltas=tuple(deltas), b_send=b_send, b_recv=b_recv,
        b_mask=b_mask, b_perms=tuple(b_perms),
        b_live=tuple(tuple(x) for x in b_live), Rb=Rb,
        flat_inter=flat_inter, two_level_inter=two_inter,
        relay_intra=relay, intra=intra)


# --------------------------------------------------------------------- #
# the program
# --------------------------------------------------------------------- #
@dataclass(frozen=True, eq=False)
class ShuffleProgram:
    """Compiled CAMR shuffle schedule (see module docstring)."""

    q: int
    k: int
    Q: int                                   # number of reduce functions
    design: ResolvableDesign = field(repr=False)
    placement: Placement = field(repr=False)

    # unified group table over stages 1+2: n_groups = q**k rows
    group_vals: np.ndarray = field(repr=False)   # [n_groups, k] value vecs
    groups: np.ndarray = field(repr=False)       # [n_groups, k] server ids
    stage_of: np.ndarray = field(repr=False)     # [n_groups] in {1, 2}
    chunk_job: np.ndarray = field(repr=False)    # [n_groups, k]
    chunk_batch: np.ndarray = field(repr=False)  # [n_groups, k]
    chunk_aux: np.ndarray = field(repr=False)    # [n_groups, k] classmate
    #                                              owner (stage 2), else -1
    s1_rows: np.ndarray = field(repr=False)      # [J] row of job j's group
    s2_rows: np.ndarray = field(repr=False)      # [n_s2] rows, rank order

    # local storage layout (device s's contribs rows)
    owned_jobs: np.ndarray = field(repr=False)       # [K, J_own]
    stored_batches: np.ndarray = field(repr=False)   # [K, J_own, k-1]

    # stage 3 unicasts
    s3_job: np.ndarray = field(repr=False)       # [n3]
    s3_recv: np.ndarray = field(repr=False)      # [n3]
    s3_send: np.ndarray = field(repr=False)      # [n3]
    s3_batches: np.ndarray = field(repr=False)   # [n3, k-1]
    s3_perms: tuple = field(repr=False)          # [q-1] intra-class shifts

    # reduce-side assembly
    is_own: np.ndarray = field(repr=False)       # [K, J] bool
    own_slot: np.ndarray = field(repr=False)     # [K, J] local job slot
    s2_ord: np.ndarray = field(repr=False)       # [K, J] stage-2 ordinal
    s3_off: np.ndarray = field(repr=False)       # [K, J] stage-3 round idx

    # SPMD tables (None when lowered with device_tables=False)
    s1: StageTables | None = field(repr=False, default=None)
    s2: StageTables | None = field(repr=False, default=None)
    d: int | None = None                         # SPMD shard width

    # two-level topology overlay (None == flat, the identity case)
    topology: Topology | None = None
    hx1: HostTables | None = field(repr=False, default=None)
    hx2: HostTables | None = field(repr=False, default=None)
    # gateway failover preference the host tables were lowered with
    # (empty == default first-in-round-order gateways; flat-only
    # programs always carry the empty set)
    gateway_avoid: frozenset = frozenset()

    # ------------------------------------------------------------------ #
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
    def n_groups(self) -> int:
        return self.q ** self.k

    @property
    def n_s2(self) -> int:
        return self.n_groups - self.J

    @property
    def packet_len(self) -> int:
        if self.d is None:
            raise ValueError("program lowered without device tables")
        return self.d // (self.k - 1)

    @property
    def n_batched_collectives(self) -> int:
        """Batched collectives issued for stages 1+2 (all_to_all router)."""
        return 2 * (self.k - 1)

    def stage_tables(self, stage: int) -> StageTables:
        t = self.s1 if stage == 1 else self.s2
        if t is None:
            raise ValueError("program lowered without device tables")
        return t

    def host_tables(self, stage: int) -> HostTables:
        t = self.hx1 if stage == 1 else self.hx2
        if t is None:
            raise ValueError("program lowered without a two-level "
                             "topology")
        return t

    def stage_rows(self, stage: int) -> np.ndarray:
        return self.s1_rows if stage == 1 else self.s2_rows

    def group_members(self, row: int) -> tuple[int, ...]:
        return tuple(int(x) for x in self.groups[row])

    def round_perms(self, stage: int) -> tuple:
        """Per-group per-round (src, dst) pairs for the LOOPED legacy
        router: round ``r`` sends ``G[p] -> G[(p+r) % k]``."""
        k = self.k
        out = []
        for row in self.stage_rows(stage):
            G = self.group_members(int(row))
            out.append(tuple(
                tuple((G[p], G[(p + r) % k]) for p in range(k))
                for r in range(1, k)))
        return tuple(out)

    def coded_chunks(self, row: int) -> list[tuple[int, int, int]]:
        """[(receiver, job, batch)] for one group row — engine view."""
        return [
            (int(self.groups[row, p]), int(self.chunk_job[row, p]),
             int(self.chunk_batch[row, p]))
            for p in range(self.k)
        ]


# --------------------------------------------------------------------- #
# lowering
# --------------------------------------------------------------------- #
@lru_cache(maxsize=64)  # Placement hashes by identity (frozen, eq=False);
#                         bounded: long-lived replanning loops build fresh
#                         placements and must not pin every program forever
def lower_program(placement: Placement, Q: int | None = None,
                  d: int | None = None, *,
                  device_tables: bool = True,
                  topology: Topology | None = None,
                  gateway_avoid: frozenset = frozenset()
                  ) -> ShuffleProgram:
    """Lower ``(Placement, Q, d)`` into a :class:`ShuffleProgram`.

    ``d`` (SPMD function-shard width, elements) is only required for the
    collective executor; the engine interprets the schedule tables alone
    (``device_tables=False`` skips the [K, n, ...] SPMD tables).

    ``topology`` selects the transport lowering: ``None`` / flat emits
    exactly the schedules every prior PR emitted (the identity case); a
    two-level topology additionally lowers the host-aware relay overlay
    (:class:`HostTables`) that deduplicates inter-host packet copies.
    An :class:`AutoTopology` marker resolves via the cost model first.
    The VALUES computed are identical either way — topology only
    changes which edge each packet rides.

    ``gateway_avoid`` (two-level only) re-homes phase-A gateways away
    from the named devices (straggler failover, DESIGN.md §17); the
    empty set is the default first-in-round-order assignment, byte-
    identical to every pre-§17 lowering. Outputs stay bitwise equal to
    flat for every assignment.
    """
    design = placement.design
    q, k, K, J = design.q, design.k, design.K, design.J
    Q = K if Q is None else Q
    if Q % K:
        raise ValueError("Q must be a multiple of K")
    if d is not None and d % (k - 1):
        raise ValueError(f"shard width d={d} must be divisible by "
                         f"k-1={k - 1}")
    topology = resolve_topology(topology, q, k)
    if topology is not None:
        topology.check(q, k)
    gateway_avoid = frozenset(int(x) for x in (gateway_avoid or ()))
    if topology is None:
        gateway_avoid = frozenset()      # flat has no gateways to move
    elif not all(0 <= x < K for x in gateway_avoid):
        raise ValueError(f"gateway_avoid {sorted(gateway_avoid)} has "
                         f"devices outside [0, {K})")

    n_groups = q ** k
    group_vals = np.zeros((n_groups, k), dtype=np.int32)
    groups = np.zeros((n_groups, k), dtype=np.int32)
    stage_of = np.zeros(n_groups, dtype=np.int32)
    chunk_job = np.zeros((n_groups, k), dtype=np.int32)
    chunk_batch = np.zeros((n_groups, k), dtype=np.int32)
    chunk_aux = np.full((n_groups, k), -1, dtype=np.int32)
    s1_rows, s2_rows = [], []

    for g in range(n_groups):
        v = _rank_to_vec(g, q, k)
        group_vals[g] = v
        G = tuple(design.server_of(i, v[i]) for i in range(k))
        groups[g] = G
        if sum(v[:-1]) % q == v[-1]:
            stage_of[g] = 1
            j = _group_rank(v[:-1], q)           # job = message rank
            assert design.owners[j] == G
            s1_rows.append(g)
            for p, kp in enumerate(G):
                chunk_job[g, p] = j
                chunk_batch[g, p] = placement.batch_of_label(j, kp)
        else:
            stage_of[g] = 2
            s2_rows.append(g)
            for p, kp in enumerate(G):
                Pset = tuple(s for s in G if s != kp)
                j = design.common_job(Pset)
                (l,) = [u for u in design.owners[j]
                        if design.class_of(u) == p]
                t = placement.batch_of_label(j, l)
                # Lemma-2 condition: every other member stores that batch
                assert all(placement.stores(s, j, t) for s in Pset), \
                    "stage-2 storage condition"
                chunk_job[g, p] = j
                chunk_batch[g, p] = t
                chunk_aux[g, p] = l

    s1_rows = np.asarray(s1_rows, dtype=np.int32)
    s2_rows = np.asarray(s2_rows, dtype=np.int32)
    assert len(s1_rows) == J

    # -- local storage layout ------------------------------------------- #
    J_own = design.block_size
    owned = np.zeros((K, J_own), dtype=np.int32)
    stored = np.zeros((K, J_own, k - 1), dtype=np.int32)
    owned_index = {}
    stored_index = {}
    for s in range(K):
        for a, j in enumerate(design.owned_jobs(s)):
            owned[s, a] = j
            owned_index[(s, j)] = a
            tmiss = placement.batch_of_label(j, s)
            row = [t for t in range(k) if t != tmiss]
            stored[s, a] = row
            for b, t in enumerate(row):
                stored_index[(s, j, t)] = b

    # -- stage 3 -------------------------------------------------------- #
    s3_job, s3_recv, s3_send, s3_batches = [], [], [], []
    for i in range(k):
        cls = design.parallel_class(i)
        for m in cls:
            for u in cls:
                if u == m:
                    continue
                for j in design.owned_jobs(u):
                    tu = placement.batch_of_label(j, u)
                    s3_job.append(j)
                    s3_recv.append(m)
                    s3_send.append(u)
                    s3_batches.append([t for t in range(k) if t != tu])
    s3_job = np.asarray(s3_job, dtype=np.int32)
    s3_recv = np.asarray(s3_recv, dtype=np.int32)
    s3_send = np.asarray(s3_send, dtype=np.int32)
    s3_batches = np.asarray(s3_batches, dtype=np.int32).reshape(-1, k - 1)
    assert len(s3_job) == K * (J - J_own)

    s3_perms = []
    for o in range(1, q):
        pairs = []
        for i in range(k):
            for l in range(q):
                pairs.append((i * q + l, i * q + (l + o) % q))
        s3_perms.append(tuple(pairs))

    # -- reduce-side assembly ------------------------------------------- #
    is_own = np.zeros((K, J), dtype=bool)
    own_slot = np.zeros((K, J), dtype=np.int32)
    s2_ord = np.zeros((K, J), dtype=np.int32)
    s3_off = np.zeros((K, J), dtype=np.int32)
    s2_lookup = {}
    for gi, g in enumerate(s2_rows):
        for p in range(k):
            s2_lookup[(int(groups[g, p]), int(chunk_job[g, p]))] = gi
    for s in range(K):
        for j in range(J):
            if design.is_owner(s, j):
                is_own[s, j] = True
                own_slot[s, j] = owned_index[(s, j)]
            else:
                cls = design.class_of(s)
                (l,) = [u for u in design.owners[j]
                        if design.class_of(u) == cls]
                s3_off[s, j] = (s - l) % q - 1
                s2_ord[s, j] = s2_lookup[(s, j)]
                own_slot[s, j] = owned_index[(l, j)]

    prog = dict(
        q=q, k=k, Q=Q, design=design, placement=placement,
        group_vals=group_vals, groups=groups, stage_of=stage_of,
        chunk_job=chunk_job, chunk_batch=chunk_batch, chunk_aux=chunk_aux,
        s1_rows=s1_rows, s2_rows=s2_rows,
        owned_jobs=owned, stored_batches=stored,
        s3_job=s3_job, s3_recv=s3_recv, s3_send=s3_send,
        s3_batches=s3_batches, s3_perms=tuple(s3_perms),
        is_own=is_own, own_slot=own_slot, s2_ord=s2_ord, s3_off=s3_off,
        d=d, topology=topology, gateway_avoid=gateway_avoid,
    )
    if not device_tables:
        return ShuffleProgram(**prog)

    s1 = _lower_stage(1, s1_rows, groups, chunk_job, chunk_batch,
                      group_vals, q, k, K, owned_index, stored_index)
    s2 = _lower_stage(2, s2_rows, groups, chunk_job, chunk_batch,
                      group_vals, q, k, K, owned_index, stored_index)
    hx1 = hx2 = None
    if topology is not None:
        hx1 = _lower_host_tables(s1, s1_rows, groups, q, k, K,
                                 topology.hosts, avoid=gateway_avoid)
        hx2 = _lower_host_tables(s2, s2_rows, groups, q, k, K,
                                 topology.hosts, avoid=gateway_avoid)
    return ShuffleProgram(s1=s1, s2=s2, hx1=hx1, hx2=hx2, **prog)


def _lower_stage(stage, rows, groups, chunk_job, chunk_batch, group_vals,
                 q, k, K, owned_index, stored_index) -> StageTables:
    """Build the SPMD tables of one coded stage.

    Groups are class-ordered tuples of strictly increasing server ids, so
    ``sorted(G \\ {kp})`` is just ``G`` with ``kp`` removed — the
    Algorithm-2 packet position of member ``x`` w.r.t. chunk owner at
    position ``p_kp`` is ``p_x - (p_x > p_kp)``.
    """
    n = len(rows)
    valid = np.zeros((K, n), dtype=bool)
    src_jslot = np.zeros((K, n, k), dtype=np.int32)
    src_bslot = np.zeros((K, n, k), dtype=np.int32)
    src_ok = np.zeros((K, n, k), dtype=bool)
    shard = np.zeros((n, k), dtype=np.int32)
    delta_pos = np.zeros((K, n, k), dtype=np.int32)
    cancel_pos = np.zeros((K, n, k - 1, k), dtype=np.int32)
    cancel_mask = np.zeros((K, n, k - 1, k), dtype=bool)
    dec_gather = np.zeros((K, n, k - 1), dtype=np.int32)

    def pos(p_x, p_kp):
        return p_x - (1 if p_x > p_kp else 0)

    for li, g in enumerate(rows):
        G = [int(x) for x in groups[g]]
        shard[li] = G
        for myp, s in enumerate(G):
            valid[s, li] = True
            for p, kp in enumerate(G):
                if kp == s:
                    continue
                j, t = int(chunk_job[g, p]), int(chunk_batch[g, p])
                src_jslot[s, li, p] = owned_index[(s, j)]
                src_bslot[s, li, p] = stored_index[(s, j, t)]
                src_ok[s, li, p] = True
                delta_pos[s, li, p] = pos(myp, p)
            for r in range(1, k):
                mp = (myp - r) % k
                dec_gather[s, li, r - 1] = pos(mp, myp)
                for p in range(k):
                    if p not in (mp, myp):
                        cancel_pos[s, li, r - 1, p] = pos(mp, p)
                        cancel_mask[s, li, r - 1, p] = True

    # -- fused-codec flat index tables (DESIGN.md §10) ------------------ #
    # flat packet row of chunk (jslot, bslot, shard, packet-pos) in the
    # device's u32 buffer viewed as [J_own*(k-1)*K*(k-1), pk]
    base = (src_jslot * (k - 1) + src_bslot) * K + shard[None]   # [K, n, k]
    enc_src = np.where(src_ok, base * (k - 1) + delta_pos, 0).astype(
        np.int32)
    # bake argsort(dec_gather): order[s, row, c] = round whose packet
    # lands in chunk slot c (dec_gather is a permutation wherever the
    # device is a group member; elsewhere the rows are dead — stable
    # argsort keeps them deterministic)
    order = np.argsort(dec_gather, axis=2, kind="stable")        # [K,n,k-1]
    dec_recv = (order + np.arange(n, dtype=np.int32)[None, :, None]
                * (k - 1)).astype(np.int32)
    dec_mask = np.take_along_axis(cancel_mask, order[..., None], axis=2)
    dec_src = np.take_along_axis(cancel_pos, order[..., None], axis=2)
    dec_src = np.where(dec_mask, base[:, :, None, :] * (k - 1) + dec_src,
                       0).astype(np.int32)

    # -- routing blocks: shared by both routers ------------------------- #
    # rows per ordered (sender, receiver) pair: fixing two coordinates of
    # the value vector leaves q^(k-3) stage-1 / q^(k-3)*(q-1) stage-2
    # groups — uniform over pairs, so R is exact (asserted below).
    R = q ** (k - 3) if k >= 3 else 1
    if stage == 2:
        R *= q - 1
    a2a_send = np.full((k - 1, K, K, R), -1, dtype=np.int32)
    a2a_recv = np.zeros((k - 1, K, n), dtype=np.int32)
    pp_send = np.full((k - 1, q, K, R), -1, dtype=np.int32)
    pp_recv = np.zeros((k - 1, K, n), dtype=np.int32)
    pp_perms = []
    counts = {}
    for r in range(1, k):
        counts.clear()
        for li, g in enumerate(rows):
            G = [int(x) for x in groups[g]]
            for iu, u in enumerate(G):
                w = G[(iu + r) % k]
                idx = counts.get((u, w), 0)
                counts[(u, w)] = idx + 1
                assert idx < R
                a2a_send[r - 1, u, w, idx] = li
                a2a_recv[r - 1, w, li] = u * R + idx
                delta = ((w % q) - (u % q)) % q
                pp_send[r - 1, delta, u, idx] = li
                pp_recv[r - 1, w, li] = delta * R + idx
        perms_r = []
        for delta in range(q):
            pairs = []
            for i in range(k):
                for l in range(q):
                    src = i * q + l
                    dst = ((i + r) % k) * q + (l + delta) % q
                    pairs.append((src, dst))
            perms_r.append(tuple(pairs))
        pp_perms.append(tuple(perms_r))

    return StageTables(
        stage=stage, rows=np.asarray(rows, dtype=np.int32), R=R,
        valid=valid,
        src_jslot=src_jslot, src_bslot=src_bslot, src_ok=src_ok,
        shard=shard, delta_pos=delta_pos,
        cancel_pos=cancel_pos, cancel_mask=cancel_mask,
        dec_gather=dec_gather,
        enc_src=enc_src, dec_src=dec_src, dec_mask=dec_mask,
        dec_recv=dec_recv,
        a2a_send=a2a_send, a2a_recv=a2a_recv,
        pp_send=pp_send, pp_recv=pp_recv, pp_perms=tuple(pp_perms),
    )


# --------------------------------------------------------------------- #
# degraded lowering (fault runtime)
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class DegradedProgram:
    """Schedule re-lowered for a surviving server set.

    ``coded_rows``    group rows whose members are all live: run
                      Algorithm 2 unchanged.
    ``uncoded``       per degraded group row, the uncoded unicast plan:
                      tuples ``(sender, receiver, job, batch, owner)``
                      where ``owner`` is the ORIGINAL chunk receiver
                      (its id is the reduce-function index).
    ``s3``            stage-3 sends ``(sender, receiver, job, owner,
                      batches)``; several entries may share a
                      ``(receiver, job, owner)`` key — the executor
                      combines them.
    """

    base: ShuffleProgram
    failed: frozenset
    migrate: np.ndarray                  # [K] takeover server ids
    coded_rows: tuple
    uncoded: tuple                       # [(row, sends)]
    s3: tuple


def lower_degraded(program: ShuffleProgram,
                   failed: set[int]) -> DegradedProgram:
    """Re-lower ``program`` for the live servers ``K \\ failed``.

    Raises ``ValueError`` when the loss exceeds what the placement
    redundancy can absorb (same conditions the paper's recovery needs).
    """
    design, pl = program.design, program.placement
    q, k, K = program.q, program.k, program.K
    failed = frozenset(failed)
    if k < 3:
        raise ValueError("degraded recovery requires k >= 3 (k = 2 "
                         "leaves single-holder batches)")
    for i in range(k):
        cls = set(design.parallel_class(i))
        if len(cls & failed) > 1:
            raise ValueError(
                "multiple failures in one parallel class need map "
                "recompute (not just shuffle recovery)")
    for j in range(design.J):
        for t in range(k):
            if set(pl.holders(j, t)) <= failed:
                raise ValueError(
                    f"batch (job {j}, batch {t}) lost all {k - 1} "
                    "replicas — data loss, not recoverable by the "
                    "shuffle (re-map from the master copy required)")

    migrate = np.arange(K, dtype=np.int32)
    for s in sorted(failed):
        cls = design.parallel_class(design.class_of(s))
        migrate[s] = next(c for c in cls if c not in failed)

    coded_rows, uncoded = [], []
    for row in range(program.n_groups):
        G = program.group_members(row)
        if not (set(G) & failed):
            coded_rows.append(row)
            continue
        sends = []
        for p, (kp, j, t) in zip(range(k), program.coded_chunks(row)):
            rcv = int(migrate[kp])
            holder = next(s for s in G if s != kp and s not in failed)
            sends.append((holder, rcv, j, t, kp))
        uncoded.append((row, tuple(sends)))

    s3 = []
    for i in range(len(program.s3_job)):
        j = int(program.s3_job[i])
        m = int(program.s3_recv[i])
        u = int(program.s3_send[i])
        batches = tuple(int(t) for t in program.s3_batches[i])
        rcv = int(migrate[m])
        if u not in failed:
            s3.append((u, rcv, j, m, batches))
        else:
            for t in batches:
                holder = next(h for h in pl.holders(j, t)
                              if h not in failed)
                s3.append((holder, rcv, j, m, (t,)))
    # migration fill: the takeover of failed f additionally needs, per
    # job f OWNED, the aggregate of the k-1 batches f held locally.
    # Sends are ordered so the receiver's sequential combine reproduces
    # the healthy ascending batch fold bit-for-bit (engine.reduce_phase
    # canonical order): l1 stores everything except its own label batch
    # t1, so the prefix below t1 goes combined, t1 comes from another
    # live holder, and the suffix above t1 goes one batch per send.
    for f in sorted(failed):
        s = int(migrate[f])
        for j in design.owned_jobs(f):
            tf = pl.batch_of_label(j, f)
            rest = [t for t in range(k) if t != tf]
            l1 = next(u for u in design.owners[j] if u not in failed)
            t1 = pl.batch_of_label(j, l1)   # != tf: labels are a bijection
            prefix = tuple(t for t in rest if t < t1)
            if prefix:
                s3.append((l1, s, j, f, prefix))
            h2 = next(h for h in pl.holders(j, t1)
                      if h not in failed)
            s3.append((h2, s, j, f, (t1,)))
            for t in rest:
                if t > t1:
                    s3.append((l1, s, j, f, (t,)))

    return DegradedProgram(
        base=program, failed=failed, migrate=migrate,
        coded_rows=tuple(coded_rows), uncoded=tuple(uncoded),
        s3=tuple(s3))


# --------------------------------------------------------------------- #
# structural schedule cache (DESIGN.md §9)
# --------------------------------------------------------------------- #
def _normalize_label_perm(label_perm, k):
    """Hashable canonical form; the identity labeling collapses to None."""
    if label_perm is None:
        return None
    label_perm = tuple(tuple(int(x) for x in p) for p in label_perm)
    ident = tuple(range(k))
    if all(p == ident for p in label_perm):
        return None
    return label_perm


def _program_key(program: ShuffleProgram) -> tuple:
    """Structural identity of a lowered program — same tuple, same
    tables. ``d`` is deliberately absent: no table depends on it, so
    width variants of one configuration share degraded re-lowerings.
    The topology (with its cost parameters) IS present: flat and
    two-level lowerings of the same ``(q, k, gamma, Q)`` must never
    alias (flat collapses to ``None``, keeping every pre-topology key
    byte-identical). A non-default gateway assignment extends the key
    (the default/flat key shape stays byte-identical to pre-§17)."""
    topo = None if program.topology is None else program.topology.key()
    base = (program.q, program.k, program.placement.gamma,
            _normalize_label_perm(program.placement.label_perm, program.k),
            program.Q, program.s1 is not None, topo)
    gw = tuple(sorted(program.gateway_avoid))
    return base + (gw,) if gw else base


class ScheduleCache:
    """Process-wide cache of lowered schedules, keyed by VALUE.

    :func:`lower_program` is memoized on Placement *identity* (frozen,
    ``eq=False``), which is the right policy for a long-lived placement
    object but useless to a runtime that builds one engine per wave of
    jobs: every wave re-derives the same design/placement and pays the
    full lowering again. This cache keys structurally instead
    (DESIGN.md §9):

    * programs by ``(q, k, gamma, label_perm, Q, device_tables,
      topology)`` — the survivor set of a healthy cluster is implicit,
      and the flat topology normalizes to ``None`` so flat and
      two-level lowerings of one configuration never alias;
    * degraded programs additionally by ``frozenset(failed)``, i.e. one
      entry per *survivor set*, so fault re-lowering is paid once per
      (configuration, failure pattern) instead of once per wave.

    ``d`` (the SPMD shard width) does NOT change any table — only the
    runtime packet split — so all widths of one configuration share the
    same base lowering; a width-stamped view is a cheap
    ``dataclasses.replace``. A changed survivor set is a different key
    (never a mutation), and :meth:`clear` drops everything — those are
    the only two invalidation events; entries otherwise stay valid
    forever because every input of the lowering is in the key.

    Both maps are LRU-bounded (``maxsize`` each) so replanning loops
    cannot pin unbounded table memory. Lookups are serialized by a
    lock: the JobStream runtime constructs engines (and therefore
    queries this cache) from its map prefetch thread.
    """

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self._programs: OrderedDict = OrderedDict()
        self._degraded: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    # -- bookkeeping ---------------------------------------------------- #
    def _get(self, table: OrderedDict, key):
        got = table.get(key)
        if got is None:
            self.misses += 1
        else:
            self.hits += 1
            table.move_to_end(key)
        return got

    def _put(self, table: OrderedDict, key, value):
        table[key] = value
        while len(table) > self.maxsize:
            table.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            return dict(hits=self.hits, misses=self.misses,
                        programs=len(self._programs),
                        degraded=len(self._degraded))

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()
            self._degraded.clear()
            self.hits = 0
            self.misses = 0

    # -- lookups -------------------------------------------------------- #
    def program(self, q: int, k: int, *, gamma: int = 1,
                Q: int | None = None, d: int | None = None,
                label_perm=None, device_tables: bool = True,
                topology: Topology | None = None,
                gateway_avoid: frozenset = frozenset()
                ) -> ShuffleProgram:
        """The lowered program of one configuration (lowering on miss).

        ``topology`` is part of the structural key (flat normalizes to
        ``None``, so flat lookups hit exactly the pre-topology
        entries; an :class:`AutoTopology` marker resolves via the cost
        model first); flat and two-level lowerings of the same
        ``(q, k, gamma, Q)`` occupy distinct entries and never
        cross-hit. ``gateway_avoid`` joins the key the same way: the
        default empty assignment keys as ``None``, so every
        non-default gateway failover lowering is its own entry."""
        label_perm = _normalize_label_perm(label_perm, k)
        Q = q * k if Q is None else Q   # lower_program's own default
        if d is not None and d % (k - 1):
            raise ValueError(f"shard width d={d} must be divisible by "
                             f"k-1={k - 1}")
        topology = resolve_topology(topology, q, k)
        gateway_avoid = frozenset(int(x) for x in (gateway_avoid or ()))
        if topology is None:
            gateway_avoid = frozenset()
        topo_key = None if topology is None else topology.key()
        gw_key = tuple(sorted(gateway_avoid)) or None
        base_key = (q, k, gamma, label_perm, Q, device_tables, topo_key,
                    gw_key, None)
        with self._lock:
            base = self._get(self._programs, base_key)
            if base is None:
                pl = make_placement(make_design(q, k), gamma,
                                    label_perm=label_perm)
                # bypass lower_program's identity-keyed lru_cache: the
                # placement is fresh (guaranteed miss there), and going
                # through it would pin every lowering a second time,
                # surviving this cache's eviction/clear()
                base = lower_program.__wrapped__(
                    pl, Q=Q, d=None, device_tables=device_tables,
                    topology=topology, gateway_avoid=gateway_avoid)
                self._put(self._programs, base_key, base)
            if d is None:
                return base
            key = base_key[:-1] + (d,)
            prog = self._get(self._programs, key)
            if prog is None:
                prog = replace(base, d=d)  # tables shared with the base
                self._put(self._programs, key, prog)
            return prog

    def degraded(self, program: ShuffleProgram,
                 failed) -> DegradedProgram:
        """The re-lowered schedule for ``program`` minus ``failed``.

        Unrecoverable patterns raise (and are not cached) exactly as
        :func:`lower_degraded` does.
        """
        key = (_program_key(program),
               frozenset(int(s) for s in failed))
        with self._lock:
            got = self._get(self._degraded, key)
            if got is None:
                got = lower_degraded(program, set(failed))
                self._put(self._degraded, key, got)
            return got

    def warm_survivors(self, program, max_failures: int = 1) -> int:
        """Pre-lower the degraded schedule of every recoverable
        survivor set with up to ``max_failures`` concurrent failures,
        so a mid-stream membership change never pays a lowering on the
        recovery critical path (DESIGN.md §14). Unrecoverable sets
        (same-class double failures, total batch loss) are skipped.
        Returns the number of degraded programs now resident. Bounded:
        single failures are K entries; keep ``max_failures`` small or
        raise ``maxsize`` accordingly (LRU eviction applies as usual).
        """
        from itertools import combinations
        warmed = 0
        for r in range(1, max_failures + 1):
            for combo in combinations(range(program.K), r):
                try:
                    self.degraded(program, set(combo))
                except ValueError:
                    continue
                warmed += 1
        return warmed

    def warm_host_survivors(self, program: ShuffleProgram,
                            max_host_failures: int = 1) -> int:
        """Pre-lower ``program`` under every surviving-host topology
        reachable by losing up to ``max_host_failures`` whole hosts
        (DESIGN.md §17) — the host-granularity sibling of
        :meth:`warm_survivors`. Host-loss recovery is a TOPOLOGY
        re-homing (the schedule values never change, only which edge
        each packet rides), and the lowering depends only on the
        surviving host COUNT, so one entry per loss count covers every
        subset of that size. After this, ``kill_host`` recovery is a
        pure cache hit: zero cold lowerings on the critical path.
        Returns the number of surviving-topology programs warmed.
        """
        topo = program.topology
        if topo is None:
            raise ValueError(
                "warm_host_survivors needs a program lowered for a "
                "two-level topology (a flat lowering has no host "
                "blocks to lose)")
        if not 0 < max_host_failures < topo.hosts:
            raise ValueError(
                f"max_host_failures={max_host_failures} must leave at "
                f"least one of {topo.hosts} hosts alive")
        warmed = 0
        for lost in range(1, max_host_failures + 1):
            t = surviving_topology(topo.hosts - lost, program.k,
                                   alpha=topo.alpha)
            self.program(
                program.q, program.k, gamma=program.placement.gamma,
                Q=program.Q, d=program.d,
                label_perm=program.placement.label_perm,
                device_tables=program.s1 is not None, topology=t,
                gateway_avoid=program.gateway_avoid)
            warmed += 1
        return warmed


#: Module-level default — all engines/plans share one schedule cache.
SCHEDULE_CACHE = ScheduleCache()


class ExecCache:
    """Process-wide cache of built (usually jitted) executables, keyed
    by VALUE — the serving sibling of :class:`ScheduleCache`
    (DESIGN.md §13).

    A ``ScheduleCache`` entry is a lowered *data plan*; an ``ExecCache``
    entry is a compiled *callable* (or a tuple of them): the jitted
    decode-wave ``lax.while_loop``, prefill/admit executables, the
    legacy serving step pair. Keys are caller-chosen tuples of
    hashables — the convention is
    ``(kind, cfg, *shape_signature)``, e.g.
    ``("serve_wave", cfg, slots, pages, page_size, ...)`` — so every
    input that changes the traced computation is in the key and entries
    never go stale. Same LRU bound + lock discipline as the schedule
    cache (the serving front door builds executables from its prefill
    prefetch thread).
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get(self, key, build):
        """Return the cached executable for ``key``; on a miss, call
        ``build()`` (under the lock — one build per key) and cache the
        result."""
        with self._lock:
            got = self._entries.get(key)
            if got is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                return got
            self.misses += 1
            got = build()
            self._entries[key] = got
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            return got

    def stats(self) -> dict:
        with self._lock:
            return dict(hits=self.hits, misses=self.misses,
                        entries=len(self._entries))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0


#: Module-level default — serving entry points share one executable
#: cache (a second ``generate``/engine over the same config re-uses the
#: compiled closures instead of retracing).
EXEC_CACHE = ExecCache()
