"""Analytic communication loads and job requirements — paper §IV, §V.

All loads are normalized by ``J * Q * B`` (Definition 3). The ``bus`` cost
model is the paper's shared-multicast-medium model; see
:mod:`repro.core.shuffle` for the ``p2p`` variant used on TPU ICI.
"""

from __future__ import annotations

from math import comb

__all__ = [
    "camr_stage_loads",
    "camr_load",
    "camr_load_p2p",
    "camr_edge_loads",
    "camr_load_hierarchical",
    "uncoded_load_hierarchical",
    "ccdc_load",
    "ccdc_min_jobs",
    "camr_min_jobs",
    "cdc_load",
    "uncoded_aggregated_load",
    "uncoded_unit_storage_load",
    "storage_fraction",
]


def storage_fraction(q: int, k: int) -> float:
    """mu = (k-1)/K for the CAMR placement."""
    return (k - 1) / (k * q)


def camr_stage_loads(q: int, k: int) -> tuple[float, float, float]:
    """(L_stage1, L_stage2, L_stage3) — paper §IV."""
    K = k * q
    l1 = k / (K * (k - 1))
    l2 = (q - 1) * k / (K * (k - 1))
    l3 = (q - 1) / q
    return l1, l2, l3


def camr_load(q: int, k: int) -> float:
    """L_CAMR = (k(q-1)+1) / (q(k-1)) — paper §IV."""
    return (k * (q - 1) + 1) / (q * (k - 1))


def camr_load_p2p(q: int, k: int) -> float:
    """CAMR load when a multicast to r receivers costs r transmissions
    (point-to-point links, e.g. TPU ICI) — DESIGN.md §3.

    Stages 1-2 multicast to k-1 receivers; stage 3 is unicast already.
    """
    l1, l2, l3 = camr_stage_loads(q, k)
    return (k - 1) * (l1 + l2) + l3


def camr_min_jobs(q: int, k: int) -> int:
    """J_CAMR = q^(k-1)."""
    return q ** (k - 1)


# --------------------------------------------------------------------- #
# two-level (hosts x devices-per-host) cost model — DESIGN.md §16
# --------------------------------------------------------------------- #
def camr_edge_loads(q: int, k: int, hosts: int = 1,
                    schedule: str = "two_level") -> tuple[float, float]:
    """``(L_intra, L_inter)`` per-edge split of the p2p CAMR load on a
    class-major two-level layout (``hosts | k``, ``c = k/hosts``
    parallel classes — hence ``c*q`` devices — per host).

    Per (group, sender) the coded packet has ``k-1`` receivers, one per
    class: ``c-1`` on the sender's host, ``c`` on each of the other
    ``hosts-1`` hosts. Per-hop loads follow from the per-multicast
    stage loads ``l1 + l2 = 1/(k-1)`` (every hop carries one packet of
    ``B/(k-1)``) and stage 3 being intra-class — classes sit inside
    host blocks, so stage 3 NEVER crosses hosts:

    * ``schedule="flat"`` — every receiver is served by a direct hop:
      ``L_inter = (k - c) * (l1 + l2)``,
      ``L_intra = (c - 1) * (l1 + l2) + l3``.
    * ``schedule="two_level"`` — one gateway copy per remote host, then
      intra-host relay to the other ``c-1`` receivers there:
      ``L_inter = (hosts - 1) * (l1 + l2)``,
      ``L_intra = (c - 1) * hosts * (l1 + l2) + l3``.

    Both schedules total ``camr_load_p2p`` hops (the relay moves every
    deduplicated copy once, on the fast edge); the inter-host cut is
    the factor ``hosts/k < 1`` whenever ``hosts < k``. ``hosts = 1``
    reduces both schedules to ``(camr_load_p2p, 0)`` exactly.
    """
    if schedule not in ("flat", "two_level"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if k % hosts:
        raise ValueError(f"hosts={hosts} must divide k={k} (class-major "
                         "host blocks)")
    l1, l2, l3 = camr_stage_loads(q, k)
    c = k // hosts
    if schedule == "flat":
        inter = (k - c) * (l1 + l2)
        intra = (c - 1) * (l1 + l2) + l3
    else:
        inter = (hosts - 1) * (l1 + l2)
        intra = (c - 1) * hosts * (l1 + l2) + l3
    return intra, inter


def camr_load_hierarchical(q: int, k: int, hosts: int = 1,
                           alpha: float = 1.0) -> float:
    """Two-level CAMR cost: ``L_intra + alpha * L_inter`` with
    ``alpha`` = inter-host cost per byte relative to intra-host
    (two-level gateway schedule of :func:`camr_edge_loads`).

    Flat-reduction identities (pinned in tests/test_loads.py):

    * ``hosts = 1`` -> ``camr_load_p2p(q, k)`` exactly, for any alpha
      (no slow edge exists);
    * ``alpha = 1`` -> ``camr_load_p2p(q, k)`` exactly, for any hosts
      (uniform cost collapses the edge split: the two schedules move
      the same total hop count).

    Strictly increasing in ``alpha`` whenever ``hosts >= 2`` (slope
    ``L_inter > 0``), constant for ``hosts = 1``.
    """
    intra, inter = camr_edge_loads(q, k, hosts, schedule="two_level")
    return intra + alpha * inter


def ccdc_load(mu: float, K: int) -> float:
    """L_CCDC = (1-mu)(mu K + 1) / (mu K) — paper Eq. (6), for mu*K integer."""
    r = mu * K
    if abs(r - round(r)) > 1e-9 or not (1 <= round(r) <= K - 1):
        raise ValueError(f"mu*K must be an integer in [1, K-1], got {r}")
    r = round(r)
    return (1 - r / K) * (r + 1) / r


def ccdc_min_jobs(mu: float, K: int) -> int:
    """J_CCDC,min = C(K, mu*K + 1) — paper §V."""
    r = round(mu * K)
    return comb(K, r + 1)


def cdc_load(r: int, K: int) -> float:
    """CDC (no aggregation) tradeoff L(r) = (1/r)(1 - r/K) [Li et al. 2018].

    NOTE: normalized by Q*N*B *per job* in the CDC paper (no combining, so
    every subfile's value crosses the wire); included for context plots.
    """
    if not 1 <= r <= K:
        raise ValueError("r must be in [1, K]")
    return (1 - r / K) / r


def uncoded_aggregated_load(q: int, k: int) -> float:
    """Uncoded shuffle WITH combiners on the CAMR placement.

    Owners: 1 aggregate (B) per (job, owner) -> J*k*B. Non-owners: no single
    server stores all N subfiles, so 2 transmissions (one owner sends its
    k-1 stored batches combined, a second owner sends the remaining batch):
    J*(K-k)*2B.  L = (2K - k)/K.
    """
    K = k * q
    return (2 * K - k) / K


def uncoded_load_hierarchical(q: int, k: int, hosts: int = 1,
                              alpha: float = 1.0) -> float:
    """Uncoded aggregated shuffle (:func:`uncoded_aggregated_load`'s
    delivery plan) priced on the two-level topology:
    ``L_intra + alpha * L_inter``.

    Deliveries on the class-major layout (``hosts | k``): the combined
    ``k-1``-batch aggregate a non-owner receives comes from its
    CLASS-MATE owner — same class, same host block, always intra. The
    single-batch delivery every reducer needs (``J*K`` of them: ``J*k``
    to owners + ``J*(K-k)`` to non-owners) comes from the holder in the
    cyclically-next parallel class, which sits on another host exactly
    when the receiver's class is the last of its host block — ``hosts``
    of the ``k`` classes when ``hosts >= 2`` (including the wrap), none
    when ``hosts = 1``. Hence::

        L_inter = (J*K * hosts/k) / (J*K) = hosts / k     (hosts >= 2)
        L_intra = (2K - k)/K - L_inter

    Identities mirror :func:`camr_load_hierarchical`: ``hosts = 1`` or
    ``alpha = 1`` reduce to ``uncoded_aggregated_load`` exactly.

    (The placement stores every batch on ``c-1 >= 1`` other same-host
    owners whenever ``c = k/hosts >= 2``, so a topology-AWARE uncoded
    sender choice could drive inter-host bytes to zero — at the full
    uncoded total. This function prices the topology-blind plan the
    repo's ``uncoded_reduce_scatter`` baseline actually executes;
    DESIGN.md §16 discusses the tradeoff.)
    """
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if k % hosts:
        raise ValueError(f"hosts={hosts} must divide k={k} (class-major "
                         "host blocks)")
    total = uncoded_aggregated_load(q, k)
    inter = hosts / k if hosts >= 2 else 0.0
    return (total - inter) + alpha * inter


def uncoded_unit_storage_load(K: int) -> float:
    """No redundancy (mu = 1/K), combiners on: each server sends one
    aggregate per (job, other reducer): L = (K-1)/K."""
    return (K - 1) / K
