"""The collective ledger: what the port's shuffle executors exchange.

Counterpart of ``repro.launch.hlo_stats``, which sums the result-shape
bytes of every collective op in a compiled XLA module. A torch program
has no HLO to parse, so the executors of
:mod:`repro_torch.core.collective` report each collective of the JAX
executor they stand in for, as they run it: its HLO kind name
(``all-to-all``, ``collective-permute``, ``all-reduce``, ``all-gather``,
``reduce-scatter``) and the per-device byte size of its result, which is
what the HLO parse sums. It lives in ``core`` beside the executor that
feeds it (``repro_torch.launch.collective_stats`` re-exports it under
its JAX twin's layer). The places that report:

* a coded stage's round exchange: one ``all-to-all`` of ``[K, R, pk]``
  words per round, or ``q`` ``collective-permute`` s of ``[R, pk]``;
* the two-level relay: one ``collective-permute`` of ``[Rb, pk]`` words
  per live (round, shift) lane;
* the looped exchange: one ``collective-permute`` of ``[pk]`` words per
  (group, round);
* stage 3: one ``collective-permute`` of ``[J_own, d]`` values per
  offset;
* ``uncoded_reduce_scatter`` and the dense all-reduce of
  :mod:`repro_torch.launch.camr_compare`: one ``all-reduce`` of
  ``[J, K, d]``.

* a DTensor step of :mod:`repro_torch.launch.steps` on a mesh: each
  all-gather, reduce-scatter, all-reduce and all-to-all its
  redistributes run on this rank (the dry run's tracer reports them),
  with the link it crosses (``"nvlink"`` when the group's ranks share
  an 8-card node, ``"network"`` when it spans nodes).

Nothing is recorded unless a :func:`record_collectives` block is open;
with none open the executors do no extra work and give the same bits::

    with record_collectives() as st:
        camr_shuffle(plan, contribs)
    st.wire_bytes, st.count_by_kind
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

__all__ = ["CollectiveStats", "record_collectives", "note"]

#: the ledgers of the open record_collectives blocks
_OPEN: list = []


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)
    #: on-wire bytes by the link they cross, where the reporter knows it
    wire_by_link: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def wire_bytes(self) -> int:
        """On-wire estimate: all-reduce rings move ~2x their buffer."""
        t = 0
        for kind, b in self.bytes_by_kind.items():
            t += _wire(kind, b)
        return t

    def as_dict(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind),
                "total_bytes": self.total_bytes,
                "wire_bytes": self.wire_bytes,
                "wire_bytes_by_link": dict(self.wire_by_link)}


def _wire(kind: str, nbytes: int) -> int:
    return 2 * nbytes if kind == "all-reduce" else nbytes


@contextlib.contextmanager
def record_collectives():
    """Open a ledger: every collective an executor runs inside the block
    is added to the :class:`CollectiveStats` it yields (blocks nest; each
    open one records)."""
    stats = CollectiveStats()
    _OPEN.append(stats)
    try:
        yield stats
    finally:
        _OPEN.remove(stats)


def note(kind: str, nbytes: int, link: str | None = None) -> None:
    """One collective of ``kind`` whose per-device result is ``nbytes``
    bytes, into every open ledger (none open: nothing happens); ``link``
    names the link it crosses, where known."""
    for st in _OPEN:
        st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0) + int(nbytes)
        st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
        if link is not None:
            st.wire_by_link[link] = (st.wire_by_link.get(link, 0)
                                     + _wire(kind, int(nbytes)))
