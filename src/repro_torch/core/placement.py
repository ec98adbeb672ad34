"""File placement — paper Algorithm 1.

Each job's dataset is split into ``N = k * gamma`` subfiles, grouped into
``k`` batches of ``gamma`` consecutive subfiles. Batch ``t`` of job ``j`` is
*labeled* with one owner of ``j`` (a bijection batches <-> owners); every
owner stores all batches of the job EXCEPT the one carrying its own label.

The batch an owner misses is exactly the one whose aggregate it must receive
in shuffle stage 1; the batch labeled by owner ``l`` is the one shared by all
other owners and needed by stage-2/3 receivers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from .designs import ResolvableDesign

__all__ = ["Placement", "make_placement"]


@dataclass(frozen=True, eq=False)  # identity hash: methods are lru_cached
class Placement:
    """Placement of ``J`` jobs x ``N`` subfiles onto ``K`` servers.

    ``label_perm[j]`` maps batch index ``t`` (0..k-1) to the *owner position*
    (index into ``design.owners[j]``) whose label the batch carries. The
    default is the identity (sorted-owner order); the paper's Example 2 uses
    a different bijection — correctness and loads are invariant (tested).
    """

    design: ResolvableDesign
    gamma: int
    label_perm: tuple[tuple[int, ...], ...] = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError("gamma must be >= 1")
        if self.label_perm is None:
            ident = tuple(range(self.design.k))
            object.__setattr__(
                self, "label_perm", tuple(ident for _ in range(self.design.J))
            )

    # ------------------------------------------------------------------ #
    @property
    def N(self) -> int:
        """Subfiles per job."""
        return self.design.k * self.gamma

    def batch_subfiles(self, t: int) -> tuple[int, ...]:
        """Subfile indices (within a job) of batch ``t``."""
        return tuple(range(t * self.gamma, (t + 1) * self.gamma))

    # ------------------------------------------------------------------ #
    # batch labeling
    # ------------------------------------------------------------------ #
    def batch_owner_label(self, job: int, t: int) -> int:
        """Server id whose label batch ``t`` of ``job`` carries."""
        pos = self.label_perm[job][t]
        return self.design.owners[job][pos]

    def batch_of_label(self, job: int, server: int) -> int:
        """Batch index of ``job`` labeled by owner ``server``."""
        owners = self.design.owners[job]
        pos = owners.index(server)
        t = self.label_perm[job].index(pos)
        return t

    # ------------------------------------------------------------------ #
    # storage maps
    # ------------------------------------------------------------------ #
    @lru_cache(maxsize=None)
    def stored_batches(self, server: int) -> tuple[tuple[int, int], ...]:
        """All (job, batch) pairs stored on ``server``.

        An owner stores the k-1 batches of each owned job that do NOT carry
        its own label (Algorithm 1).
        """
        out = []
        for job in self.design.owned_jobs(server):
            skip = self.batch_of_label(job, server)
            out.extend((job, t) for t in range(self.design.k) if t != skip)
        return tuple(out)

    def stores(self, server: int, job: int, t: int) -> bool:
        if not self.design.is_owner(server, job):
            return False
        return t != self.batch_of_label(job, server)

    @lru_cache(maxsize=None)
    def stored_subfiles(self, server: int) -> tuple[tuple[int, int], ...]:
        """All (job, subfile) pairs stored on ``server``."""
        return tuple(
            (job, n)
            for job, t in self.stored_batches(server)
            for n in self.batch_subfiles(t)
        )

    def storage_fraction(self, server: int) -> float:
        """Measured mu for one server; equals (k-1)/K for every server."""
        total = self.design.J * self.N
        return len(self.stored_subfiles(server)) / total

    # ------------------------------------------------------------------ #
    def holders(self, job: int, t: int) -> tuple[int, ...]:
        """Servers storing batch ``t`` of ``job`` (= owners minus label)."""
        lab = self.batch_owner_label(job, t)
        return tuple(s for s in self.design.owners[job] if s != lab)

    def validate(self) -> None:
        d = self.design
        for j in range(d.J):
            # label map is a bijection onto owners
            labs = {self.batch_owner_label(j, t) for t in range(d.k)}
            assert labs == set(d.owners[j])
            for t in range(d.k):
                assert len(self.holders(j, t)) == d.k - 1
        mus = {self.storage_fraction(s) for s in range(d.K)}
        assert all(abs(m - d.storage_fraction) < 1e-12 for m in mus)

    def placement_matrix(self) -> np.ndarray:
        """Boolean (K, J, N) matrix: stored[s, j, n]. For tests/benchmarks."""
        d = self.design
        M = np.zeros((d.K, d.J, self.N), dtype=bool)
        for s in range(d.K):
            for j, n in self.stored_subfiles(s):
                M[s, j, n] = True
        return M


def make_placement(design: ResolvableDesign, gamma: int = 1,
                   label_perm=None) -> Placement:
    if label_perm is not None:
        label_perm = tuple(tuple(p) for p in label_perm)
    return Placement(design=design, gamma=gamma, label_perm=label_perm)
