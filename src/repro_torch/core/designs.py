"""Resolvable designs from single-parity-check (SPC) codes — paper §III.

The cluster of ``K = k * q`` servers is identified with the block set of a
resolvable design built from the (k, k-1) SPC code over Z_q; the ``J =
q**(k-1)`` jobs are identified with the point set.

Indexing conventions (0-based everywhere in code; the paper is 1-based):

* job   ``j``  in ``range(J)``   <-> codeword column ``j`` of ``T``
* server ``s`` in ``range(K)``   <-> block ``B[i, l]`` with ``i = s // q``
  (parallel-class index) and ``l = s % q`` (value index), matching the
  paper's convention ``U_i <-> B_{ceil(i/q), (i-1) mod q}``.

All structure needed by placement / shuffle is precomputed once and cached
on the :class:`ResolvableDesign` instance; everything is pure numpy so it
can run on the master node of a real deployment.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

__all__ = [
    "ResolvableDesign",
    "spc_codeword_table",
    "make_design",
    "factorize_cluster",
]


def spc_codeword_table(q: int, k: int) -> np.ndarray:
    """Codeword table ``T`` of the (k, k-1) SPC code over Z_q.

    Returns an array of shape ``(k, q**(k-1))``: column ``j`` is the j-th
    codeword ``c = [u, sum(u) mod q]`` where ``u`` enumerates Z_q^{k-1} in
    lexicographic order. Works for any integer ``q >= 2`` (Z_q need not be a
    field — paper footnote 1).
    """
    if q < 2 or k < 2:
        raise ValueError(f"need q >= 2 and k >= 2, got q={q}, k={k}")
    # Enumerate all messages u in Z_q^{k-1} lexicographically.
    J = q ** (k - 1)
    msgs = np.indices((q,) * (k - 1)).reshape(k - 1, J)
    parity = msgs.sum(axis=0) % q
    return np.concatenate([msgs, parity[None, :]], axis=0).astype(np.int64)


@dataclass(frozen=True, eq=False)  # identity hash: methods are lru_cached
class ResolvableDesign:
    """The (X_SPC, A_SPC) resolvable design of Lemma 1, plus the incidence
    structure used by the CAMR placement and shuffle.

    Attributes
    ----------
    q, k        cluster factorization ``K = k * q``
    T           codeword table, shape (k, J)
    blocks      ``blocks[s]`` = sorted job ids in the block of server ``s``
    owners      ``owners[j]`` = sorted server ids owning job ``j``
                (exactly one per parallel class, ascending class order)
    """

    q: int
    k: int
    T: np.ndarray = field(repr=False)

    # ------------------------------------------------------------------ #
    # basic parameters
    # ------------------------------------------------------------------ #
    @property
    def K(self) -> int:
        return self.k * self.q

    @property
    def J(self) -> int:
        return self.q ** (self.k - 1)

    @property
    def block_size(self) -> int:
        """|B_{i,l}| = q^{k-2} (Lemma 1)."""
        return self.q ** (self.k - 2)

    @property
    def storage_fraction(self) -> float:
        """mu = (k-1)/K (paper §III-A)."""
        return (self.k - 1) / self.K

    # ------------------------------------------------------------------ #
    # incidence structure
    # ------------------------------------------------------------------ #
    def server_of(self, cls: int, val: int) -> int:
        """Server id of block ``B_{cls, val}``."""
        return cls * self.q + val

    def class_of(self, server: int) -> int:
        """Parallel-class index of ``server``."""
        return server // self.q

    def value_of(self, server: int) -> int:
        """Symbol value ``l`` of the server's block ``B_{i,l}``."""
        return server % self.q

    @property
    def blocks(self) -> tuple[tuple[int, ...], ...]:
        """blocks[s] = tuple of job ids whose codeword has T[i, j] == l."""
        return self._blocks()

    @lru_cache(maxsize=None)
    def _blocks(self) -> tuple[tuple[int, ...], ...]:
        out = []
        for s in range(self.K):
            i, l = self.class_of(s), self.value_of(s)
            out.append(tuple(np.nonzero(self.T[i] == l)[0].tolist()))
        return tuple(out)

    @property
    def owners(self) -> tuple[tuple[int, ...], ...]:
        """owners[j] = the k servers owning job j, one per parallel class."""
        return self._owners()

    @lru_cache(maxsize=None)
    def _owners(self) -> tuple[tuple[int, ...], ...]:
        out = []
        for j in range(self.J):
            out.append(tuple(self.server_of(i, int(self.T[i, j]))
                             for i in range(self.k)))
        return tuple(out)

    def parallel_class(self, i: int) -> tuple[int, ...]:
        """P_i = the q servers (blocks) of class i."""
        return tuple(self.server_of(i, l) for l in range(self.q))

    @property
    def parallel_classes(self) -> tuple[tuple[int, ...], ...]:
        return tuple(self.parallel_class(i) for i in range(self.k))

    def is_owner(self, server: int, job: int) -> bool:
        i = self.class_of(server)
        return int(self.T[i, job]) == self.value_of(server)

    def owned_jobs(self, server: int) -> tuple[int, ...]:
        return self.blocks[server]

    # ------------------------------------------------------------------ #
    # stage-2 group enumeration
    # ------------------------------------------------------------------ #
    def stage2_groups(self) -> list[tuple[int, ...]]:
        """All groups (one block per parallel class, empty intersection).

        A group picks value ``v_i`` in each class i; its intersection is the
        set of codewords with T[i, j] == v_i for all i, which is non-empty
        iff ``v_k == sum(v_1..v_{k-1}) mod q`` (exactly one codeword then).
        Hence the q^{k-1}(q-1) groups are exactly the value tuples whose
        parity coordinate MISmatches the message parity.
        """
        groups = []
        for vals in itertools.product(range(self.q), repeat=self.k):
            if sum(vals[:-1]) % self.q != vals[-1]:
                groups.append(tuple(self.server_of(i, v)
                                    for i, v in enumerate(vals)))
        assert len(groups) == self.J * (self.q - 1)
        return groups

    def common_job(self, servers: tuple[int, ...]) -> int:
        """The unique job owned jointly by k-1 servers from distinct classes.

        For a stage-2 group G and excluded server s, ``common_job(G \\ {s})``
        is the job the remaining k-1 servers co-own (paper §III-C.2).
        """
        if len(servers) != self.k - 1:
            raise ValueError("need exactly k-1 servers")
        classes = [self.class_of(s) for s in servers]
        if len(set(classes)) != self.k - 1:
            raise ValueError("servers must lie in distinct parallel classes")
        vals = {c: self.value_of(s) for c, s in zip(classes, servers)}
        missing = next(i for i in range(self.k) if i not in vals)
        if missing == self.k - 1:
            # parity coordinate missing -> message fully known
            u = [vals[i] for i in range(self.k - 1)]
        else:
            # one message coordinate missing -> solve from parity
            par = vals[self.k - 1]
            known = sum(v for c, v in vals.items() if c != self.k - 1)
            u = [vals.get(i, (par - known) % self.q)
                 for i in range(self.k - 1)]
        # job id = lexicographic rank of the message vector
        j = 0
        for v in u:
            j = j * self.q + int(v)
        return j

    # ------------------------------------------------------------------ #
    # sanity
    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Check Lemma 1 properties exhaustively (used by tests)."""
        K, J = self.K, self.J
        for i in range(self.k):
            cls = self.parallel_class(i)
            pts: list[int] = []
            for s in cls:
                assert len(self.blocks[s]) == self.block_size
                pts.extend(self.blocks[s])
            assert sorted(pts) == list(range(J)), "class must partition X"
        for j in range(J):
            own = self.owners[j]
            assert len(own) == self.k
            assert len({self.class_of(s) for s in own}) == self.k
        assert sum(len(self.blocks[s]) for s in range(K)) == K * self.block_size


def make_design(q: int, k: int) -> ResolvableDesign:
    """Build the resolvable design for a ``K = k*q`` cluster."""
    return ResolvableDesign(q=q, k=k, T=spc_codeword_table(q, k))


def factorize_cluster(K: int, mu_target: float | None = None,
                      ) -> tuple[int, int]:
    """Pick (q, k) with K = k*q.

    If ``mu_target`` is given, choose the factorization whose storage
    fraction (k-1)/K is closest to it (used by elastic re-planning);
    otherwise choose the most balanced factorization with q >= 2, k >= 2.
    """
    cands = [(K // q, q) for q in range(2, K) if K % q == 0 and K // q >= 2]
    if not cands:
        raise ValueError(f"K={K} has no factorization with q,k >= 2")
    if mu_target is not None:
        k, q = min(cands, key=lambda kq: abs((kq[0] - 1) / K - mu_target))
    else:
        k, q = min(cands, key=lambda kq: abs(kq[0] - kq[1]))
    return q, k
