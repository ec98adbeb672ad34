"""The work of each hand-written kernel: its FLOPs and the bytes it must
move, from its shapes alone.

Each function returns ``(flops, bytes)`` for one call: FLOPs the
floating-point operations the call must do on its inputs (a product's
multiply-add counts 2; the XOR kernels do none), bytes each input read
once and each output written once. They are the formulas of the Bound
column of ``PERF.md`` and of ``chip_smoke.py``'s bounds. Every kernel
wrapper charges its call to the counters open in :func:`counting`, on a
card where it launches and on ``"meta"`` where it only allocates its
outputs and scratch (the dry run's cost twin), so a step counts the
same work on the card as in the dry run. A call on the CPU runs the
plain version and is charged nothing here: a counter of aten ops
counts its ops.

A counter is no launch count: ``launches`` on each wrapper stays the
number of kernels a card ran.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field

import numpy as np

__all__ = ["KernelCount", "counting", "charge", "visible_pairs",
           "flash_attention", "ssd_scan", "aggregate", "gather", "fold"]

_ACTIVE: list["KernelCount"] = []


@dataclass
class KernelCount:
    """The kernels' work charged while it was open: totals, and per
    kernel ``{"calls", "flops", "bytes"}``."""
    flops: int = 0
    bytes: int = 0
    by_kernel: dict = field(default_factory=dict)

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        k = self.by_kernel.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes


@contextlib.contextmanager
def counting():
    """Open a :class:`KernelCount`; every kernel call on a card or on
    ``"meta"`` until the block ends is charged to it (and to any other
    counter open around it)."""
    c = KernelCount()
    _ACTIVE.append(c)
    try:
        yield c
    finally:
        _ACTIVE.remove(c)


def charge(name: str, work: tuple[int, int]) -> None:
    """Charge one call's ``(flops, bytes)`` to every open counter."""
    for c in _ACTIVE:
        c.add(name, *work)


@functools.lru_cache(maxsize=1024)
def visible_pairs(Tq: int, Tk: int, causal: bool,
                  window: int | None) -> int:
    """(query, key) pairs the masks leave visible, per (batch, head):
    queries right-aligned against the keys (query ``i`` at key position
    ``Tk - Tq + i``), a causal mask keeping keys at or before it, a
    window the ``window`` latest of those."""
    qpos = np.arange(Tq, dtype=np.int64) + (Tk - Tq)
    hi = np.minimum(qpos + 1, Tk) if causal else np.full(Tq, Tk)
    lo = (np.maximum(qpos - window + 1, 0) if window
          else np.zeros(Tq, np.int64))
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(B: int, Hq: int, Hkv: int, Tq: int, Tk: int, D: int,
                    causal: bool, window: int | None,
                    itemsize: int) -> tuple[int, int]:
    """``flash_attention``: ``q k^T`` and ``p v`` over the visible pairs
    only (``4 D`` FLOPs a pair and head; the softmax's exponentials are
    not counted); q, k, v and the output in the call's dtype."""
    flops = 4 * B * Hq * D * visible_pairs(Tq, Tk, causal, window)
    nbytes = itemsize * D * (2 * B * Hq * Tq + 2 * B * Hkv * Tk)
    return flops, nbytes


def ssd_scan(B: int, T: int, H: int, P: int, S: int, itemsize: int,
             per_head_bc: bool, chunk: int = 64) -> tuple[int, int]:
    """``ssd_scan``: per head and step the chunked form's products (c
    b^T over the chunk, the masked decay times x, c h and the state
    update: ``C*S + C*P + 2*S*P`` multiply-adds at chunk ``C``); x and y
    in the call's dtype, a in f32, b and c in x's dtype, group-shared
    ``[B, T, S]`` or per head ``[B, T, H, S]``."""
    flops = 2 * B * H * T * (chunk * S + chunk * P + 2 * S * P)
    bc = B * T * S * (H if per_head_bc else 1)
    nbytes = 2 * itemsize * B * T * H * P + 4 * B * T * H + 2 * itemsize * bc
    return flops, nbytes


def aggregate(n: int, d: int, S: int, itemsize: int) -> tuple[int, int]:
    """``aggregate``: one f32 add per value (``n * d``); the values and
    their i32 segment ids read, ``[S, d]`` written."""
    return n * d, itemsize * (n * d + S * d) + 4 * n


def gather(K: int, rows: int, m: int, row_bytes: int,
           recv_rows: int = 0) -> tuple[int, int]:
    """The fused XOR gathers (u32 words or 16-bit lanes): no FLOPs; each
    of the ``rows x m`` source slots of the ``K`` devices read once
    (masked or not: the mask lies on the device), the index and mask
    tables, the selected ``recv`` row of each output row
    (``recv_rows`` 1 for a decode) and each output row written."""
    slots = K * rows * m
    return 0, (row_bytes * (slots + K * rows * (1 + recv_rows))
               + 5 * slots + 4 * K * rows * recv_rows)


def fold(R: int, m: int, n: int, decode: bool = False) -> tuple[int, int]:
    """The dense XOR folds ``[R, m, n] -> [R, n]`` (u32 words): no
    FLOPs; the packets read, the output written, and for ``xor_decode``
    the received words and the ``[R, m]`` bool mask read."""
    nbytes = 4 * R * m * n + 4 * R * n
    if decode:
        nbytes += 4 * R * n + R * m
    return 0, nbytes
