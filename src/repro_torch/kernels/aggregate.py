"""The alpha-combiner: batched segment-sum of map outputs (CUDA,
``csrc/aggregate.cu``).

Counterpart of the JAX package's Pallas kernel
``repro.kernels.aggregate.aggregate``, for f32 values (``aggregate_f32``)
and bf16 values (``aggregate_bf16``, the memo rows of the bf16 grad-sync
lane). A tensor on the CPU goes to the plain version in :mod:`.ref`; a
tensor on ``"meta"`` takes the cost twin (the output, no launch, the
call's work charged to :mod:`.cost`, as a card's call is); a CUDA
tensor launches the kernel of its dtype or raises. ``aggregate``
counts its f32 launches, ``aggregate_bf16`` its bf16 launches.
"""

from __future__ import annotations

import torch

from . import _build, cost
from .ref import aggregate_ref

__all__ = ["aggregate", "aggregate_bf16"]

#: values dtype -> (C entry point, columns per 16-byte access)
_LAUNCHERS = {torch.float32: ("aggregate_f32", 4),
              torch.bfloat16: ("aggregate_bf16", 8)}


def aggregate(values: torch.Tensor, segment_ids: torch.Tensor,
              num_segments: int, *, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Segment-sum ``values: [n, d]`` by ``segment_ids: i32[n]`` ->
    ``[num_segments, d]`` in the values' dtype.

    Out-of-range ids (padding ``-1``) contribute nothing. Each segment is
    accumulated in f32 from 0.0 in ascending row order and rounded once to
    the values' dtype, so the result is deterministic and, when every
    segment holds one row (the trainer's gamma = 1 map lane),
    bit-transparent for finite values. ``out`` (contiguous
    ``[num_segments, d]`` in the values' dtype) receives the result in
    place. On a card, f32 values launch the f32 kernel (counted here) and
    bf16 values the bf16 kernel (counted on :func:`aggregate_bf16`).
    """
    if values.dim() != 2:
        raise ValueError(f"aggregate: values must be [n, d], got "
                         f"{tuple(values.shape)}")
    n, d = values.shape
    if segment_ids.dtype != torch.int32 or segment_ids.shape != (n,):
        raise ValueError(f"aggregate: segment_ids must be int32 [{n}], got "
                         f"{segment_ids.dtype} {tuple(segment_ids.shape)}")
    S = int(num_segments)
    if out is not None and (out.shape != (S, d) or out.dtype != values.dtype
                            or not out.is_contiguous()):
        raise ValueError(f"aggregate: out must be contiguous {values.dtype} "
                         f"[{S}, {d}]")
    if values.device.type == "cpu":
        res = aggregate_ref(values, segment_ids, S)
        return res if out is None else out.copy_(res)
    if values.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"aggregate: tensors must lie on the CPU (plain "
                           f"version), a CUDA device or meta (cost twin), "
                           f"got {values.device}")
    if values.dtype not in _LAUNCHERS:
        raise TypeError(f"aggregate: the CUDA kernels take float32 or "
                        f"bfloat16 values, got {values.dtype}")
    for t in (segment_ids, out):
        if t is not None and t.device != values.device:
            raise ValueError(f"aggregate: all tensors must be on "
                             f"{values.device}")
    values, segment_ids = values.contiguous(), segment_ids.contiguous()
    if out is None:
        out = torch.empty((S, d), dtype=values.dtype, device=values.device)
    name = "aggregate" if values.dtype == torch.float32 else "aggregate_bf16"
    if values.device.type == "meta":
        if out.numel():
            cost.charge(name, cost.aggregate(n, d, S, values.element_size()))
        return out
    if out.numel():
        fn, wide = _LAUNCHERS[values.dtype]
        lib = _build.load("aggregate")
        vec = wide if (d % wide == 0 and values.data_ptr() % 16 == 0
                       and out.data_ptr() % 16 == 0) else 1
        code = getattr(lib, fn)(
            values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            n, d, S, vec,
            torch.cuda.current_stream(values.device).cuda_stream)
        _build.check(lib, fn, code)
        cost.charge(name, cost.aggregate(n, d, S, values.element_size()))
        counter = aggregate if values.dtype == torch.float32 else \
            aggregate_bf16
        counter.launches += 1
    return out


def aggregate_bf16(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, *, out: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """:func:`aggregate` of bf16 values (f32 sums, one round-to-nearest-
    even on the store); its ``launches`` count the bf16 kernel's."""
    if values.dtype != torch.bfloat16:
        raise TypeError(f"aggregate_bf16: values must be bfloat16, got "
                        f"{values.dtype}")
    return aggregate(values, segment_ids, num_segments, out=out)


aggregate.launches = 0
aggregate_bf16.launches = 0
