"""The alpha-combiner: batched segment-sum of map outputs (CUDA,
``csrc/aggregate.cu``).

Counterpart of the JAX package's Pallas kernel
``repro.kernels.aggregate.aggregate``. A tensor on the CPU goes to the
plain version in :mod:`.ref`; a CUDA tensor launches the kernel or
raises. ``aggregate.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import aggregate_ref

__all__ = ["aggregate"]


def aggregate(values: torch.Tensor, segment_ids: torch.Tensor,
              num_segments: int, *, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Segment-sum ``values: [n, d]`` by ``segment_ids: i32[n]`` ->
    ``[num_segments, d]``.

    Out-of-range ids (padding ``-1``) contribute nothing. Each segment is
    accumulated in f32 from 0.0 in ascending row order, so the result is
    deterministic and, when every segment holds one row (the trainer's
    gamma = 1 map lane), bit-transparent for finite values. ``out`` (f32,
    contiguous ``[num_segments, d]``) receives the result in place.
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
    if values.device.type != "cuda":
        raise RuntimeError(f"aggregate: tensors must lie on the CPU (plain "
                           f"version) or a CUDA device, got {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"aggregate: the CUDA kernel takes float32 values, "
                        f"got {values.dtype}")
    for t in (segment_ids, out):
        if t is not None and t.device != values.device:
            raise ValueError(f"aggregate: all tensors must be on "
                             f"{values.device}")
    values, segment_ids = values.contiguous(), segment_ids.contiguous()
    if out is None:
        out = torch.empty((S, d), dtype=torch.float32, device=values.device)
    if out.numel():
        lib = _build.load("aggregate")
        vec = 4 if (d % 4 == 0 and values.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0) else 1
        code = lib.aggregate_f32(
            values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            n, d, S, vec,
            torch.cuda.current_stream(values.device).cuda_stream)
        _build.check(lib, "aggregate_f32", code)
        aggregate.launches += 1
    return out


aggregate.launches = 0
