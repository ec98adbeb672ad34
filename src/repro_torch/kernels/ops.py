"""Dispatch entry points of the kernels, as the JAX package's
``repro.kernels.ops`` names them.

Each routes by the device of its input: the hand-written CUDA kernel for
a tensor on a card, its plain version for a tensor on the CPU (there is
no ``use_pallas`` switch: the device decides). ``attention`` and ``ssd``
are not defined here yet; they come with the slices that port
``flash_attention`` and ``ssd_scan`` (ROADMAP.md, Queue 1 items 2-3).
"""

from __future__ import annotations

import torch

from .aggregate import aggregate
from .xor_code import xor_encode

__all__ = ["combine_aggregates", "xor_fold"]


def combine_aggregates(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """The alpha-combiner of the CAMR map phase
    (:func:`repro_torch.kernels.aggregate.aggregate`)."""
    return aggregate(values, segment_ids, num_segments)


def xor_fold(packets: torch.Tensor) -> torch.Tensor:
    """The Algorithm-2 Δ encoder: ``u32|i32[m, n] -> [n]``
    (:func:`repro_torch.kernels.xor_code.xor_encode`)."""
    return xor_encode(packets)
