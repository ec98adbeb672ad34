"""Dispatch entry points of the kernels, as the JAX package's
``repro.kernels.ops`` names them.

Each routes by the device of its input: the hand-written CUDA kernel for
a tensor on a card, its plain version for a tensor on the CPU (there is
no ``use_pallas`` switch: the device decides).
"""

from __future__ import annotations

import torch

from .aggregate import aggregate
from .flash_attention import flash_attention
from .ref import flash_attention_chunked, flash_attention_ref
from .ssd_scan import ssd_scan
from .xor_code import xor_encode

__all__ = ["attention", "plain_attention", "ssd", "combine_aggregates",
           "xor_fold", "CHUNK_THRESHOLD"]

#: Tq*Tk past which the plain lane switches from the materialized
#: attention to the chunked one (the JAX package's ``_CHUNK_THRESHOLD``:
#: from ``seq_len`` 1449 on)
CHUNK_THRESHOLD = 2 ** 21


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """The JAX package's XLA attention lane with every key valid,
    differentiable: the materialized :func:`~.ref.flash_attention_ref` up
    to :data:`CHUNK_THRESHOLD` scores, the chunked
    :func:`~.ref.flash_attention_chunked` past it (the training lane on
    any device, and a CPU prefill past the switch point)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.shape[2] * k.shape[2] > CHUNK_THRESHOLD:
        return flash_attention_chunked(q, k, v, **kw)
    return flash_attention_ref(q, k, v, **kw)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              valid_len=None) -> torch.Tensor:
    """Attention with the routing of ``repro.kernels.ops.attention``.

    ``valid_len is None`` (a prefill over its own fresh keys, an
    encoder, a cross-attention over its cached memory): the
    ``flash_attention`` kernel for a CUDA tensor at any length; on the
    CPU its plain version up to :data:`CHUNK_THRESHOLD` scores and the
    chunked lane past it, as the JAX package's XLA lane routes. Inputs
    of mixed dtypes (an enc-dec model's bf16 queries over the f32 k/v of
    f32 audio frames) go through the kernel in the widest of them (bf16
    to f32 is exact), the output rounded to q's dtype: the JAX
    reference's upcast of all three. ``valid_len`` given (a decode step
    over a partly filled cache, ``Tq`` ~ 1): the plain masked attention
    on any device, as the JAX package keeps that lane outside Pallas;
    its score matrix is only ``[B, H, Tq, Tk]``.
    """
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if valid_len is None:
        if (q.device.type == "cpu"
                and q.shape[2] * k.shape[2] > CHUNK_THRESHOLD):
            return flash_attention_chunked(q, k, v, **kw)
        if q.dtype == k.dtype == v.dtype:
            return flash_attention(q, k, v, **kw)
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        return flash_attention(q.to(dt), k.to(dt), v.to(dt),
                               **kw).to(q.dtype)
    return flash_attention_ref(q, k, v, valid_len=valid_len, **kw)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor) -> torch.Tensor:
    """The Mamba2 SSD scan with the routing of ``repro.kernels.ops.ssd``
    under ``use_pallas``: the ``ssd_scan`` kernel for a CUDA tensor, its
    plain chunked version on the CPU, both in chunks of 64 (mamba2's
    ``ssm_chunk``). ``b``/``c`` group-shared ``[B, T, S]`` are read in
    place with a head stride of 0, never broadcast over the heads; per-
    head ``[B, T, H, S]`` are taken as they are."""
    return ssd_scan(x, a, b, c)


def combine_aggregates(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """The alpha-combiner of the CAMR map phase
    (:func:`repro_torch.kernels.aggregate.aggregate`)."""
    return aggregate(values, segment_ids, num_segments)


def xor_fold(packets: torch.Tensor) -> torch.Tensor:
    """The Algorithm-2 Δ encoder: ``u32|i32[m, n] -> [n]``
    (:func:`repro_torch.kernels.xor_code.xor_encode`)."""
    return xor_encode(packets)
