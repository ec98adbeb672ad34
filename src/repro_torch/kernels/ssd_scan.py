"""Mamba2 SSD chunked scan (CUDA, ``csrc/ssd_scan.cu``).

Counterpart of the JAX package's Pallas kernel
``repro.kernels.ssd_scan.ssd_scan``: the recurrence ``h_t = exp(a_t)
h_{t-1} + b_t x_t^T``, ``y_t = c_t^T h_t`` per (batch, head), evaluated
in chunks of :data:`CHUNK` steps with the f32 ``[S, P]`` state carried
across chunks; output in x's dtype (f32 or bf16), ``a`` in f32. ``b``
and ``c`` are group-shared ``[B, T, S]`` (the model's form, read with a
head stride of 0) or per-head ``[B, T, H, S]`` (the Pallas kernel's).
Forward only, as in the JAX package: every SSM prefill calls it
(through :func:`repro_torch.kernels.ops.ssd`); training never does (it
takes the plain chunked form, chosen by the mode in
:func:`repro_torch.models.layers.ssm_block`), so an input that requires
grad is refused.

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.ssd_chunked`); a tensor on ``"meta"``
takes the cost twin (the same checks, alignment copies and output as on
a card, no launch, the call's work charged to :mod:`.cost`, as a card's
call is); a CUDA tensor launches the kernel or raises: bf16 takes the
tensor-core body (wgmma fed by a TMA chunk ring, the f32 state in
registers), f32 the CUDA-core body, and neither falls back to the
other. ``ssd_scan.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, cost
from .ref import ssd_chunked

__all__ = ["ssd_scan", "CHUNK", "MAX_STATE"]

#: chunk length of the kernel (``kC`` in the source; mamba2's
#: ``ssm_chunk``)
CHUNK = 64
#: largest state size the kernel's shared memory holds (``kMaxS``)
MAX_STATE = 256
_LAUNCHERS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def _check(x, a, b, c):
    if x.dim() != 4 or a.dim() != 3 or b.dim() not in (3, 4) \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan: x must be [B, T, H, P], a [B, T, H] and "
                         f"b, c both [B, T, S] or [B, T, H, S], got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    B, T, H, _ = x.shape
    if tuple(a.shape) != (B, T, H) or tuple(b.shape[:2]) != (B, T) or (
            b.dim() == 4 and b.shape[2] != H):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, a {tuple(a.shape)} "
                         f"and b {tuple(b.shape)} differ in batch, length or "
                         f"heads")
    if T < 1:
        raise ValueError("ssd_scan: empty sequence")
    if x.dtype not in _LAUNCHERS or b.dtype != x.dtype or c.dtype != x.dtype \
            or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: the kernel takes float32 or bfloat16 x, b "
                        f"and c of one dtype and float32 a, got {x.dtype}, "
                        f"{b.dtype}, {c.dtype}, {a.dtype}")
    for t in (x, a, b, c):
        if t.requires_grad:
            raise RuntimeError("ssd_scan has no backward (the JAX kernel has "
                               "none either); training takes the plain "
                               "differentiable ref.ssd_chunked instead "
                               "(models.layers.ssm_block(train=True))")


def _bc_strides(t: torch.Tensor) -> tuple:
    """(b, t, h) element strides of b or c: a head stride of 0 for
    group-shared ``[B, T, S]``."""
    return (t.stride(0), t.stride(1), 0 if t.dim() == 3 else t.stride(2))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is contiguous and its base address
    and the strides of its other axes are multiples of 16 bytes (the bf16
    body's TMA maps; the stride of an axis of extent 1 is never used),
    else a copy in a buffer whose last axis is zero-padded to a multiple
    of 16 bytes, seen through a view of ``t``'s shape (the kernel never
    reads the padding)."""
    size = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0
                    for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)):
        return t
    n = t.shape[-1]
    buf = t.new_zeros((*t.shape[:-1], -(-n * size // 16) * 16 // size))
    buf[..., :n] = t
    return buf[..., :n]


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """x ``[B, T, H, P]``, a ``[B, T, H]`` (log-decay), b and c ``[B, T,
    S]`` or ``[B, T, H, S]`` -> y ``[B, T, H, P]`` in x's dtype.

    Inputs may be strided views with their last axis contiguous (the
    model's ``b``/``c`` are column slices of one projection)."""
    _check(x, a, b, c)
    if x.device.type == "cpu":
        return ssd_chunked(x, a, b, c, chunk=CHUNK)
    if x.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"ssd_scan: tensors must lie on the CPU (plain "
                           f"version), a CUDA device or meta (cost twin), "
                           f"got {x.device}")
    if any(t.device != x.device for t in (a, b, c)):
        raise ValueError(f"ssd_scan: all tensors must be on {x.device}")
    B, T, H, P = x.shape
    S = b.shape[-1]
    if S > MAX_STATE:
        raise ValueError(f"ssd_scan: state size {S} > {MAX_STATE}")
    if x.dtype == torch.bfloat16:
        x, b, c = _aligned(x), _aligned(b), _aligned(c)
    else:
        x, b, c = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (x, b, c))
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    work = cost.ssd_scan(B, T, H, P, S, x.element_size(), b.dim() == 4,
                         CHUNK)
    if x.device.type == "meta":
        cost.charge("ssd_scan", work)
        return y
    strides = (ctypes.c_longlong * 12)(
        *x.stride()[:3], *a.stride(), *_bc_strides(b), *_bc_strides(c))
    fn = _LAUNCHERS[x.dtype]
    lib = _build.load("ssd_scan")
    code = getattr(lib, fn)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        B, T, H, P, S, strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, fn, code)
    cost.charge("ssd_scan", work)
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
