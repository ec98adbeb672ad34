"""Blockwise attention with an online softmax (CUDA,
``csrc/flash_attention.cu``).

Counterpart of the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention``: causal and sliding-
window masks, GQA, gemma2's logit softcap, queries right-aligned against
the keys (``1 <= Tq <= Tk`` under a causal or window mask; any ``Tq``
without one, where every key is visible: an encoder, a cross-attention),
f32 softmax state, a row with no visible key written as 0, output in q's
dtype (f32 or bf16). Forward only, as in
the JAX package: the serving prefill calls it (through
:func:`repro_torch.kernels.ops.attention`), training never does, so an
input that requires grad is refused.

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); a tensor on
``"meta"`` takes the cost twin: the same checks, output and scratch
(the f32 split workspace) as on a card, no launch, the call's work
charged to :mod:`.cost` (as a card's call is); a CUDA tensor launches
the kernel or raises: bf16 takes the tensor-core body (wgmma
fed by a TMA K/V ring), f32 the CUDA-core body (register tiles fed by a
cp.async K/V ring), and neither falls back to the other. An f32 call
with few query tiles splits each tile's keys across blocks
(:func:`split_plan`); the wrapper then allocates the f32 workspace of
the splits' partials, and a second kernel merges them in split order.
``flash_attention.launches`` counts the wrapper's launches, one a call
whatever the splits, and ``flash_attention.launches_by_dtype`` splits
that count by the dtype (the body) of the call.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes

from . import _build, cost
from .ref import flash_attention_ref

__all__ = ["flash_attention", "split_plan", "HEAD_DIMS"]

#: head dims both bodies are instantiated for: the JAX zoo's 64
#: (granite, seamless), 80 (zamba2), 128 (internlm2, internvl2, mistral,
#: mixtral, moonshot) and 256 (gemma2), and the 16 and 32 of the tests'
#: ``ATTN_CASES``
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: dtype -> C entry point: bf16 the tensor-core body, f32 the CUDA-core one
_LAUNCHERS = {torch.float32: "flash_attention_f32",
              torch.bfloat16: "flash_attention_bf16"}
_MAX_Q_TILES = 65535            # gridDim.y of either body: 64 query rows a tile
#: query rows of a block of the f32 body (a tile of :func:`split_plan`)
F32_ROWS = 64
#: a split of the f32 body covers whole chunks of this many keys
SPLIT_KEYS = 128
#: (query tile, split) blocks a (b, head) aims at: a call with fewer
#: query tiles splits each tile's keys, at most into its chunks
SPLIT_TILES = 8


def split_plan(Tq: int, Tk: int, causal: bool,
               window: int | None) -> list[list[tuple[int, int]]]:
    """The f32 body's key ranges: for each 64-query tile, ``n_splits``
    ranges ``[kbeg, kend)`` that cover the tile's visible keys (those any
    of its rows sees, queries right-aligned) in order, each of whole
    :data:`SPLIT_KEYS` chunks from the range's start (the last one cut
    at its end; a split past it is empty). ``n_splits`` is
    ``ceil(SPLIT_TILES / n_qtiles)``, cut to what the longest range
    fills: one from 8 query tiles on. The plan depends on ``Tq``, ``Tk``
    and the masks alone, never on the batch, the heads or the card, so
    a row's bits do not depend on the batch it is in."""
    shift = Tk - Tq
    spans = []
    for q0 in range(0, Tq, F32_ROWS):
        q1 = min(q0 + F32_ROWS, Tq) - 1
        hi = min(Tk, q1 + shift + 1) if causal else Tk
        lo = max(0, q0 + shift - window + 1) if window else 0
        spans.append((lo, hi))
    chunks = max(-(-(hi - lo) // SPLIT_KEYS) for lo, hi in spans)
    n = max(1, min(chunks, -(-SPLIT_TILES // len(spans))))
    per = -(-chunks // n)                # chunks a split
    n = -(-chunks // per)                # the longest range leaves none empty
    per *= SPLIT_KEYS
    return [[(min(lo + s * per, hi), min(lo + (s + 1) * per, hi))
             for s in range(n)] for lo, hi in spans]


@functools.lru_cache(maxsize=256)
def _device_plan(Tq, Tk, causal, window, device):
    """:func:`split_plan` as an int32 ``[n_qtiles, n_splits, 2]`` tensor
    on ``device`` (copied once per shape) and its ``n_splits``. The copy
    is a constant of the shape, kept across calls, so no dispatch mode
    sees it: a step counted under one (the dry run) counts the same
    whether or not an earlier call made the constant."""
    plan = split_plan(Tq, Tk, causal, window)
    with _disable_current_modes():
        return len(plan[0]), torch.tensor(plan,
                                          dtype=torch.int32).to(device)


def _f32_split(q, k, causal, window):
    """The f32 body's split arguments for q ``[B, Hq, Tq, D]`` over k:
    ``(n_splits, plan, acc, ml)``, the plan on q's device and, with more
    than one split, the workspace of the partial sums ``acc [B * Hq,
    n_splits, Tq, D]`` and of ``m, l`` (``ml [B * Hq, n_splits, Tq,
    2]``), else ``None``s."""
    B, Hq, Tq, D = q.shape
    n, plan = _device_plan(Tq, k.shape[2], bool(causal), window or None,
                           q.device)
    if n == 1:
        return n, plan, None, None
    acc = torch.empty((B * Hq, n, Tq, D), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((B * Hq, n, Tq, 2), dtype=torch.float32,
                     device=q.device)
    return n, plan, acc, ml


def _check(q, k, v, causal, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B, Hq, Tq, D] and k, v "
                         f"[B, Hkv, Tk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if Tq < 1 or Tk < 1 or (Tq > Tk and (causal or window is not None)):
        raise ValueError(f"flash_attention: queries are right-aligned "
                         f"against the keys, so a causal or window mask "
                         f"needs 1 <= Tq <= Tk; got Tq={Tq}, Tk={Tk}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    for t in (q, k, v):
        if t.requires_grad:
            raise RuntimeError("flash_attention has no backward (the JAX "
                               "kernel has none either); the training lane "
                               "takes the plain attention")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last axis is contiguous and its base address
    and the strides of its other axes are multiples of 16 bytes (the f32
    body's float4 loads, the bf16 body's TMA maps; the stride of an axis
    of extent 1 is never used), else a contiguous copy."""
    size = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0
                    for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q ``[B, Hq, Tq, D]``; k, v ``[B, Hkv, Tk, D]`` -> ``[B, Hq, Tq, D]``.

    Inputs may be strided views (the last axis contiguous); on a card
    the output is a ``[B, Tq, Hq, D]`` buffer seen as ``[B, Hq, Tq, D]``,
    so ``out.transpose(1, 2).reshape(B, Tq, Hq * D)`` is free.
    """
    _check(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise RuntimeError(f"flash_attention: tensors must lie on the CPU "
                           f"(plain version), a CUDA device or meta (cost "
                           f"twin), got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: all tensors must be on {q.device}")
    if q.dtype not in _LAUNCHERS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32 or "
                        f"bfloat16 q, k and v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or -(-Tq // F32_ROWS) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention: head dim {D} (kernel: "
                         f"{HEAD_DIMS}) or Tq={Tq} out of range")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, Tq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Tq, Tk, D, strides,
            float(D ** -0.5 if scale is None else scale),
            float(softcap or 0.0), int(bool(causal)), int(window or 0)]
    if q.dtype == torch.float32:
        n_splits, plan, acc, ml = _f32_split(q, k, causal, window)
        args += [plan.data_ptr(), n_splits,
                 None if acc is None else acc.data_ptr(),
                 None if ml is None else ml.data_ptr()]
    work = cost.flash_attention(B, Hq, Hkv, Tq, Tk, D, causal, window,
                                q.element_size())
    if q.device.type == "meta":
        cost.charge("flash_attention", work)
        return out
    fn = _LAUNCHERS[q.dtype]
    lib = _build.load("flash_attention")
    code = getattr(lib, fn)(*args,
                            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, fn, code)
    cost.charge("flash_attention", work)
    flash_attention.launches += 1
    flash_attention.launches_by_dtype[str(q.dtype)[6:]] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_dtype = {"float32": 0, "bfloat16": 0}
