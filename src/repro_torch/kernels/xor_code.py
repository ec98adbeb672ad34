"""Fused gather-XOR codec of the coded shuffle (CUDA, ``csrc/xor_gather.cu``).

Counterparts of the JAX package's Pallas kernels
``repro.kernels.xor_code.xor_encode_gather`` / ``xor_decode_gather``,
with a leading virtual-device axis: one launch covers all ``K`` workers
of the stacked executor (:mod:`repro_torch.core.collective`).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises. Each wrapper's ``launches``
attribute counts its kernel launches (and nothing else).
"""

from __future__ import annotations

import torch

from . import _build
from .ref import as_words, xor_decode_gather_ref, xor_encode_gather_ref

__all__ = ["xor_encode_gather", "xor_decode_gather"]

_MAX_SRC = 64          # kMaxSrc of csrc/xor_gather.cu
_MAX_GRID_YZ = 65535


def _vec(pk: int, *tensors: torch.Tensor) -> int:
    """Widest vector access (u32 words) every row start allows."""
    for v in (4, 2):
        if pk % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def _check_tables(name, K, rows, idx, mask):
    if (idx.dtype != torch.int32 or idx.dim() != 3
            or idx.shape[0] != K or rows not in (None, idx.shape[1])):
        raise ValueError(f"{name}: idx must be int32 [{K}, rows, m], got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if mask.dtype != torch.bool or mask.shape != idx.shape:
        raise ValueError(f"{name}: mask must be bool {tuple(idx.shape)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")


def _cuda_ready(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: tensors must lie on the CPU (plain "
                           f"version) or a CUDA device, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def xor_encode_gather(chunks: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Fused encode: ``out[v, i] = XOR_j {chunks[v, idx[v, i, j]] :
    mask[v, i, j]}``.

    chunks ``u32|i32[K, P, pk]`` (the flat packet view of each device's
    chunk buffer), idx ``i32[K, n, m]`` flat packet-row sources (masked
    entries carry an in-range index), mask ``bool[K, n, m]`` ->
    ``[K, n, pk]`` in the dtype of ``chunks``.
    """
    words = as_words(chunks)
    if words.dim() != 3:
        raise ValueError(f"xor_encode_gather: chunks must be [K, P, pk], got "
                         f"{tuple(chunks.shape)}")
    K, P, pk = words.shape
    _check_tables("xor_encode_gather", K, None, idx, mask)
    if words.device.type == "cpu":
        return xor_encode_gather_ref(chunks, idx, mask)
    _cuda_ready("xor_encode_gather", words, idx, mask)
    n, m = idx.shape[1:]
    if m > _MAX_SRC or n > _MAX_GRID_YZ or K > _MAX_GRID_YZ:
        raise ValueError(f"xor_encode_gather: m={m} (max {_MAX_SRC}), n={n} "
                         f"and K={K} (max {_MAX_GRID_YZ}) out of range")
    out = torch.empty((K, n, pk), dtype=torch.int32, device=words.device)
    if out.numel():
        lib = _build.load("xor_gather")
        vec = _vec(pk, words, out)
        code = lib.xor_encode_gather(
            words.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            out.data_ptr(), K, P, n, m, pk, vec,
            torch.cuda.current_stream(words.device).cuda_stream)
        _build.check(lib, "xor_encode_gather", code)
        xor_encode_gather.launches += 1
    return out.view(chunks.dtype)


def xor_decode_gather(recv: torch.Tensor, chunks: torch.Tensor,
                      rsel: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Fused decode + chunk-slot scatter: ``out[v, i] = recv[v, rsel[v, i]]
    ^ XOR_j {chunks[v, idx[v, i, j]] : mask[v, i, j]}``.

    recv ``[K, Rr, pk]`` received round packets, chunks ``[K, P, pk]``,
    rsel ``i32[K, rows]`` (``dec_recv`` of the lowering), idx/mask
    ``[K, rows, m]`` -> ``[K, rows, pk]`` in the dtype of ``chunks``.
    """
    words, rwords = as_words(chunks), as_words(recv)
    if words.dim() != 3 or rwords.dim() != 3:
        raise ValueError("xor_decode_gather: recv and chunks must be "
                         "[K, rows, pk]")
    K, P, pk = words.shape
    if rwords.shape[0] != K or rwords.shape[2] != pk:
        raise ValueError(f"xor_decode_gather: recv {tuple(recv.shape)} does "
                         f"not match chunks {tuple(chunks.shape)}")
    rows = rsel.shape[1] if rsel.dim() == 2 else -1
    if rsel.dtype != torch.int32 or rsel.shape != (K, rows):
        raise ValueError(f"xor_decode_gather: rsel must be int32 [K, rows], "
                         f"got {rsel.dtype} {tuple(rsel.shape)}")
    _check_tables("xor_decode_gather", K, rows, idx, mask)
    if words.device.type == "cpu":
        return xor_decode_gather_ref(recv, chunks, rsel, idx, mask)
    _cuda_ready("xor_decode_gather", words, rwords, rsel, idx, mask)
    m = idx.shape[2]
    if m > _MAX_SRC or rows > _MAX_GRID_YZ or K > _MAX_GRID_YZ:
        raise ValueError(f"xor_decode_gather: m={m} (max {_MAX_SRC}), "
                         f"rows={rows} and K={K} (max {_MAX_GRID_YZ}) out "
                         "of range")
    out = torch.empty((K, rows, pk), dtype=torch.int32, device=words.device)
    if out.numel():
        lib = _build.load("xor_gather")
        vec = _vec(pk, words, rwords, out)
        code = lib.xor_decode_gather(
            rwords.data_ptr(), words.data_ptr(), rsel.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), out.data_ptr(), K, P,
            rwords.shape[1], rows, m, pk, vec,
            torch.cuda.current_stream(words.device).cuda_stream)
        _build.check(lib, "xor_decode_gather", code)
        xor_decode_gather.launches += 1
    return out.view(chunks.dtype)


xor_encode_gather.launches = 0
xor_decode_gather.launches = 0
