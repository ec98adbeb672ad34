"""XOR packet codec of the coded shuffle (CUDA, ``csrc/xor_gather.cu`` and
``csrc/xor_fold.cu``).

Counterparts of the JAX package's Pallas kernels in
``repro.kernels.xor_code``, in two families:

* the fused gathers ``xor_encode_gather`` / ``xor_decode_gather`` (u32
  wire words) and ``xor_encode_gather16`` / ``xor_decode_gather16`` (the
  packed 16-bit lane: bf16/f16 payloads as u16 lanes, two per wire word),
  with a leading virtual-device axis: one launch covers all ``K`` workers
  of the stacked executor (:mod:`repro_torch.core.collective`);
* the dense folds ``xor_fold`` / ``xor_decode`` of the multipass codec,
  over packet tables the caller has already gathered (rows of all ``K``
  workers stacked along their row axis), and ``xor_encode``, one row's
  fold (the Algorithm-2 Δ of :func:`repro_torch.kernels.ops.xor_fold`,
  launching the fold kernel with one row).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor
on ``"meta"`` takes the cost twin (the same checks and output as on a
card, no launch, the call's bytes charged to :mod:`.cost`, as a card's
call is); a CUDA tensor launches the kernel or raises. Each wrapper's
``launches`` attribute counts its kernel launches (and nothing else).
"""

from __future__ import annotations

import torch

from . import _build, cost
from .ref import (as_lanes, as_words, check_even_lanes, xor_decode_ref,
                  xor_decode_gather16_ref, xor_decode_gather_ref,
                  xor_encode_gather16_ref, xor_encode_gather_ref,
                  xor_encode_ref, xor_fold_ref)

__all__ = ["xor_encode_gather", "xor_decode_gather", "xor_encode_gather16",
           "xor_decode_gather16", "xor_fold", "xor_decode", "xor_encode"]

_MAX_SRC = 64          # kMaxSrc of csrc/xor_gather.cu and csrc/xor_fold.cu
_MAX_GRID_YZ = 65535


def _vec(row: int, widths, *tensors: torch.Tensor) -> int:
    """Widest access (in elements of ``tensors``, from ``widths``) that
    divides the row length and to which every base pointer is aligned."""
    size = tensors[0].element_size()
    for v in widths:
        if row % v == 0 and all(t.data_ptr() % (size * v) == 0
                                for t in tensors):
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
    """The device of a call that launches (``cuda``) or takes the cost
    twin (``meta``), its tensors checked."""
    dev = tensors[0].device
    if dev.type not in ("cuda", "meta"):
        raise RuntimeError(f"{name}: tensors must lie on the CPU (plain "
                           f"version), a CUDA device or meta (cost twin), "
                           f"got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def _check_grid(name, K, rows, m):
    if m > _MAX_SRC or rows > _MAX_GRID_YZ or K > _MAX_GRID_YZ:
        raise ValueError(f"{name}: m={m} (max {_MAX_SRC}), rows={rows} and "
                         f"K={K} (max {_MAX_GRID_YZ}) out of range")


#: per lane: the working view and the widths (elements) ``_vec`` may pass:
#: the u32 lane's access width; the 16-bit lane's alignment of every row
#: start (2 lanes: the body's 4-byte instantiation, which the training
#: step's tensors take; else 1, the 2-byte one), its accesses being 16
#: bytes at any phase
_WORD_LANE = (as_words, (4, 2))
_HALF_LANE = (as_lanes, (2,))


def _encode(fn, lane, ref_fn, chunks, idx, mask):
    name = fn.__name__
    view, widths = lane
    words = view(chunks)
    if words.dim() != 3:
        raise ValueError(f"{name}: chunks must be [K, P, row], got "
                         f"{tuple(chunks.shape)}")
    K, P, row = words.shape
    if view is as_lanes:
        check_even_lanes(name, row)
    _check_tables(name, K, None, idx, mask)
    if words.device.type == "cpu":
        return ref_fn(chunks, idx, mask)
    _cuda_ready(name, words, idx, mask)
    n, m = idx.shape[1:]
    _check_grid(name, K, n, m)
    out = torch.empty((K, n, row), dtype=words.dtype, device=words.device)
    work = cost.gather(K, n, m, row * words.element_size())
    if out.numel() and words.device.type == "meta":
        cost.charge(name, work)
    elif out.numel():
        lib = _build.load("xor_gather")
        code = getattr(lib, name)(
            words.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            out.data_ptr(), K, P, n, m, row, _vec(row, widths, words, out),
            torch.cuda.current_stream(words.device).cuda_stream)
        _build.check(lib, name, code)
        cost.charge(name, work)
        fn.launches += 1
    return out.view(chunks.dtype)


def _decode(fn, lane, ref_fn, recv, chunks, rsel, idx, mask):
    name = fn.__name__
    view, widths = lane
    words, rwords = view(chunks), view(recv)
    if words.dim() != 3 or rwords.dim() != 3:
        raise ValueError(f"{name}: recv and chunks must be [K, rows, row]")
    K, P, row = words.shape
    if rwords.shape[0] != K or rwords.shape[2] != row:
        raise ValueError(f"{name}: recv {tuple(recv.shape)} does not match "
                         f"chunks {tuple(chunks.shape)}")
    if view is as_lanes:
        check_even_lanes(name, row)
    rows = rsel.shape[1] if rsel.dim() == 2 else -1
    if rsel.dtype != torch.int32 or rsel.shape != (K, rows):
        raise ValueError(f"{name}: rsel must be int32 [K, rows], got "
                         f"{rsel.dtype} {tuple(rsel.shape)}")
    _check_tables(name, K, rows, idx, mask)
    if words.device.type == "cpu":
        return ref_fn(recv, chunks, rsel, idx, mask)
    _cuda_ready(name, words, rwords, rsel, idx, mask)
    m = idx.shape[2]
    _check_grid(name, K, rows, m)
    out = torch.empty((K, rows, row), dtype=words.dtype, device=words.device)
    work = cost.gather(K, rows, m, row * words.element_size(), recv_rows=1)
    if out.numel() and words.device.type == "meta":
        cost.charge(name, work)
    elif out.numel():
        lib = _build.load("xor_gather")
        code = getattr(lib, name)(
            rwords.data_ptr(), words.data_ptr(), rsel.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), out.data_ptr(), K, P,
            rwords.shape[1], rows, m, row,
            _vec(row, widths, words, rwords, out),
            torch.cuda.current_stream(words.device).cuda_stream)
        _build.check(lib, name, code)
        cost.charge(name, work)
        fn.launches += 1
    return out.view(chunks.dtype)


def xor_encode_gather(chunks: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Fused encode: ``out[v, i] = XOR_j {chunks[v, idx[v, i, j]] :
    mask[v, i, j]}``.

    chunks ``u32|i32[K, P, pk]`` (the flat packet view of each device's
    chunk buffer), idx ``i32[K, n, m]`` flat packet-row sources (masked
    entries carry an in-range index), mask ``bool[K, n, m]`` ->
    ``[K, n, pk]`` in the dtype of ``chunks``.
    """
    return _encode(xor_encode_gather, _WORD_LANE, xor_encode_gather_ref,
                   chunks, idx, mask)


def xor_decode_gather(recv: torch.Tensor, chunks: torch.Tensor,
                      rsel: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Fused decode + chunk-slot scatter: ``out[v, i] = recv[v, rsel[v, i]]
    ^ XOR_j {chunks[v, idx[v, i, j]] : mask[v, i, j]}``.

    recv ``[K, Rr, pk]`` received round packets, chunks ``[K, P, pk]``,
    rsel ``i32[K, rows]`` (``dec_recv`` of the lowering), idx/mask
    ``[K, rows, m]`` -> ``[K, rows, pk]`` in the dtype of ``chunks``.
    """
    return _decode(xor_decode_gather, _WORD_LANE, xor_decode_gather_ref,
                   recv, chunks, rsel, idx, mask)


def xor_encode_gather16(chunks: torch.Tensor, idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Packed-lane fused encode: :func:`xor_encode_gather` over 16-bit
    lanes. chunks ``u16|i16[K, P, 2pk]`` (the lane view of the padded
    bf16/f16 chunk buffers; the lane count must be even) -> ``[K, n,
    2pk]`` in the dtype of ``chunks``, whose ``int32`` view is the wire
    Δ ``[K, n, pk]``."""
    return _encode(xor_encode_gather16, _HALF_LANE, xor_encode_gather16_ref,
                   chunks, idx, mask)


def xor_decode_gather16(recv: torch.Tensor, chunks: torch.Tensor,
                        rsel: torch.Tensor, idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Packed-lane fused decode: :func:`xor_decode_gather` over 16-bit
    lanes (recv ``[K, Rr, 2pk]``: the received wire words viewed as lane
    pairs) -> ``[K, rows, 2pk]`` chunk-slot rows in 16-bit lanes."""
    return _decode(xor_decode_gather16, _HALF_LANE, xor_decode_gather16_ref,
                   recv, chunks, rsel, idx, mask)


def _fold(fn, packets, recv=None, mask=None):
    """Launch ``csrc/xor_fold.cu`` over the word view ``packets [R, m,
    n]``: its ``xor_decode`` entry given ``recv [R, n]`` and ``mask [R,
    m]``, else its ``xor_fold`` entry -> int32 words ``[R, n]``; the
    launch counts on ``fn``."""
    name = fn.__name__
    inputs = [t for t in (packets, recv, mask) if t is not None]
    _cuda_ready(name, *inputs)
    R, m, n = packets.shape
    _check_grid(name, 1, R, m)
    out = torch.empty((R, n), dtype=torch.int32, device=packets.device)
    work = cost.fold(R, m, n, decode=recv is not None)
    if out.numel() and packets.device.type == "meta":
        cost.charge(name, work)
    elif out.numel():
        lib = _build.load("xor_fold")
        vec = _vec(n, (4, 2), *inputs[:2], out)
        stream = torch.cuda.current_stream(packets.device).cuda_stream
        if recv is None:
            code = lib.xor_fold(packets.data_ptr(), out.data_ptr(), R, m, n,
                                vec, stream)
        else:
            code = lib.xor_decode(recv.data_ptr(), packets.data_ptr(),
                                  mask.data_ptr(), out.data_ptr(), R, m, n,
                                  vec, stream)
        _build.check(lib, name, code)
        cost.charge(name, work)
        fn.launches += 1
    return out


def _check_sources(name, m):
    if m < 1:
        raise ValueError(f"{name}: needs at least one packet per row, "
                         f"got m={m}")


def xor_fold(packets: torch.Tensor) -> torch.Tensor:
    """Batched encode: ``u32|i32[R, m, n] -> [R, n]``, XOR over axis 1 (row
    ``r`` is one coded group's packet set), in the dtype of ``packets``."""
    words = as_words(packets)
    if words.dim() != 3:
        raise ValueError(f"xor_fold: packets must be [R, m, n], got "
                         f"{tuple(packets.shape)}")
    _check_sources("xor_fold", words.shape[1])
    if words.device.type == "cpu":
        return xor_fold_ref(packets)
    return _fold(xor_fold, words).view(packets.dtype)


def xor_decode(recv: torch.Tensor, packets: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Batched decode (Lemma 2): ``recv ^ XOR_i packets[:, i] where
    mask[:, i]``. recv ``u32|i32[R, n]`` round broadcasts, packets
    ``[R, m, n]`` the locally recomputed cancellation packets, mask
    ``bool[R, m]`` -> ``[R, n]`` in the dtype of ``packets``; a masked-off
    packet is never read on the card."""
    words, rwords = as_words(packets), as_words(recv)
    if words.dim() != 3:
        raise ValueError(f"xor_decode: packets must be [R, m, n], got "
                         f"{tuple(packets.shape)}")
    R, m, n = words.shape
    if tuple(rwords.shape) != (R, n):
        raise ValueError(f"xor_decode: recv shape {tuple(recv.shape)} != "
                         f"{(R, n)}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (R, m):
        raise ValueError(f"xor_decode: mask must be bool {(R, m)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    _check_sources("xor_decode", m)
    if words.device.type == "cpu":
        return xor_decode_ref(recv, packets, mask)
    return _fold(xor_decode, words, rwords, mask).view(packets.dtype)


def xor_encode(packets: torch.Tensor) -> torch.Tensor:
    """The Algorithm-2 Δ of one server: ``u32|i32[m, n] -> [n]``, XOR over
    axis 0, in the dtype of ``packets`` (on the card the ``xor_fold``
    kernel over one row, counted here)."""
    words = as_words(packets)
    if words.dim() != 2:
        raise ValueError(f"xor_encode: packets must be [m, n], got "
                         f"{tuple(packets.shape)}")
    _check_sources("xor_encode", words.shape[0])
    if words.device.type == "cpu":
        return xor_encode_ref(packets)
    return _fold(xor_encode, words[None])[0].view(packets.dtype)


xor_encode_gather.launches = 0
xor_decode_gather.launches = 0
xor_encode_gather16.launches = 0
xor_decode_gather16.launches = 0
xor_fold.launches = 0
xor_decode.launches = 0
xor_encode.launches = 0
