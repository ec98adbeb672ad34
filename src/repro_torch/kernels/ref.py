"""Plain-PyTorch versions of the hand-written kernels.

Each has the kernel's signature, with the leading virtual-device axis
``K`` the stacked executor gives every codec tensor. The wrappers in
:mod:`.xor_code` and :mod:`.aggregate` take these for tensors on the
CPU; the tests hold them against the JAX package's Pallas kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.

``flash_attention_ref`` is the materialized attention of the JAX
package's ``repro.kernels.ref.flash_attention_ref``, the plain version
of the ``flash_attention`` kernel (:mod:`.flash_attention`);
``flash_attention_chunked`` is that package's chunked online-softmax
lane (``repro.kernels.ref.flash_attention_chunked``), which its XLA lane
takes for long sequences and the port's training lane takes with it.
``ssd_chunked`` is the chunked matmul form of the Mamba2 SSD scan
(``repro.kernels.ref.ssd_chunked``), the plain version of the
``ssd_scan`` kernel (:mod:`.ssd_scan`); ``ssd_scan_ref``, the sequential
recurrence, is the oracle both are held to.

Wire words are 32-bit patterns. ``torch.int32`` is the working view
(bitwise identical to ``uint32``; XOR, gathers and ``where`` never look
at the sign), and ``uint32`` inputs are viewed as ``int32`` here. The
packed 16-bit lane works on ``torch.int16`` lanes the same way.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["xor_encode_ref", "xor_fold_ref", "xor_decode_ref",
           "xor_encode_gather_ref", "xor_decode_gather_ref",
           "xor_encode_gather16_ref", "xor_decode_gather16_ref",
           "aggregate_ref", "flash_attention_ref", "flash_attention_chunked",
           "ssd_chunked",
           "ssd_scan_ref", "as_words", "as_lanes"]


def as_words(x: torch.Tensor) -> torch.Tensor:
    """u32/i32 wire words -> their ``int32`` view (no copy)."""
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    raise TypeError(f"XOR word lane expects uint32/int32, got {x.dtype}")


def as_lanes(x: torch.Tensor) -> torch.Tensor:
    """u16/i16 packed-lane values -> their ``int16`` view (no copy)."""
    if x.dtype == torch.int16:
        return x
    if x.dtype == torch.uint16:
        return x.view(torch.int16)
    raise TypeError(f"XOR 16-bit lane expects uint16/int16, got {x.dtype}")


def check_even_lanes(name: str, lanes: int) -> None:
    """Two 16-bit lanes make one u32 wire word: a packet row holds an
    even lane count (``repro.kernels.xor_code.xor_encode_gather16``)."""
    if lanes % 2:
        raise ValueError(f"{name}: packed packet lane count must be even, "
                         f"got {lanes}")


def xor_encode_ref(packets: torch.Tensor) -> torch.Tensor:
    """The Algorithm-2 Δ: XOR-fold ``packets [m, n]`` words over axis 0
    -> ``[n]`` in the dtype of ``packets``."""
    return xor_fold_ref(packets[None])[0]


def xor_fold_ref(packets: torch.Tensor) -> torch.Tensor:
    """Batched encode: ``[R, m, n]`` words -> ``[R, n]``, XOR over axis 1
    (one ``[R, n]`` temporary at a time, never a copy of the input)."""
    words = as_words(packets)
    acc = torch.zeros((words.shape[0], words.shape[2]), dtype=torch.int32,
                      device=words.device)
    for i in range(words.shape[1]):
        acc ^= words[:, i]
    return acc.view(packets.dtype)


def xor_decode_ref(recv: torch.Tensor, packets: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Batched decode: ``recv [R, n] ^ XOR_i packets[:, i] where
    mask[:, i]`` (packets ``[R, m, n]``, mask ``bool[R, m]``) -> ``[R, n]``
    in the dtype of ``packets``."""
    acc = as_words(recv).clone()
    words = as_words(packets)
    for i in range(words.shape[1]):
        acc ^= torch.where(mask[:, i, None], words[:, i], 0)
    return acc.view(packets.dtype)


def _masked_fold(chunks, idx, mask, acc):
    """``acc ^= XOR_j chunks[v, idx[v, :, j]] where mask`` (per device v)."""
    dev = torch.arange(chunks.shape[0], device=chunks.device)[:, None]
    idx = idx.long()
    for j in range(idx.shape[-1]):
        rows = chunks[dev, idx[..., j]]                     # [K, n, pk]
        acc = acc ^ torch.where(mask[..., j, None], rows, 0)
    return acc


def xor_encode_gather_ref(chunks: torch.Tensor, idx: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """``out[v, i] = XOR_j chunks[v, idx[v, i, j]] & mask[v, i, j]``.

    chunks ``[K, P, pk]`` words, idx ``i32[K, n, m]``, mask
    ``bool[K, n, m]`` -> ``[K, n, pk]`` in the dtype of ``chunks``.
    """
    words = as_words(chunks)
    K, n = idx.shape[:2]
    acc = torch.zeros((K, n, words.shape[2]), dtype=torch.int32,
                      device=words.device)
    return _masked_fold(words, idx, mask, acc).view(chunks.dtype)


def xor_decode_gather_ref(recv: torch.Tensor, chunks: torch.Tensor,
                          rsel: torch.Tensor, idx: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """``out[v, i] = recv[v, rsel[v, i]] ^ XOR_j chunks[v, idx[v, i, j]]
    & mask[v, i, j]`` (recv ``[K, Rr, pk]``, rsel ``i32[K, rows]``)."""
    words = as_words(chunks)
    dev = torch.arange(recv.shape[0], device=recv.device)[:, None]
    acc = as_words(recv)[dev, rsel.long()]                  # [K, rows, pk]
    return _masked_fold(words, idx, mask, acc).view(chunks.dtype)


def xor_encode_gather16_ref(chunks: torch.Tensor, idx: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """:func:`xor_encode_gather_ref` over 16-bit lanes: chunks
    ``[K, P, 2pk]`` u16/i16, idx/mask ``[K, n, m]`` -> ``[K, n, 2pk]`` in
    the dtype of ``chunks``."""
    lanes = as_lanes(chunks)
    check_even_lanes("xor_encode_gather16", lanes.shape[2])
    K, n = idx.shape[:2]
    acc = torch.zeros((K, n, lanes.shape[2]), dtype=torch.int16,
                      device=lanes.device)
    return _masked_fold(lanes, idx, mask, acc).view(chunks.dtype)


def xor_decode_gather16_ref(recv: torch.Tensor, chunks: torch.Tensor,
                            rsel: torch.Tensor, idx: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """:func:`xor_decode_gather_ref` over 16-bit lanes (recv
    ``[K, Rr, 2pk]``, chunks ``[K, P, 2pk]``)."""
    lanes = as_lanes(chunks)
    check_even_lanes("xor_decode_gather16", lanes.shape[2])
    dev = torch.arange(recv.shape[0], device=recv.device)[:, None]
    acc = as_lanes(recv)[dev, rsel.long()]                  # [K, rows, 2pk]
    return _masked_fold(lanes, idx, mask, acc).view(chunks.dtype)


def aggregate_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """The paper's alpha-combiner: ``out[s] = sum of values[r]`` over rows
    with ``segment_ids[r] == s``, accumulated in f32 from 0.0 in
    ascending row order; ids outside ``[0, num_segments)`` drop.
    values ``[n, d]`` -> ``[num_segments, d]`` in the values' dtype."""
    n, d = values.shape
    out = torch.zeros((num_segments, d), dtype=torch.float32,
                      device=values.device)
    for r, s in enumerate(segment_ids.tolist()):
        if 0 <= s < num_segments:
            out[s] += values[r].float()
    return out.to(values.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None,
                        valid_len=None) -> torch.Tensor:
    """Materialized attention: q ``[B, Hq, Tq, D]``, k/v ``[B, Hkv, Tk, D]``
    (GQA in grouped form, ``Hq % Hkv == 0``) -> ``[B, Hq, Tq, D]`` in the
    dtype of ``q``; logits and softmax in f32.

    ``window``: keys in ``(i - window, i]``; ``softcap``: ``cap *
    tanh(s / cap)``; queries are right-aligned, the last one at position
    ``end - 1`` with ``end = Tk`` or ``valid_len``, and keys at or past
    ``end`` are masked (the kernel's ``k_pos < Tk``). ``valid_len`` is an
    int, a 0-d tensor or a ``[B]`` tensor (each batch row its own
    length: ragged decode over a paged cache). A row with no visible key
    gets the softmax of equal logits, as the JAX reference gives it.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    qg = q.reshape(B, Hkv, rep, Tq, D).float()
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    dev = q.device
    if valid_len is None or not torch.is_tensor(valid_len):
        # a host int: filled on the device (a host copy would block)
        end = torch.full((1,), Tk if valid_len is None else int(valid_len),
                         dtype=torch.int64, device=dev)
    else:
        end = valid_len.to(dev).long().reshape(-1)
    end = end[:, None, None]                                 # [B|1, 1, 1]
    qpos = torch.arange(Tq, device=dev)[None, :, None] + (end - Tq)
    kpos = torch.arange(Tk, device=dev)[None, None, :]
    mask = kpos < end                                        # [B|1, Tq, Tk]
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def _chunk_step(m, l, acc, qblk, kx, vx, start: int, qpos, end: int,
                causal: bool, window, softcap):
    """One K/V block of :func:`flash_attention_chunked`'s online softmax:
    the running max ``m``, sum ``l`` and output ``acc`` ``[B, H, bq, 1|D]``
    (f32) after the keys ``start .. start + bk``."""
    s = torch.matmul(qblk.float(), kx.float().transpose(-1, -2))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = start + torch.arange(kx.shape[2], device=kx.device)
    mask = kpos[None, :] < end
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask, s, -1e30)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(p.to(vx.dtype).float(), vx.float())
    return m_new, l, acc


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None,
                            scale: float | None = None,
                            valid_len: int | None = None,
                            block_q: int = 1024,
                            block_k: int = 1024) -> torch.Tensor:
    """Chunked attention, differentiable: the JAX package's
    ``flash_attention_chunked`` step for step (q ``[B, Hq, Tq, D]``, k/v
    ``[B, Hkv, Tk, D]`` -> ``[B, Hq, Tq, D]`` in q's dtype).

    Queries go in blocks of ``block_q`` (left-padded, keeping the right
    alignment), keys in blocks of ``block_k`` (right-padded, masked); a
    query block visits only the K blocks its causal and window masks
    leave visible, and a block with none is 0. Within a query block an
    online softmax (f32 max, sum and output) runs over the K blocks; K/V
    are broadcast over the GQA group, masked scores are ``-1e30``, and
    the output is ``acc / where(l == 0, 1, l)``. Each block step runs
    under ``torch.utils.checkpoint``, as JAX's runs under
    ``jax.checkpoint``: the backward pass recomputes a block's ``[bq,
    bk]`` scores instead of keeping every block's probabilities.
    """
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    tq_pad = -(-Tq // bq) * bq
    tk_pad = -(-Tk // bk) * bk
    end = Tk if valid_len is None else int(valid_len)
    qp = torch.nn.functional.pad(q, (0, 0, tq_pad - Tq, 0))
    kp = torch.nn.functional.pad(k, (0, 0, 0, tk_pad - Tk))
    vp = torch.nn.functional.pad(v, (0, 0, 0, tk_pad - Tk))
    if rep > 1:
        kp = kp[:, :, None].expand(B, Hkv, rep, tk_pad, D).reshape(
            B, Hq, tk_pad, D)
        vp = vp[:, :, None].expand(B, Hkv, rep, tk_pad, D).reshape(
            B, Hq, tk_pad, D)
    qg = qp * torch.tensor(scale, dtype=qp.dtype, device=qp.device)
    dev = q.device
    outs = []
    for qi in range(tq_pad // bq):
        qblk = qg[:, :, qi * bq:(qi + 1) * bq]
        qpos = qi * bq + torch.arange(bq, device=dev) + (end - tq_pad)
        # static block schedule (conservative: uses Tk, not valid_len)
        q_last = qi * bq + bq - 1 + (Tk - tq_pad)
        q_first = qi * bq + (Tk - tq_pad)
        lo, hi = 0, tk_pad // bk
        if causal:
            hi = min(hi, q_last // bk + 1)
        if window is not None:
            lo = max(lo, (q_first - window + 1) // bk)
        lo = max(min(lo, hi), 0)
        if hi <= lo:
            outs.append(torch.zeros((B, Hq, bq, D), dtype=torch.float32,
                                    device=dev))
            continue
        m = torch.full((B, Hq, bq, 1), -1e30, device=dev)
        l = torch.zeros((B, Hq, bq, 1), device=dev)
        acc = torch.zeros((B, Hq, bq, D), device=dev)
        for kb in range(lo, hi):
            m, l, acc = checkpoint(
                _chunk_step, m, l, acc, qblk, kp[:, :, kb * bk:(kb + 1) * bk],
                vp[:, :, kb * bk:(kb + 1) * bk], kb * bk, qpos, end, causal,
                window, softcap, use_reentrant=False)
        outs.append(acc / torch.where(l == 0.0, 1.0, l))
    out = torch.cat(outs, dim=2)
    return out[:, :, tq_pad - Tq:].to(q.dtype)


def _per_head(b: torch.Tensor, H: int, acc: torch.dtype) -> torch.Tensor:
    """SSD ``b``/``c`` as ``[B, T, H, S]`` in ``acc``: group-shared ``[B,
    T, S]`` broadcast over the heads (a view), per-head taken as they
    are."""
    b = b.to(acc)
    return b[:, :, None].expand(-1, -1, H, -1) if b.dim() == 3 else b


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """Mamba2 SSD in the chunked matmul form of ``repro.kernels.ref.
    ssd_chunked`` / the Pallas ``ssd_scan``: x ``[B, T, H, P]``, a ``[B, T,
    H]`` (log-decay), b and c group-shared ``[B, T, S]`` or per-head
    ``[B, T, H, S]`` -> y ``[B, T, H, P]`` in x's dtype; f32 inside (f64
    for f64 inputs: the accuracy yardstick of ``chip_smoke.py``).

    Per chunk of ``chunk`` steps, with ``cum`` the in-chunk cumulative sum
    of ``a``: ``y = tril(c b^T * exp(cum_t - cum_s)) x + exp(cum_t) c h``
    and ``h <- exp(cum_end) h + sum_s exp(cum_end - cum_s) b_s x_s^T``, the
    f32 ``[S, P]`` state carried across chunks. The last chunk may be
    short (the same values as padding with ``a = 0, x = 0``). The decay
    ratio is exponentiated only where ``s <= t``, so nothing overflows.
    """
    B, T, H, P = x.shape
    if b.dim() not in (3, 4) or c.shape != b.shape:
        raise ValueError(f"ssd: b and c must both be [B, T, S] or "
                         f"[B, T, H, S], got {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    acc = torch.promote_types(x.dtype, torch.float32)
    bh, ch = _per_head(b, H, acc), _per_head(c, H, acc)
    S = bh.shape[-1]
    h = torch.zeros((B, H, S, P), dtype=acc, device=x.device)
    ys = []
    for t0 in range(0, T, chunk):
        xc = x[:, t0:t0 + chunk].to(acc)                    # [B, C, H, P]
        bc, cc = bh[:, t0:t0 + chunk], ch[:, t0:t0 + chunk]  # [B, C, H, S]
        C = xc.shape[1]
        cum = torch.cumsum(a[:, t0:t0 + chunk].to(acc), dim=1)  # [B, C, H]
        tri = torch.ones((C, C), dtype=torch.bool,
                         device=x.device).tril()[None, :, :, None]
        expo = torch.where(tri, cum[:, :, None] - cum[:, None], -torch.inf)
        cb = torch.einsum("bchs,bkhs->bckh", cc, bc)        # [B, C, C, H]
        y = (torch.exp(cum)[..., None]
             * torch.einsum("bchs,bhsp->bchp", cc, h)
             + torch.einsum("bckh,bkhp->bchp", cb * torch.exp(expo), xc))
        ys.append(y)
        w = torch.exp(cum[:, -1:] - cum)                     # [B, C, H]
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + torch.einsum("bchs,bch,bchp->bhsp", bc, w, xc))
    return torch.cat(ys, dim=1).to(x.dtype)


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """The SSD oracle, ``repro.kernels.ref.ssd_scan_ref``: the sequential
    recurrence ``h_t = exp(a_t) h_{t-1} + b_t x_t^T``, ``y_t = c_t^T h_t``
    (h ``[S, P]`` per head, f32), with b and c group-shared ``[B, T, S]``
    or per-head ``[B, T, H, S]``; y in x's dtype."""
    B, T, H, P = x.shape
    bh, ch = _per_head(b, H, torch.float32), _per_head(c, H, torch.float32)
    h = torch.zeros((B, H, bh.shape[-1], P), dtype=torch.float32,
                    device=x.device)
    decay = torch.exp(a.float())
    ys = []
    for t in range(T):
        h = (decay[:, t, :, None, None] * h
             + bh[:, t, :, :, None] * x[:, t, :, None, :].float())
        ys.append(torch.einsum("bhs,bhsp->bhp", ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)
