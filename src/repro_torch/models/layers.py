"""Layer primitives of the dense, SSM and hybrid decoders (plain
functions on tensors).

Counterparts of ``repro.models.layers``: ``dense``, ``rms_norm``,
``rope``, ``attention_block`` (training, contiguous KV cache and paged
KV cache), ``mlp_block`` and the Mamba2 ``ssm_block`` (training through
the plain differentiable ``ref.ssd_chunked``, prefill through
``ops.ssd``, the ``ssd_scan`` kernel on a card, and the single-step
decode recurrence). Activations are ``x [B, T, D]``; attention
works on ``[B, H, T, Dh]``. Products of two same-dtype tensors
accumulate in f32 inside ``torch.matmul``; mixed dtypes go through f32
explicitly.

Training attention is the JAX package's XLA lane
(:func:`repro_torch.kernels.ops.plain_attention`): the materialized
``flash_attention_ref`` up to ``Tq*Tk = 2**21`` (``seq_len`` 1448), the
chunked ``flash_attention_chunked`` past it; a gradient never passes
through the kernel. A prefill over a cache goes through
``ops.attention``: the ``flash_attention`` kernel on a card at any
length. Training's SSD scan is likewise the plain chunked form (the JAX
package's XLA lane, ``use_pallas=False``), chosen by the mode: no
kernel has a backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import ssd_chunked
from ..kernels.ssd_scan import CHUNK

__all__ = ["dense", "rms_norm", "rope", "attention_block", "mlp_block",
           "softplus", "ssm_block"]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == w.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: [B, H, T, Dh]; positions: [B, T] or [T]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freq        # [B, 1, T, h]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _decode_attention(q, k, v, cache, rows, **kw):
    """A decode step's attention (``T == 1``), one row at a time: row
    ``b`` writes its k/v at position ``rows[b]`` and attends over exactly
    its ``rows[b] + 1`` valid keys, read back in logical order — the same
    shapes and values from a contiguous cache and from a paged one. A row
    at ``-1`` (finished), and a row past ``rows`` (the step's padding),
    writes nothing and gives 0."""
    out = torch.zeros_like(q)
    hkv, dh = k.shape[1], k.shape[3]
    kc, vc = cache["k"], cache["v"]
    for b, i in enumerate(rows):
        if i < 0:
            continue
        if "pages" in cache:
            ps = kc.shape[2]
            pt = cache["pages"][b, :i // ps + 1].long()
            kc[pt[-1:], :, i % ps] = k[b:b + 1, :, 0]
            vc[pt[-1:], :, i % ps] = v[b:b + 1, :, 0]
            kk, vv = (c[pt].transpose(0, 1).reshape(1, hkv, -1, dh)
                      for c in (kc, vc))
        else:
            kc[b, :, i] = k[b, :, 0]
            vc[b, :, i] = v[b, :, 0]
            kk, vv = kc[b:b + 1], vc[b:b + 1]
        out[b:b + 1] = ops.attention(
            q[b:b + 1], kk[:, :, :i + 1].contiguous(),
            vv[:, :, :i + 1].contiguous(), valid_len=i + 1, **kw)
    return out


def attention_block(p, x, positions, cfg, *, window=None, softcap=None,
                    causal=True, cache=None, cache_index=None):
    """Self-attention with GQA and RoPE; returns ``(out, new_cache)``.

    * ``cache=None`` (training): the plain attention (materialized up to
      ``seq_len`` 1448, chunked past it); ``new_cache`` is None.
    * contiguous cache ``{"k", "v": [B, Hkv, Tmax, Dh]}``, prefill (``T >
      1``): the k/v are written at ``cache_index`` (an int) and the step
      attends over its fresh ``(k, v)`` through
      :func:`repro_torch.kernels.ops.attention` (the ``flash_attention``
      kernel on a card, at any length; on the CPU the plain version up to
      1448 tokens and the chunked lane past it).
    * decode (``T == 1``), over the contiguous cache or the paged one
      ``{"k", "v": [P, Hkv, page, Dh], "pages": i32[B, npp]}``:
      ``cache_index`` is an int (every row at one position) or host ints,
      one per row (``-1``: a finished row); see
      :func:`_decode_attention`. ``x`` may hold more rows than the cache
      (a decode step's padding); they give 0.

    The caches are updated in place (the JAX package returns new
    arrays); ``new_cache`` is the same dict.
    """
    B, T, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(x, p["wq"]).reshape(B, T, hq, dh).transpose(1, 2)
    k = dense(x, p["wk"]).reshape(B, T, hkv, dh).transpose(1, 2)
    v = dense(x, p["wv"]).reshape(B, T, hkv, dh).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kw = dict(causal=causal, window=window, softcap=softcap)

    if cache is None:
        out = ops.plain_attention(q, k, v, **kw)
    elif T == 1:
        rows = (cache_index if isinstance(cache_index, list)
                else [int(cache_index)] * cache["k"].shape[0])
        out = _decode_attention(q, k, v, cache, rows, **kw)
    elif "pages" in cache:
        raise ValueError("paged cache entries are decode-only (T == 1)")
    else:
        i = int(cache_index)
        cache["k"][:, :, i:i + T] = k
        cache["v"][:, :, i:i + T] = v
        out = ops.attention(q, k, v, **kw)
    out = out.transpose(1, 2).reshape(B, T, hq * dh)
    return dense(out, p["wo"]), cache


def mlp_block(p, x, cfg):
    """SwiGLU / GEGLU (``jax.nn.gelu``'s default is the tanh form)."""
    if cfg.mlp_act == "geglu":
        gate = F.gelu(dense(x, p["w_gate"]), approximate="tanh")
    else:
        gate = F.silu(dense(x, p["w_gate"]))
    return dense(gate * dense(x, p["w_up"]), p["w_down"])


# --------------------------------------------------------------------- #
# Mamba2 block (SSD core + gating)
# --------------------------------------------------------------------- #
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))`` at every x; ``torch.nn.functional.softplus``
    returns ``x`` itself above its threshold of 20 instead."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def ssm_block(p, x, cfg, *, state=None, rows=None, return_state=False,
              train=False):
    """Mamba2 SSD block, the twin of ``repro.models.layers.ssm_block``;
    returns ``(out, new_state)``.

    * ``train`` (no state; training under autograd): the plain chunked
      scan :func:`repro_torch.kernels.ref.ssd_chunked` in chunks of
      :data:`~repro_torch.kernels.ssd_scan.CHUNK` on any device — the
      JAX package's XLA lane, which ``jax.grad`` differentiates; the
      ``ssd_scan`` kernel has no backward and is never called.
    * ``state=None`` (prefill): the scan through
      :func:`repro_torch.kernels.ops.ssd` (the ``ssd_scan`` kernel on a
      card); with ``return_state`` also the final state ``[B, H, S, P]``
      in JAX's closed form ``h_T = sum_s exp(cum_T - cum_s) b_s x_s^T``
      (f32, outside the kernel, as JAX computes it), else None.
    * ``state`` given (decode, ``T == 1``): the cache's ``[Bc, H, S, P]``
      f32 state rows, ``Bc <= B``; ``rows`` holds one host position per
      cache row (``-1``: a finished row). The recurrence runs at the
      width of ``x`` (a decode step's ``lm.DECODE_ROWS``): the cache rows
      are copied into a ``[B, H, S, P]`` buffer whose pad rows are zero,
      and only the live rows are written back, in place (a finished row
      writes nothing). Rows are independent, so a finished row's stale
      state changes no live row's bits; the row selection stays on the
      host (a device index would cost a blocking copy per layer).
      ``new_state`` is ``state``.
    """
    B, T, _ = x.shape
    H, S = cfg.ssm_heads, cfg.ssm_state
    P = cfg.ssm_d_inner // H
    u = dense(x, p["w_in"]).reshape(B, T, H, P)
    z = dense(x, p["w_gate"])                                # [B, T, di]
    bc = dense(x, p["w_bc"])                                 # [B, T, 2S]
    b, c = bc[..., :S], bc[..., S:]                          # [B, T, S]
    dt = softplus(dense(x, p["w_dt"]).float())               # [B, T, H]
    a = -torch.exp(p["a_log"])[None, None, :] * dt           # log-decay < 0
    xin = u * dt[..., None].to(u.dtype)

    if state is None:
        y = (ssd_chunked(xin, a, b, c, chunk=CHUNK) if train
             else ops.ssd(xin, a, b, c))
        new_state = None
        if return_state:
            cum = torch.cumsum(a, dim=1)                     # [B, T, H]
            w = torch.exp(cum[:, -1:, :] - cum)
            new_state = torch.einsum("bth,bts,bthp->bhsp", w, b.float(),
                                     xin.float())
    else:
        Bc = state.shape[0]
        st = torch.zeros((B, H, S, P), dtype=torch.float32, device=x.device)
        st[:Bc] = state
        at = torch.exp(a[:, 0]).float()                      # [B, H]
        st = (st * at[..., None, None]
              + b[:, 0].float()[:, None, :, None]
              * xin[:, 0].float()[:, :, None, :])
        y = torch.einsum("bs,bhsp->bhp", c[:, 0].float(),
                         st)[:, None].to(x.dtype)
        live = [i for i, r in enumerate(rows) if r >= 0]
        if len(live) == Bc:
            state.copy_(st[:Bc])
        else:
            for i in live:
                state[i] = st[i]
        new_state = state
    y = y + xin * p["skip"][None, None, :, None].to(u.dtype)
    y = y.reshape(B, T, H * P) * F.silu(z)
    return dense(y, p["w_out"]), new_state
