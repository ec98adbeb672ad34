"""Layer primitives of the dense, MoE, SSM, hybrid and enc-dec models
(plain functions on tensors).

Counterparts of ``repro.models.layers``: ``dense``, ``rms_norm``,
``layer_norm`` (which, as in JAX, no model calls), ``rope``,
``attention_block`` (training, contiguous KV cache, paged KV cache, and
the cross-attention of the enc-dec family),
``mlp_block``, ``moe_block`` (top-k routing and a capacity-bounded
dispatch, with or without a virtual mesh) and the Mamba2 ``ssm_block``
(training through
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
through the kernel. A prefill goes through ``ops.attention`` (its
self-attention over a cache, and an enc-dec model's encoder and
cross-attention, which the caller marks ``train=False``): the
``flash_attention`` kernel on a card at any length. Training's SSD
scan is likewise the plain chunked form (the JAX package's XLA lane,
``use_pallas=False``), chosen by the mode: no kernel has a backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import ssd_chunked
from ..kernels.ssd_scan import CHUNK

__all__ = ["dense", "rms_norm", "layer_norm", "rope", "attention_block",
           "mlp_block", "moe_capacity", "moe_block", "softplus",
           "ssm_block"]


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in f32 over the last axis (biased variance, as
    ``jnp.var``), scaled and shifted, in ``x``'s dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


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


def _decode_attention_device(q, k, v, cache, index, **kw):
    """A decode step's attention with every row at the device-side
    position ``index`` (an i32 0-d tensor) of the contiguous cache: each
    row's k/v written there in place, then the plain masked attention
    over the whole cache with the keys past ``index`` masked (JAX's
    ``dynamic_update_slice`` and ``valid_len = cache_index + 1``); no
    value goes to the host."""
    pos = index.reshape(1).long()
    cache["k"].index_copy_(2, pos, k)
    cache["v"].index_copy_(2, pos, v)
    return ops.attention(q, cache["k"], cache["v"], valid_len=index + 1,
                         **kw)


def attention_block(p, x, positions, cfg, *, window=None, softcap=None,
                    causal=True, cache=None, cache_index=None, memory=None,
                    train=True):
    """Self-attention with GQA and RoPE, or cross-attention over
    ``memory [B, Ts, D]``; returns ``(out, new_cache)``.

    * ``cache=None``: with ``train`` (training) the plain attention
      (materialized up to ``seq_len`` 1448, chunked past it); without
      (an enc-dec prefill's encoder and cross-attention, which keep no
      self cache) :func:`repro_torch.kernels.ops.attention`, the
      ``flash_attention`` kernel on a card; ``new_cache`` is None.
    * ``memory`` given (cross-attention, ``cache=None``): k and v come
      from the memory, neither q nor k is rotated and every key is
      visible; ``new_cache`` is the memory's ``{"k", "v": [B, Hkv, Ts,
      Dh]}`` in the memory's dtype (a prefill stores them as its cross
      cache).
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
      (a decode step's padding); they give 0. A 0-d tensor
      ``cache_index`` (the step builders' device lane, contiguous cache
      only) puts every row at that position: see
      :func:`_decode_attention_device`.

    The caches are updated in place (the JAX package returns new
    arrays); ``new_cache`` is the same dict.
    """
    B, T, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if memory is None else memory
    Ts = src.shape[1]
    q = dense(x, p["wq"]).reshape(B, T, hq, dh).transpose(1, 2)
    k = dense(src, p["wk"]).reshape(B, Ts, hkv, dh).transpose(1, 2)
    v = dense(src, p["wv"]).reshape(B, Ts, hkv, dh).transpose(1, 2)
    if memory is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kw = dict(causal=causal and memory is None, window=window,
              softcap=softcap)

    if cache is None:
        out = (ops.plain_attention if train else ops.attention)(q, k, v,
                                                                **kw)
        if memory is not None:
            cache = {"k": k, "v": v}
    elif T == 1 and torch.is_tensor(cache_index):
        if "pages" in cache:
            raise ValueError("a device-side cache_index takes a contiguous "
                             "cache")
        out = _decode_attention_device(q, k, v, cache, cache_index, **kw)
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
# MoE (top-k routing, capacity-bounded dispatch)
# --------------------------------------------------------------------- #
def moe_capacity(cfg, n: int) -> int:
    """Slots per expert for a block of ``n`` tokens (GShard capacity, at
    least 4); assignments past it are dropped."""
    return max(int(cfg.moe_capacity_factor * n * cfg.experts_per_token
                   / cfg.n_experts), 4)


def _top_k(gates: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest in descending order, a tie going
    to the lower index (``torch.topk`` promises no order among equals;
    bf16 router logits tie often over 64 experts)."""
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _moe_route(p, xf, cfg, n: int):
    """The router of a token block ``xf [..., M, D]`` whose first ``n``
    rows are tokens (the rest a decode step's padding): gates (f32
    softmax of the router logits rounded to the model dtype) ``[..., n,
    E]``, the renormalised top-k weights and experts ``[..., n, k]``, and
    per assignment in token-major order ``[..., n*k]`` its expert, its
    slot (the exclusive count of earlier assignments to that expert) and
    whether it fits ``moe_capacity(cfg, n)``. The logits, softmax and
    sort run at all ``M`` rows, so a row's values do not depend on
    ``n``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    gates = torch.softmax(dense(xf, p["router"]).float(), dim=-1)
    gates = gates[..., :n, :]
    w, idx = _top_k(gates, k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    eidx = idx.flatten(-2)
    onehot = F.one_hot(eidx, E)
    pos = (onehot.cumsum(-2) - onehot).gather(-1, eidx[..., None])[..., 0]
    return gates, w, idx, eidx, pos, pos < moe_capacity(cfg, n)


def _expert_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A batched expert product, f32 accumulation, in ``a``'s dtype."""
    if a.dtype == w.dtype:
        return torch.matmul(a, w)
    return torch.matmul(a.float(), w.float()).to(a.dtype)


def _moe_dispatch_compute(p, xf, cfg, ep_replicated: bool = False, *,
                          n_tokens: int | None = None):
    """Dispatch and expert FFN of a flat token block, the twin of
    ``repro.models.layers._moe_dispatch_compute``; returns ``(out, (me,
    ce))``.

    * ``xf [M, D]`` (no mesh): ``p``'s expert leaves are whole
      (``[E, d, f]``). ``n_tokens`` (default ``M``) real tokens lead the
      block: capacity and slots count those only, the rest (a decode
      step's padding to ``lm.DECODE_ROWS``) take no slot and give 0. The
      expert buffer has ``moe_capacity(cfg, M)`` rows an expert whatever
      ``n_tokens`` is, so a decode step's products run at one shape.
    * ``xf [n_data, n_model, M, D]``: JAX's ``shard_map`` body (with
      ``n_model`` and ``axis_name`` read from the device axes) for every
      device of a virtual mesh at once, along two leading device axes.
      ``p``'s expert leaves carry the model shards along a leading axis
      (:func:`_moe_shards`). ``ep``: the tiled ``all_to_all`` ``[E, cap,
      D] -> [E/n, n*cap, D]`` is a swap of the source-device and
      expert-block axes, and back; ``ep_replicated`` (the same tokens on
      every model shard): each shard serves its own experts, then a sum
      over the model axis (``psum``); ``tp``: each shard's d_ff slice,
      then a sum over the model axis.

    Dropped assignments go to a trash row of the buffer and are masked
    to 0 in the gather (JAX adds zeros to slot ``(E-1, cap-1)``).
    ``me`` and ``ce`` (f32 ``[..., E]``) are the mean gate and the share
    of tokens whose top-1 expert is each expert.
    """
    E, k = cfg.n_experts, cfg.experts_per_token
    mesh = xf.dim() == 4
    n_model = xf.shape[1] if mesh else 1
    lead, (M, D) = xf.shape[:-2], xf.shape[-2:]
    G = math.prod(lead)
    n = M if n_tokens is None else n_tokens
    gates, w, idx, eidx, pos, keep = _moe_route(p, xf, cfg, n)
    cap, slots = moe_capacity(cfg, n), moe_capacity(cfg, M)
    sharded = n_model > 1
    ep = sharded and cfg.moe_shard_mode == "ep" and not ep_replicated
    ep_rep = sharded and cfg.moe_shard_mode == "ep" and ep_replicated
    tp = sharded and cfg.moe_shard_mode == "tp"
    n_e = E // n_model if ep_rep else E
    if ep_rep:
        e0 = (torch.arange(n_model, device=xf.device) * n_e)[:, None]
        mine = keep & (eidx >= e0) & (eidx < e0 + n_e)
        e_sel = eidx - e0
    else:
        mine, e_sel = keep, eidx
    # each device's buffer is n_e * slots rows and a trash row
    rows = n_e * slots + 1
    g = torch.arange(G, device=xf.device).view(*lead, 1)
    dst = torch.where(mine, e_sel * slots + pos, rows - 1) + g * rows
    src = xf[..., :n, :].repeat_interleave(k, dim=-2)
    buf = xf.new_zeros(G * rows, D).index_copy_(
        0, dst.reshape(-1), src.reshape(-1, D))
    buf = buf.view(*lead, rows, D)[..., :-1, :].reshape(*lead, n_e, slots, D)
    if ep:                   # [E, cap, D] -> [E/n, n*cap, D] per device
        nd = lead[0]
        buf = buf.view(nd, n_model, n_model, n_e // n_model, slots, D) \
            .permute(0, 2, 3, 1, 4, 5) \
            .reshape(nd, n_model, n_e // n_model, n_model * slots, D)
    act = ((lambda h: F.gelu(h, approximate="tanh"))
           if cfg.mlp_act == "geglu" else F.silu)
    h = act(_expert_mm(buf, p["w_gate"])) * _expert_mm(buf, p["w_up"])
    out_e = _expert_mm(h, p["w_down"])
    if ep:                   # and back: [E/n, n*cap, D] -> [E, cap, D]
        out_e = out_e.view(nd, n_model, n_e // n_model, n_model, slots, D) \
            .permute(0, 3, 1, 2, 4, 5).reshape(nd, n_model, n_e, slots, D)
    if tp:                   # the d_ff slices' partial sums
        out_e = out_e.sum(1, keepdim=True).expand_as(out_e)
    src_row = torch.where(mine, e_sel * slots + pos, 0) + g * (rows - 1)
    got = out_e.reshape(G * n_e * slots, D).index_select(
        0, src_row.reshape(-1)).view(*lead, n * k, D)
    got = torch.where(mine[..., None], got, 0)
    wflat = w.reshape(*lead, n * k, 1).to(xf.dtype)
    out = torch.sum((got * wflat).view(*lead, n, k, D), dim=-2)
    if ep_rep:               # the expert shards' partial outputs
        out = out.sum(1, keepdim=True).expand_as(out)
    if n < M:
        out = torch.cat([out, out.new_zeros(*lead, M - n, D)], dim=-2)
    me = torch.mean(gates, dim=-2)
    ce = torch.mean(F.one_hot(idx[..., 0], E).float(), dim=-2)
    return out, (me, ce)


def _moe_shards(p, cfg, n_model: int) -> dict:
    """The expert leaves split over the model axis of a mesh, the shards
    along a new leading axis: ``ep`` E/n experts a shard, ``tp`` a d_ff
    slice of every expert; the router is whole on every shard."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    if cfg.moe_shard_mode == "ep":
        return {"router": p["router"],
                **{key: p[key].view(n_model, E // n_model, *p[key].shape[1:])
                   for key in ("w_gate", "w_up", "w_down")}}
    fl = f // n_model
    return {"router": p["router"],
            "w_gate": p["w_gate"].view(E, d, n_model, fl).permute(2, 0, 1, 3),
            "w_up": p["w_up"].view(E, d, n_model, fl).permute(2, 0, 1, 3),
            "w_down": p["w_down"].view(E, n_model, fl, d).transpose(0, 1)}


def moe_block(p, x, cfg, *, mesh=None, rows=None):
    """Top-k MoE over ``x [B, T, D]``; returns ``(out, aux)`` with the
    load-balancing term ``aux = E * sum(me * ce)`` (f32 scalar).

    * ``mesh=None``: one dispatch over all ``B*T`` tokens (the JAX
      package with no mesh, and every serving path); ``rows`` (a decode
      step) counts the real batch rows, the rest are padding that takes
      no capacity.
    * ``mesh=(n_data, n_model)``: JAX's ``shard_map`` lane on a virtual
      mesh. The batch splits over data (when ``B % n_data == 0``); in
      ``ep`` the sequence splits over model when ``T % n_model == 0``,
      else the ep-replicated lane runs; ``tp`` never splits the tokens
      over model. ``cap`` is per local token block, and ``me``, ``ce``
      are averaged over model, then over data, before the product (the
      ``pmean``s). Padding rows are dropped first.
    """
    B, T, D = x.shape
    E = cfg.n_experts
    if mesh is None:
        out, (me, ce) = _moe_dispatch_compute(
            p, x.reshape(B * T, D), cfg,
            n_tokens=None if rows is None else rows * T)
        return out.reshape(B, T, D), E * torch.sum(me * ce)
    if rows is not None and rows < B:
        out, aux = moe_block(p, x[:rows], cfg, mesh=mesh)
        return torch.cat([out, out.new_zeros(B - rows, T, D)]), aux
    n_data, n_model = mesh
    split_b = B % n_data == 0
    split_t = cfg.moe_shard_mode == "ep" and T % n_model == 0
    b = B // n_data if split_b else B
    t = T // n_model if split_t else T
    xb = x.view(n_data, b, T, D) if split_b else x.expand(n_data, B, T, D)
    xl = (xb.view(n_data, b, n_model, t, D).transpose(1, 2) if split_t
          else xb[:, None].expand(n_data, n_model, b, T, D))
    out, (me, ce) = _moe_dispatch_compute(
        _moe_shards(p, cfg, n_model), xl.reshape(n_data, n_model, b * t, D),
        cfg, ep_replicated=cfg.moe_shard_mode == "ep" and not split_t)
    me, ce = me.mean(1).mean(0), ce.mean(1).mean(0)
    out = out.view(n_data, n_model, b, t, D)
    out = (out.transpose(1, 2).reshape(n_data, b, T, D) if split_t
           else out[:, 0])
    return (out.reshape(B, T, D) if split_b else out[0]), \
        E * torch.sum(me * ce)


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
      host (a device index would cost a blocking copy per layer). A 0-d
      tensor ``rows`` (the step builders' device lane: every row live,
      ``x`` as wide as the cache) writes every row back. ``new_state``
      is ``state``.
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
        if Bc == B:
            st = state
        else:
            st = torch.zeros((B, H, S, P), dtype=torch.float32,
                             device=x.device)
            st[:Bc] = state
        at = torch.exp(a[:, 0]).float()                      # [B, H]
        st = (st * at[..., None, None]
              + b[:, 0].float()[:, None, :, None]
              * xin[:, 0].float()[:, :, None, :])
        y = torch.einsum("bs,bhsp->bhp", c[:, 0].float(),
                         st)[:, None].to(x.dtype)
        live = (range(Bc) if torch.is_tensor(rows)
                else [i for i, r in enumerate(rows) if r >= 0])
        if len(live) == Bc:
            state.copy_(st[:Bc])
        else:
            for i in live:
                state[i] = st[i]
        new_state = state
    y = y + xin * p["skip"][None, None, :, None].to(u.dtype)
    y = y.reshape(B, T, H * P) * F.silu(z)
    return dense(y, p["w_out"]), new_state
