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
from ..launch import partitioning as pt

__all__ = ["dense", "rms_norm", "layer_norm", "rope", "attention_block",
           "mlp_block", "moe_capacity", "moe_block", "softplus",
           "ssm_block", "spec_attention", "spec_mlp", "spec_moe",
           "spec_ssm", "EMBED", "FFN", "HEADS", "KV", "VOCAB", "EXP",
           "SSM_IN", "STATE"]

# logical axis names (mapped to mesh axes in launch/partitioning.py).
# The d_model axis of *parameters* is the FSDP shard axis ('fsdp'); the
# 'embed' name is reserved for activations (replicated over model).
EMBED, FFN, HEADS, KV, VOCAB, EXP, SSM_IN, STATE = (
    "fsdp", "ffn", "heads", "kv", "vocab", "experts", "ssm_in", "state")


def spec_attention(cfg) -> dict:
    return {"wq": (EMBED, HEADS), "wk": (EMBED, KV), "wv": (EMBED, KV),
            "wo": (HEADS, EMBED)}


def spec_mlp(cfg) -> dict:
    return {"w_gate": (EMBED, FFN), "w_up": (EMBED, FFN),
            "w_down": (FFN, EMBED)}


def spec_moe(cfg) -> dict:
    if cfg.moe_shard_mode == "ep":
        w = (EXP, EMBED, None)
        wd = (EXP, None, EMBED)
    else:  # tensor-parallel experts (few big experts, e.g. mixtral)
        w = (None, EMBED, FFN)
        wd = (None, FFN, EMBED)
    return {"router": (EMBED, None), "w_gate": w, "w_up": w, "w_down": wd}


def spec_ssm(cfg) -> dict:
    return {"w_in": (EMBED, SSM_IN), "w_gate": (EMBED, SSM_IN),
            "w_bc": (EMBED, None), "w_dt": (EMBED, None),
            "a_log": (None,), "skip": (None,), "w_out": (SSM_IN, EMBED)}


def _batch_only(x):
    """A block's input with the residual stream's sequence split
    gathered (the all-gather that opens a Megatron-SP block); no-op
    without a mesh."""
    return pt.constrain(x, ("batch", None, "embed"))


def _dense_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == w.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if pt.is_dtensor(x):
        return _dense_sharded(x, pt.gather_data(w))
    return _dense_local(x, w)


def _dense_sharded(x, w):
    """``x @ w`` on DTensors as the Megatron products JAX's partitioner
    makes of them, each rank multiplying its shards (``local_map``):
    along each mesh dimension, ``w`` whole and ``x`` split over a leading
    dim (the batch) or whole; ``w``'s columns split and ``x`` whole (a
    column-parallel product, its output split the same way); or ``w``'s
    rows split and ``x``'s last dim split alike, or ``x`` whole and
    sliced so (row-parallel, a ``Partial`` sum out). Left to its own
    cost model, DTensor picks other plans, which differ between torch
    versions (a gathered vocab in the logits' backward, for one). Any
    other layout goes to DTensor."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    last = x.dim() - 1
    xs, out = list(x.placements), []
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if pw.is_replicate() and not px.is_shard(last):
            out.append(px)
        elif pw.is_shard(1) and px.is_replicate():
            out.append(Shard(last))
        elif pw.is_shard(0) and (px.is_shard(last) or px.is_replicate()):
            xs[i] = Shard(last)        # a whole x: its slice, no traffic
            out.append(Partial())
        else:
            return _dense_local(x, w)
    if xs != list(x.placements):
        x = x.redistribute(x.device_mesh, xs)
    ins = (tuple(x.placements), tuple(w.placements))
    return local_map(_dense_local, out_placements=list(out),
                     in_placements=ins,
                     in_grad_placements=pt.grad_placements(ins, out),
                     device_mesh=x.device_mesh)(x, w)


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
    cos, sin = pt.like(torch.cos(ang), x), pt.like(torch.sin(ang), x)
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
    value goes to the host. On a mesh the cache's sequence is split over
    the model axis: the write is a select against each shard's global
    positions, and the attention reads the cache at JAX's head
    constraint (:func:`_attend`)."""
    if pt.is_dtensor(q):
        kc, vc = cache["k"], cache["v"]
        hit = (pt.sharded_iota(kc.shape[2], kc, 2) == index)[:, None]
        for c, new in ((kc, k), (vc, v)):
            new = pt.constrain(new, ("batch", None, None, None))
            c.copy_(torch.where(hit, new, c).redistribute(
                c.device_mesh, c.placements))
        return _attend(ops.attention, q, kc, vc, valid_len=index + 1, **kw)
    pos = index.reshape(1).long()
    cache["k"].index_copy_(2, pos, k)
    cache["v"].index_copy_(2, pos, v)
    return ops.attention(q, cache["k"], cache["v"], valid_len=index + 1,
                         **kw)


def _heads(y, h: int, dh: int):
    """A projection ``[B, T, h*dh]`` as heads ``[B, h, T, dh]``. On a
    DTensor whose columns split over more shards than there are heads
    (8 kv heads' columns over 16 model shards), the columns are gathered
    first: a shard of half a head is no head."""
    B, T, _ = y.shape
    if pt.is_dtensor(y):
        from torch.distributed.tensor import Replicate
        mesh = y.device_mesh
        split = [i for i, p in enumerate(y.placements) if p.is_shard(2)]
        if h % math.prod(mesh.size(i) for i in split):
            y = y.redistribute(mesh, tuple(
                Replicate() if i in split else p
                for i, p in enumerate(y.placements)))
    return y.reshape(B, T, h, dh).transpose(1, 2)


def _attend(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (an attention of :mod:`repro_torch.kernels.
    ops`) as it is on plain tensors. On DTensors, JAX's constraint of q,
    k and v to ``("batch", "heads")`` (dropped where the heads do not
    divide the model axis), then ``fn`` on each rank's shard through
    ``local_map`` (the kernels have no sharding rule). Where the query
    heads split and the kv heads cannot (8 kv heads over 16 shards),
    the kv heads are repeated to one per model shard before the split,
    so that each rank holds the one kv head its query heads read; where
    neither works the queries stay whole."""
    if not pt.is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    q, k, v = (pt.constrain(t, ("batch", "heads", None, None))
               for t in (q, k, v))
    mesh = q.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    n, hkv = mesh.size(mi), k.shape[1]
    if q.placements[mi].is_shard(1) and not k.placements[mi].is_shard(1):
        if n % hkv == 0:
            want = tuple(Shard(1) if i == mi else p
                         for i, p in enumerate(k.placements))
            B, _, Tk, D = k.shape
            k, v = (t.unsqueeze(2).expand(B, hkv, n // hkv, Tk, D)
                    .reshape(B, n, Tk, D).redistribute(mesh, want)
                    for t in (k, v))
        else:
            q = q.redistribute(mesh, tuple(
                Replicate() if i == mi else p
                for i, p in enumerate(q.placements)))
    ins = (q.placements, k.placements, v.placements)
    return local_map(lambda a, b, c: fn(a, b, c, **kw),
                     out_placements=list(q.placements), in_placements=ins,
                     in_grad_placements=pt.grad_placements(ins,
                                                           q.placements),
                     device_mesh=mesh)(q, k, v)


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
    x = _batch_only(x)
    src = x if memory is None else _batch_only(memory)
    Ts = src.shape[1]
    q = _heads(dense(x, p["wq"]), hq, dh)
    k = _heads(dense(src, p["wk"]), hkv, dh)
    v = _heads(dense(src, p["wv"]), hkv, dh)
    if memory is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kw = dict(causal=causal and memory is None, window=window,
              softcap=softcap)

    if cache is None:
        out = _attend(ops.plain_attention if train else ops.attention,
                      q, k, v, **kw)
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
    elif pt.is_dtensor(k):
        # the whole cache at once, kept in its sharded layout (JAX's
        # constraint of the written cache)
        if int(cache_index) != 0 or T != cache["k"].shape[2]:
            raise ValueError("a sharded prefill fills its whole cache")
        for key, t in (("k", k), ("v", v)):
            cache[key].copy_(pt.constrain(t, ("batch", None, "seq_kv",
                                              None)))
        out = _attend(ops.attention, q, k, v, **kw)
    else:
        i = int(cache_index)
        cache["k"][:, :, i:i + T] = k
        cache["v"][:, :, i:i + T] = v
        out = ops.attention(q, k, v, **kw)
    out = out.transpose(1, 2).reshape(B, T, hq * dh)
    return dense(out, p["wo"]), cache


def mlp_block(p, x, cfg):
    """SwiGLU / GEGLU (``jax.nn.gelu``'s default is the tanh form)."""
    x = _batch_only(x)
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
                          n_tokens: int | None = None, e0=None,
                          exchange=None, psum=None):
    """Dispatch and expert FFN of a flat token block, the twin of
    ``repro.models.layers._moe_dispatch_compute``; returns ``(out, (me,
    ce))``.

    * ``xf [M, D]`` with no mesh keyword: ``p``'s expert leaves are whole
      (``[E, d, f]``). ``n_tokens`` (default ``M``) real tokens lead the
      block: capacity and slots count those only, the rest (a decode
      step's padding to ``lm.DECODE_ROWS``) take no slot and give 0. The
      expert buffer has ``moe_capacity(cfg, M)`` rows an expert whatever
      ``n_tokens`` is, so a decode step's products run at one shape.
    * JAX's ``shard_map`` body: one device's block ``xf [M, D]`` (a
      DTensor mesh, :func:`_moe_sharded`) or every device of a virtual
      mesh at once, ``xf [n_data, n_model, M, D]`` (:func:`moe_block`).
      ``p``'s expert leaves are the model shard's: E/n experts in ``ep``,
      a d_ff slice of every expert in ``tp`` (on the virtual mesh along a
      leading model axis, :func:`_moe_shards`). ``exchange`` (``ep``):
      the pair of maps of JAX's tiled ``all_to_all``, ``[E, cap, D] ->
      [E/n, n*cap, D]`` and back. ``ep_replicated`` (the same tokens on
      every model shard): the shard serves its own experts only, ``e0``
      the first (broadcast over the leading axes). ``psum``: the sum over
      the model shards (JAX's ``psum``) of ``tp``'s expert outputs or
      ep-replicated's token outputs; without it the output is this
      shard's partial sum.

    Dropped assignments go to a trash row of the buffer and are masked
    to 0 in the gather (JAX adds zeros to slot ``(E-1, cap-1)``).
    ``me`` and ``ce`` (f32 ``[..., E]``) are the mean gate and the share
    of tokens whose top-1 expert is each expert.
    """
    E, k = cfg.n_experts, cfg.experts_per_token
    lead, (M, D) = xf.shape[:-2], xf.shape[-2:]
    G = math.prod(lead)
    n = M if n_tokens is None else n_tokens
    gates, w, idx, eidx, pos, keep = _moe_route(p, xf, cfg, n)
    slots = moe_capacity(cfg, M)
    n_e = p["w_gate"].shape[-3] if ep_replicated else E
    if ep_replicated:
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
    if exchange is not None:
        buf = exchange[0](buf)
    act = ((lambda h: F.gelu(h, approximate="tanh"))
           if cfg.mlp_act == "geglu" else F.silu)
    h = act(_expert_mm(buf, p["w_gate"])) * _expert_mm(buf, p["w_up"])
    out_e = _expert_mm(h, p["w_down"])
    if exchange is not None:
        out_e = exchange[1](out_e)
    if psum is not None and not ep_replicated:   # d_ff partial sums
        out_e = psum(out_e)
    src_row = torch.where(mine, e_sel * slots + pos, 0) + g * (rows - 1)
    got = out_e.reshape(G * n_e * slots, D).index_select(
        0, src_row.reshape(-1)).view(*lead, n * k, D)
    got = torch.where(mine[..., None], got, 0)
    wflat = w.reshape(*lead, n * k, 1).to(xf.dtype)
    out = torch.sum((got * wflat).view(*lead, n, k, D), dim=-2)
    if psum is not None and ep_replicated:       # expert shards' partials
        out = psum(out)
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
    if pt.is_dtensor(x):
        return _moe_sharded(p, x, cfg)
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
    ep = cfg.moe_shard_mode == "ep" and n_model > 1
    n_e = E // n_model
    # the tiled all-to-all swaps the source-device and expert-block axes
    exchange = ((lambda b: b.unflatten(2, (n_model, n_e))
                 .permute(0, 2, 3, 1, 4, 5).flatten(3, 4)),
                (lambda o: o.unflatten(3, (n_model, -1))
                 .permute(0, 3, 1, 2, 4, 5).flatten(2, 3)))
    out, (me, ce) = _moe_dispatch_compute(
        _moe_shards(p, cfg, n_model), xl.reshape(n_data, n_model, b * t, D),
        cfg, ep and not split_t,
        e0=(torch.arange(n_model, device=x.device) * n_e)[:, None],
        exchange=exchange if ep and split_t else None,
        psum=(None if n_model == 1 or (ep and split_t) else
              (lambda v: v.sum(1, keepdim=True).expand_as(v))))
    me, ce = me.mean(1).mean(0), ce.mean(1).mean(0)
    out = out.view(n_data, n_model, b, t, D)
    out = (out.transpose(1, 2).reshape(n_data, b, T, D) if split_t
           else out[:, 0])
    return (out.reshape(B, T, D) if split_b else out[0]), \
        E * torch.sum(me * ce)


def _moe_sharded(p, x, cfg):
    """:func:`moe_block` on a DTensor mesh: JAX's ``shard_map`` lane
    through ``local_map``. The batch splits over the data axes (when it
    divides); ``ep`` splits the sequence over model (when it divides,
    else the ep-replicated lane) and the experts E/n a shard, ``tp`` the
    d_ff of every expert; the router is whole everywhere. The all-to-all
    runs inside the body; the model shards' partial outputs of ``tp``
    and ep-replicated come out stacked on a new leading dim split over
    model and are summed outside (a ``Partial`` sum, which the residual
    constraint reduce-scatters; JAX sums them inside the body). ``me``
    and ``ce`` are averaged over every device that saw other tokens
    before the product (JAX's ``pmean`` over model, then data)."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    daxes = tuple(pt.current_rules()["batch"])
    n_model = pt.axis_size(mesh, "model")
    B, T, D = x.shape
    E = cfg.n_experts
    split_b = B % pt.axis_size(mesh, daxes) == 0
    ep = cfg.moe_shard_mode == "ep"
    split_t = ep and T % n_model == 0
    mode = ("none" if n_model == 1 else
            ("ep" if split_t else "ep_rep") if ep else "tp")
    xs = pt.parts_to_placements(
        (daxes if split_b else None, "model" if split_t else None, None),
        mesh)
    x = x.redistribute(mesh, xs)

    def on_model(dim):
        return tuple(Shard(dim) if a == "model" else Replicate()
                     for a in names)

    rep = tuple(Replicate() for _ in names)
    if ep:
        wpl = {"w_gate": on_model(0), "w_up": on_model(0),
               "w_down": on_model(0)}
    else:
        wpl = {"w_gate": on_model(2), "w_up": on_model(2),
               "w_down": on_model(1)}
    ws = {"router": pt.gather_data(p["router"]).redistribute(mesh, rep)}
    for key, pl in wpl.items():
        ws[key] = p[key].redistribute(mesh, pl)
    e_ids = pt.sharded_iota(E, ws["w_gate"], 0)
    keys = ("router", "w_gate", "w_up", "w_down")
    group = (mesh, names.index("model"))
    part = mode in ("ep_rep", "tp")
    # the mesh dims along which the ranks do different work; the model
    # shards' partial outputs (and me / ce along every such dim) come
    # out stacked on a new leading dim and are summed (averaged) outside,
    # so that their gradients reach every shard whole
    work = tuple(Shard(0) if part and a == "model" else p
                 for a, p in zip(names, xs))
    stk = tuple(Shard(0) if not p.is_replicate() else Replicate()
                for p in work)
    out_pl = tuple(Shard(0) if part and a == "model" else
                   (Shard(p.dim + 1) if p.is_shard() else p)
                   for a, p in zip(names, xs)) if part else xs
    ins = (rep, wpl["w_gate"], wpl["w_up"], wpl["w_down"], xs,
           e_ids.placements)

    def a2a(t):
        return all_to_all_single_autograd(t.contiguous(), None, None, group)

    # the tiled all-to-all: expert block j's slots to model shard j, and
    # the results back
    exchange = ((lambda b: a2a(b).unflatten(0, (n_model, -1))
                 .transpose(0, 1).flatten(1, 2)),
                (lambda o: a2a(o.unflatten(1, (n_model, -1))
                               .transpose(0, 1)).flatten(0, 1)))

    def body(router, wg, wu, wd, xl, el):
        b, t, _ = xl.shape
        out, (me, ce) = _moe_dispatch_compute(
            dict(zip(keys, (router, wg, wu, wd))), xl.reshape(b * t, D),
            cfg, mode == "ep_rep", e0=el[:1],
            exchange=exchange if mode == "ep" else None)
        out = out.reshape(b, t, D)
        return (out[None] if part else out), me[None], ce[None]

    out, me, ce = local_map(
        body, out_placements=(out_pl, stk, stk), in_placements=ins,
        in_grad_placements=pt.grad_placements(ins, work),
        device_mesh=mesh)(*(ws[k] for k in keys), x, e_ids)
    if part:
        out = out.sum(0)
    return out, E * torch.sum(me.mean(0) * ce.mean(0))


# --------------------------------------------------------------------- #
# Mamba2 block (SSD core + gating)
# --------------------------------------------------------------------- #
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))`` at every x; ``torch.nn.functional.softplus``
    returns ``x`` itself above its threshold of 20 instead."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _scan_local(xin, a, b, c, train: bool, return_state: bool):
    y = (ssd_chunked(xin, a, b, c, chunk=CHUNK) if train
         else ops.ssd(xin, a, b, c))
    new_state = None
    if return_state:
        cum = torch.cumsum(a, dim=1)                         # [B, T, H]
        w = torch.exp(cum[:, -1:, :] - cum)
        new_state = torch.einsum("bth,bts,bthp->bhsp", w, b.float(),
                                 xin.float())
    return y, new_state


def _scan(xin, a, b, c, train: bool, return_state: bool):
    """The SSD scan of a prefill or a training pass and, with
    ``return_state``, the final state (else None). On DTensors the heads
    of ``xin`` / ``a`` split over model, ``b`` / ``c`` (group-shared)
    whole on every model shard, and the scan runs on each rank's heads
    through ``local_map`` (the kernel has no sharding rule)."""
    if not pt.is_dtensor(xin):
        return _scan_local(xin, a, b, c, train, return_state)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xin.device_mesh
    xpl = tuple(xin.placements)          # a [B, T, H] splits as x's B, T, H
    bpl = tuple(Replicate() if p.is_shard(2) else p for p in xpl)
    a = a.redistribute(mesh, xpl)
    b, c = (t.redistribute(mesh, bpl) for t in (b, c))
    spl = tuple(Shard(1) if p.is_shard(2) else p for p in xpl)
    ins = (xpl, xpl, bpl, bpl)
    fn = local_map(
        lambda *t: _scan_local(*t, train, return_state),
        out_placements=(xpl, spl if return_state else None),
        in_placements=ins, in_grad_placements=pt.grad_placements(ins, xpl),
        device_mesh=mesh)
    return fn(xin, a, b, c)


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
    x = _batch_only(x)
    u = dense(x, p["w_in"]).reshape(B, T, H, P)
    z = dense(x, p["w_gate"])                                # [B, T, di]
    bc = dense(x, p["w_bc"])                                 # [B, T, 2S]
    b, c = bc[..., :S], bc[..., S:]                          # [B, T, S]
    dt = softplus(dense(x, p["w_dt"]).float())               # [B, T, H]
    a = -torch.exp(p["a_log"])[None, None, :] * dt           # log-decay < 0
    xin = u * dt[..., None].to(u.dtype)

    if state is None:
        y, new_state = _scan(xin, a, b, c, train, return_state)
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
            state.copy_(st if st.shape[0] == Bc else st[:Bc])
        else:
            for i in live:
                state[i] = st[i]
        new_state = state
    y = y + xin * p["skip"][None, None, :, None].to(u.dtype)
    y = y.reshape(B, T, H * P) * F.silu(z)
    return dense(y, p["w_out"]), new_state
