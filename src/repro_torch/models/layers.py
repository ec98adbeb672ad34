"""Layer primitives of the dense decoder (plain functions on tensors).

Counterparts of ``repro.models.layers``: ``dense``, ``rms_norm``,
``rope``, ``attention_block`` (no KV cache, no paged cache) and
``mlp_block``. Activations are ``x [B, T, D]``; attention works on
``[B, H, T, Dh]``. Products of two same-dtype tensors accumulate in f32
inside ``torch.matmul``; mixed dtypes go through f32 explicitly.

Attention is the plain materialized form of the JAX package's
``repro.kernels.ref.flash_attention_ref`` — the lane ``ops.attention``
takes there when ``Tq*Tk <= 2**21`` (``seq_len <= 1448``). The
``flash_attention`` kernel is a later slice's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dense", "rms_norm", "rope", "attention_ref", "attention_block",
           "mlp_block", "ATTN_MAX_SCORES"]

#: Tq*Tk above which the JAX package switches to its chunked attention
#: lane, not ported yet
ATTN_MAX_SCORES = 2 ** 21


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


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None):
    """Materialized attention: q ``[B, Hq, Tq, D]``, k/v ``[B, Hkv, Tk, D]``
    (GQA: ``Hq % Hkv == 0``), queries right-aligned against the keys;
    softmax in f32, output in the dtype of ``q``."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qg = q.reshape(B, Hkv, rep, Tq, D).float()
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def attention_block(p, x, positions, cfg, *, window=None, softcap=None,
                    causal=True):
    """Self-attention with GQA and RoPE (training lane: no cache)."""
    B, T, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if T * T > ATTN_MAX_SCORES:
        raise NotImplementedError(
            f"seq_len {T}: Tq*Tk > 2**21 takes the chunked attention lane "
            "in the JAX package, which is not ported yet (ROADMAP.md, "
            "Queue 2: flash_attention)")
    q = dense(x, p["wq"]).reshape(B, T, hq, dh).transpose(1, 2)
    k = dense(x, p["wk"]).reshape(B, T, hkv, dh).transpose(1, 2)
    v = dense(x, p["wv"]).reshape(B, T, hkv, dh).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = attention_ref(q, k, v, causal=causal, window=window,
                        softcap=softcap)
    out = out.transpose(1, 2).reshape(B, T, hq * dh)
    return dense(out, p["wo"])


def mlp_block(p, x, cfg):
    """SwiGLU / GEGLU (``jax.nn.gelu``'s default is the tanh form)."""
    if cfg.mlp_act == "geglu":
        gate = F.gelu(dense(x, p["w_gate"]), approximate="tanh")
    else:
        gate = F.silu(dense(x, p["w_gate"]))
    return dense(gate * dense(x, p["w_up"]), p["w_down"])
