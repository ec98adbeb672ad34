"""The dense decoder family (granite): parameter layout, the plain
forward pass to the summed loss, and the model FLOPs.

Each of ``n_layers`` layers is ``x + attn(rms(x))`` then ``x +
mlp(rms(x))``: grouped-query causal attention with rotary positions
(the halves of each head rotated, frequencies ``theta**(-i/half)``),
softmax scaled by ``head_dim**-0.5``, and a SwiGLU MLP. A final RMS norm,
then logits over the embedding table (tied) or an output matrix; rows
of the table past the published vocabulary are never a label and take
no part in the softmax.
"""

from __future__ import annotations

import torch

from .common import Leaf, flat_leaves, nll_sum, rms_norm, silu

__all__ = ["layout", "nll", "matmul_params", "attention_flops_per_token"]


def layout(cfg: dict) -> dict:
    """The parameter tree as the program takes it (``params=``): every
    matrix in ``cfg["dtype"]``, stacked over the layers; norm scales
    float32 zeros (the norm multiplies by ``1 + scale``)."""
    d, f, R = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    dt = cfg["dtype"]

    def w(name, *shape, std):
        return Leaf(name, (R, *shape), dt, ("normal", std))

    def z(name, *shape):
        return Leaf(name, shape, "float32", ("const", 0.0))

    blk = ("blocks", "0_attn")
    tree = {
        "embed": Leaf(("embed",), (cfg["vocab_rows"], d), dt,
                      ("normal", d ** -0.5)),
        "norm_f": z(("norm_f",), d),
        "blocks": {"0_attn": {
            "norm1": z(blk + ("norm1",), R, d),
            "norm2": z(blk + ("norm2",), R, d),
            "attn": {
                "wq": w(blk + ("attn", "wq"), d, hq * dh, std=d ** -0.5),
                "wk": w(blk + ("attn", "wk"), d, hkv * dh, std=d ** -0.5),
                "wv": w(blk + ("attn", "wv"), d, hkv * dh, std=d ** -0.5),
                "wo": w(blk + ("attn", "wo"), hq * dh, d, std=d ** -0.5)},
            "mlp": {
                "w_gate": w(blk + ("mlp", "w_gate"), d, f, std=d ** -0.5),
                "w_up": w(blk + ("mlp", "w_up"), d, f, std=d ** -0.5),
                "w_down": w(blk + ("mlp", "w_down"), f, d, std=f ** -0.5)}}},
    }
    if not cfg["tie_embeddings"]:
        tree["out"] = Leaf(("out",), (d, cfg["vocab_rows"]), dt,
                           ("normal", d ** -0.5))
    return tree


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [b, h, T, dh]`` rotated at positions ``0 .. T-1``."""
    T, half = x.shape[2], x.shape[3] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(cfg, p, x, num):
    b, T, _ = x.shape
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = num.dense(x, p["wq"]).reshape(b, T, hq, dh).transpose(1, 2)
    k = num.dense(x, p["wk"]).reshape(b, T, hkv, dh).transpose(1, 2)
    v = num.dense(x, p["wv"]).reshape(b, T, hkv, dh).transpose(1, 2)
    q = num.act(_rope(q, cfg["rope_theta"]))
    k = num.act(_rope(k, cfg["rope_theta"]))
    rep = hq // hkv       # query head h reads kv head h // rep
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = num.inner(q, k.transpose(-1, -2)) * dh ** -0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    s = torch.where(causal, s, float("-inf"))
    o = num.act(num.inner(torch.softmax(s, dim=-1), v))
    return num.dense(o.transpose(1, 2).reshape(b, T, hq * dh), p["wo"])


def nll(cfg: dict, params: list, tokens: torch.Tensor, labels: torch.Tensor,
        num) -> torch.Tensor:
    """Summed NLL of ``labels`` given ``tokens`` (``[b, T]``), the
    parameters as float32 leaves in the order of :func:`layout`, at the
    precision of ``num`` (:class:`~.common.Numerics`)."""
    leaves = flat_leaves(layout(cfg))
    P = dict(zip([leaf.path for leaf in leaves],
                 num.weights(leaves, params)))
    eps, act = cfg["rms_eps"], num.act
    blk = ("blocks", "0_attn")
    x = P[("embed",)][tokens.long()]
    for r in range(cfg["n_layers"]):
        lay = {key: P[blk + ("attn", key)][r]
               for key in ("wq", "wk", "wv", "wo")}
        h = act(rms_norm(x, P[blk + ("norm1",)][r], eps))
        x = act(x + _attention(cfg, lay, h, num))
        h = act(rms_norm(x, P[blk + ("norm2",)][r], eps))
        gate = act(silu(num.dense(h, P[blk + ("mlp", "w_gate")][r])))
        up = act(gate * num.dense(h, P[blk + ("mlp", "w_up")][r]))
        x = act(x + num.dense(up, P[blk + ("mlp", "w_down")][r]))
    x = act(rms_norm(x, P[("norm_f",)], eps))
    V = cfg["vocab"]
    head = (P[("embed",)][:V].T if cfg["tie_embeddings"]
            else P[("out",)][:, :V])
    return nll_sum(num.dense(x, head), labels)


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product: every layer's attention
    and MLP matrices and the output head over the published vocabulary
    (the input embedding is a lookup)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    layer = 2 * d * hq * dh + 2 * d * hkv * dh + 3 * d * f
    return cfg["n_layers"] * layer + cfg["vocab"] * d


def attention_flops_per_token(cfg: dict, seq_len: int) -> int:
    """Causal attention's forward and backward, per token: ``6 * T *
    n_heads * head_dim`` per attention layer."""
    return 6 * seq_len * cfg["n_heads"] * cfg["head_dim"] * cfg["n_layers"]
