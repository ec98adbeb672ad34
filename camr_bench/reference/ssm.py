"""The state-space family (mamba2): parameter layout, the plain forward
pass to the summed loss, and the model FLOPs.

Each of ``n_layers`` layers is ``x + mixer(rms(x))``. The mixer projects
``x`` to ``u`` (``d_inner``, as ``H`` heads of ``P``), a gate ``z``,
``B`` and ``C`` (``ssm_state`` each, shared by the heads) and a step
``dt = softplus(x W_dt)`` per head; ``a = -exp(a_log) * dt`` is the
log-decay and ``x_s = u_s * dt_s`` the input. The state-space dual form
gives ``y_t = sum_{s <= t} exp(A_t - A_s) (C_t . B_s) x_s`` with ``A``
the running sum of ``a``; then ``y + skip * x``, gated by ``silu(z)``,
and projected back to ``d_model``. A final RMS norm and the output
matrix. Rows of the tables past the published vocabulary are never a
label and take no part in the softmax.
"""

from __future__ import annotations

import torch

from .common import Leaf, flat_leaves, nll_sum, rms_norm, silu, softplus

__all__ = ["layout", "nll", "matmul_params", "attention_flops_per_token"]


def layout(cfg: dict) -> dict:
    """The parameter tree as the program takes it (``params=``)."""
    d, R = cfg["d_model"], cfg["n_layers"]
    di, H, S = cfg["ssm_d_inner"], cfg["ssm_heads"], cfg["ssm_state"]
    dt = cfg["dtype"]
    blk = ("blocks", "0_ssm")

    def w(name, *shape, std):
        return Leaf(blk + ("ssm", name), (R, *shape), dt, ("normal", std))

    tree = {
        "embed": Leaf(("embed",), (cfg["vocab_rows"], d), dt,
                      ("normal", d ** -0.5)),
        "norm_f": Leaf(("norm_f",), (d,), "float32", ("const", 0.0)),
        "blocks": {"0_ssm": {
            "norm": Leaf(blk + ("norm",), (R, d), "float32", ("const", 0.0)),
            "ssm": {
                "w_in": w("w_in", d, di, std=d ** -0.5),
                "w_gate": w("w_gate", d, di, std=d ** -0.5),
                "w_bc": w("w_bc", d, 2 * S, std=d ** -0.5),
                "w_dt": w("w_dt", d, H, std=d ** -0.5),
                "a_log": Leaf(blk + ("ssm", "a_log"), (R, H), "float32",
                              ("const", 0.0)),
                "skip": Leaf(blk + ("ssm", "skip"), (R, H), "float32",
                             ("const", 0.1)),
                "w_out": w("w_out", di, d, std=di ** -0.5)}}},
    }
    if not cfg["tie_embeddings"]:
        tree["out"] = Leaf(("out",), (d, cfg["vocab_rows"]), dt,
                           ("normal", d ** -0.5))
    return tree


def _ssd(x, a, b, c, num):
    """``y [n, T, H, P]`` of the dual form from ``x [n, T, H, P]``, ``a
    [n, T, H]``, ``b``, ``c [n, T, S]`` (one op: float32 inside)."""
    T = x.shape[1]
    cum = torch.cumsum(a, dim=1)                             # [n, T, H]
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    expo = torch.where(causal[None, :, :, None],
                       cum[:, :, None] - cum[:, None], float("-inf"))
    cb = num.inner(c, b.transpose(1, 2))                     # [n, T, T]
    w = (cb[..., None] * torch.exp(expo)).permute(0, 3, 1, 2)  # [n, H, t, s]
    return num.inner(w, x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def _mixer(cfg, p, x, num):
    n, T, _ = x.shape
    H, S = cfg["ssm_heads"], cfg["ssm_state"]
    P = cfg["ssm_d_inner"] // H
    act = num.act
    u = num.dense(x, p["w_in"]).reshape(n, T, H, P)
    z = num.dense(x, p["w_gate"])
    bc = num.dense(x, p["w_bc"])
    b, c = bc[..., :S], bc[..., S:]
    dt = softplus(num.dense(x, p["w_dt"]))                   # [n, T, H]
    a = -torch.exp(p["a_log"]) * dt
    xin = act(u * act(dt)[..., None])
    y = act(_ssd(xin, a, b, c, num))
    y = act(y + act(xin * act(p["skip"])[:, None]))
    y = act(y.reshape(n, T, H * P) * act(silu(z)))
    return num.dense(y, p["w_out"])


def nll(cfg: dict, params: list, tokens: torch.Tensor, labels: torch.Tensor,
        num) -> torch.Tensor:
    """Summed NLL of ``labels`` given ``tokens`` (``[b, T]``), the
    parameters as float32 leaves in the order of :func:`layout`, at the
    precision of ``num`` (:class:`~.common.Numerics`)."""
    leaves = flat_leaves(layout(cfg))
    Pm = dict(zip([leaf.path for leaf in leaves],
                  num.weights(leaves, params)))
    eps, act = cfg["rms_eps"], num.act
    blk = ("blocks", "0_ssm")
    keys = ("w_in", "w_gate", "w_bc", "w_dt", "a_log", "skip", "w_out")
    x = Pm[("embed",)][tokens.long()]
    for r in range(cfg["n_layers"]):
        lay = {key: Pm[blk + ("ssm", key)][r] for key in keys}
        h = act(rms_norm(x, Pm[blk + ("norm",)][r], eps))
        x = act(x + _mixer(cfg, lay, h, num))
    x = act(rms_norm(x, Pm[("norm_f",)], eps))
    V = cfg["vocab"]
    head = (Pm[("embed",)][:V].T if cfg["tie_embeddings"]
            else Pm[("out",)][:, :V])
    return nll_sum(num.dense(x, head), labels)


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product: every layer's input, gate,
    B/C, step and output projections and the output head over the
    published vocabulary (the input embedding is a lookup)."""
    d = cfg["d_model"]
    di, H, S = cfg["ssm_d_inner"], cfg["ssm_heads"], cfg["ssm_state"]
    layer = 2 * d * di + d * 2 * S + d * H + di * d
    return cfg["n_layers"] * layer + cfg["vocab"] * d


def attention_flops_per_token(cfg: dict, seq_len: int) -> int:
    """No attention; the SSD recurrence (about 2% of the count at the
    benchmark's lengths) is left out of the model FLOPs."""
    return 0
