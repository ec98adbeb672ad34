"""Dense decoder LM of the map lane: init, forward and training loss.

Counterpart of ``repro.models.lm`` for the dense family (``attn`` and
``local`` sublayers with an MLP): ``init_params`` (same shapes, dtypes
and scales, drawn from a ``torch.Generator`` — the numbers differ from
``jax.random``; tests start both packages from the same exported
weights, see :mod:`repro_torch.weights`), ``_embed``, the unit loop (a
Python loop over the stacked ``repeats`` axis in place of ``lax.scan``),
``_logits``, ``_chunked_loss`` and ``train_loss``.

Parameters are nested dicts of tensors; stacked-layer leaves keep their
leading ``repeats`` axis, as in the JAX package, so the flat layout of
:func:`repro_torch.weights.ravel` matches ``ravel_pytree``. There is no
rematerialisation: at the slice's sizes activations are small beside
the parameters.
"""

from __future__ import annotations

import torch

from ..configs import ModelConfig
from . import layers as L

__all__ = ["slot_names", "init_params", "train_loss"]

_DENSE_KINDS = ("attn", "local")


def slot_names(cfg: ModelConfig) -> list[str]:
    return [f"{i}_{kind}" for i, kind in enumerate(cfg.pattern)]


def _check_dense(cfg: ModelConfig) -> None:
    bad = [k for k in cfg.pattern if k not in _DENSE_KINDS]
    if (cfg.family != "dense" or cfg.n_experts or cfg.n_enc_layers
            or cfg.frontend or bad):
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder path is ported (ROADMAP.md, "
            "Queue 1: the model zoo)")


def _normal(gen, shape, dtype, scale):
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return x * scale


def _init_slot(gen, cfg: ModelConfig, R: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, sc = cfg.torch_dtype, d ** -0.5

    def z():
        return torch.zeros((R, d), dtype=torch.float32, device=gen.device)

    return {
        "norm1": z(),
        "attn": {"wq": _normal(gen, (R, d, hq * dh), dt, sc),
                 "wk": _normal(gen, (R, d, hkv * dh), dt, sc),
                 "wv": _normal(gen, (R, d, hkv * dh), dt, sc),
                 "wo": _normal(gen, (R, hq * dh, d), dt, sc)},
        "norm2": z(),
        "mlp": {"w_gate": _normal(gen, (R, d, f), dt, sc),
                "w_up": _normal(gen, (R, d, f), dt, sc),
                "w_down": _normal(gen, (R, f, d), dt, f ** -0.5)},
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on the generator's device."""
    _check_dense(cfg)
    d, V = cfg.d_model, cfg.vocab_padded
    params = {
        "embed": _normal(gen, (V, d), cfg.torch_dtype, d ** -0.5),
        "norm_f": torch.zeros((d,), dtype=torch.float32, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["out"] = _normal(gen, (d, V), cfg.torch_dtype, d ** -0.5)
    params["blocks"] = {name: _init_slot(gen, cfg, cfg.repeats)
                        for name in slot_names(cfg)}
    return params


def _apply_slot(cfg, kind, p, x, positions):
    window = cfg.local_window if kind == "local" else cfg.window
    h = L.rms_norm(x, p["norm1"])
    x = x + L.attention_block(p["attn"], h, positions, cfg, window=window,
                              softcap=cfg.attn_softcap)
    h = L.rms_norm(x, p["norm2"])
    return x + L.mlp_block(p["mlp"], h, cfg)


def _layer(tree, r: int):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _units(cfg, params, x, positions):
    """The pattern repetitions in order (``lax.scan`` in the JAX package)."""
    for r in range(cfg.repeats):
        for name, kind in zip(slot_names(cfg), cfg.pattern):
            x = _apply_slot(cfg, kind, _layer(params["blocks"][name], r), x,
                            positions)
    return x


def _embed(cfg, params, batch):
    x = params["embed"][batch["tokens"].long()]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(cfg, params, x):
    out_w = params["embed"].T if cfg.tie_embeddings else params["out"]
    lg = L.dense(x, out_w).float()
    if cfg.final_softcap:
        lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
    return lg


def _chunked_loss(cfg, params, x, labels):
    """Cross-entropy over seq chunks of the logits (memory: O(chunk *
    vocab)); vocab padding is masked, label ``-1`` is ignored."""
    B, T, D = x.shape
    C = min(cfg.loss_chunk, T)
    assert T % C == 0
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(T // C):
        lg = _logits(cfg, params, x[:, c * C:(c + 1) * C])
        li = labels[:, c * C:(c + 1) * C].long()
        vocab_ids = torch.arange(lg.shape[-1], device=x.device)
        lg = torch.where(vocab_ids < cfg.vocab, lg,
                         torch.tensor(-1e30, device=x.device))
        valid = li >= 0
        li = torch.clamp(li, min=0)
        m = torch.amax(lg, dim=-1)
        lse = m + torch.log(torch.sum(torch.exp(lg - m[..., None]), dim=-1))
        gold = torch.gather(lg, -1, li[..., None])[..., 0]
        nll = torch.where(valid, lse - gold, 0.0)
        tot = tot + nll.sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1)


def train_loss(cfg: ModelConfig, params, batch):
    """batch: ``tokens``, ``labels`` int ``[B, T]`` -> (loss, metrics)."""
    _check_dense(cfg)
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _units(cfg, params, x, positions)
    x = L.rms_norm(x, params["norm_f"])
    loss = _chunked_loss(cfg, params, x, batch["labels"])
    return loss, {"loss": loss}
