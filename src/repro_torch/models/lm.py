"""Decoder LMs of the port: init, forward, training loss and serving.

Counterpart of ``repro.models.lm`` for the dense family (``attn`` and
``local`` sublayers with an MLP), the MoE family (the same sublayers
with a top-k expert block in place of the MLP, its load-balancing term
added to the loss), the SSM family (``ssm`` sublayers:
Mamba2's SSD block, no MLP) and the hybrid family (zamba2: ``ssm``
sublayers and a ``shared_attn`` block, one attention + MLP parameter set
reused at every occurrence): ``init_params`` (same shapes, dtypes and
scales, drawn from a ``torch.Generator`` — the numbers differ from
``jax.random``; tests start both packages from the same exported
weights, see :mod:`repro_torch.weights`), ``_embed``, the unit loop (a
Python loop over the stacked ``repeats`` axis in place of
``lax.scan``), ``_logits``, ``_chunked_loss`` and ``train_loss``; and
the serving half (``init_cache``, ``init_paged_cache``,
``admit_prefill``, ``prefill``, ``decode_step``, ``poisoned_rows``).
Caches are updated in place (the JAX package returns new arrays): each
entry point returns the cache it was given, written. An attention
slot's cache entry is ``{"self": {"k", "v"[, "pages"]}}``, stacked over
``repeats`` (a ``shared_attn`` slot too: its weights are shared, each
occurrence keeps its own keys), an SSM slot's ``{"state": f32[R,
B|slots, H, S, P]}`` (recurrent: no sequence axis, no page table).

Parameters are nested dicts of tensors; stacked-layer leaves keep their
leading ``repeats`` axis and the shared block lives once, unstacked, in
``params["shared"]``, as in the JAX package, so the flat layout of
:func:`repro_torch.weights.ravel` matches ``ravel_pytree``. There is no
rematerialisation: at the slice's sizes activations are small beside
the parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import ModelConfig
from . import layers as L

__all__ = ["slot_names", "init_params", "train_loss", "init_cache",
           "init_paged_cache", "admit_prefill", "prefill", "decode_step",
           "poisoned_rows", "DECODE_ROWS"]

_PORTED_KINDS = ("attn", "local", "shared_attn", "ssm")


def slot_names(cfg: ModelConfig) -> list[str]:
    return [f"{i}_{kind}" for i, kind in enumerate(cfg.pattern)]


def _check_ported(cfg: ModelConfig) -> None:
    """The families the port serves and trains: dense decoders, the MoE
    family, the SSM family and the hybrid (zamba2) family."""
    bad = [k for k in cfg.pattern if k not in _PORTED_KINDS]
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid")
            or cfg.n_enc_layers or cfg.frontend or bad):
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder, MoE, SSM (mamba2) and "
            "hybrid (zamba2) paths are ported; enc-dec and frontend models "
            "wait for ROADMAP.md, Queue 1 item 8 (the rest of the zoo)")


def _normal(gen, shape, dtype, scale):
    """``randn * scale``, scaled in place: no second copy of the leaf
    (moonshot's stacked expert leaves are 17.7 GB each in bf16)."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return x.mul_(scale)


def _init_slot(gen, cfg: ModelConfig, kind: str, R: int | None) -> dict:
    """One slot's parameters, stacked over a leading axis of ``R``
    repeats (``None``: no leading axis, the shared block)."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, sc = cfg.torch_dtype, d ** -0.5
    lead = () if R is None else (R,)

    def z(*shape):
        return torch.zeros((*lead, *(shape or (d,))), dtype=torch.float32,
                           device=gen.device)

    def w(*shape, scale):
        return _normal(gen, (*lead, *shape), dt, scale)

    if kind == "ssm":
        di, H, S = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
        return {
            "norm": z(),
            "ssm": {"w_in": w(d, di, scale=sc),
                    "w_gate": w(d, di, scale=sc),
                    # B/C group-shared across heads (n_groups=1)
                    "w_bc": w(d, 2 * S, scale=sc),
                    "w_dt": w(d, H, scale=sc),
                    "a_log": z(H),
                    "skip": z(H) + 0.1,          # D residual term
                    "w_out": w(di, d, scale=di ** -0.5)},
        }
    p = {
        "norm1": z(),
        "attn": {"wq": w(d, hq * dh, scale=sc),
                 "wk": w(d, hkv * dh, scale=sc),
                 "wv": w(d, hkv * dh, scale=sc),
                 "wo": w(hq * dh, d, scale=sc)},
        "norm2": z(),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        p["moe"] = {"router": w(d, E, scale=sc),
                    "w_gate": w(E, d, f, scale=sc),
                    "w_up": w(E, d, f, scale=sc),
                    "w_down": w(E, f, d, scale=f ** -0.5)}
    else:
        p["mlp"] = {"w_gate": w(d, f, scale=sc),
                    "w_up": w(d, f, scale=sc),
                    "w_down": w(f, d, scale=f ** -0.5)}
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on the generator's device; a ``shared_attn``
    slot has no entry in ``params["blocks"]``: its one parameter set,
    with no ``repeats`` axis, is ``params["shared"]``."""
    _check_ported(cfg)
    d, V = cfg.d_model, cfg.vocab_padded
    params = {
        "embed": _normal(gen, (V, d), cfg.torch_dtype, d ** -0.5),
        "norm_f": torch.zeros((d,), dtype=torch.float32, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["out"] = _normal(gen, (d, V), cfg.torch_dtype, d ** -0.5)
    params["blocks"] = {name: _init_slot(gen, cfg, kind, cfg.repeats)
                        for name, kind in zip(slot_names(cfg), cfg.pattern)
                        if kind != "shared_attn"}
    if "shared_attn" in cfg.pattern:
        params["shared"] = _init_slot(gen, cfg, "shared_attn", None)
    return params


def _apply_slot(cfg, kind, p, x, positions, *, cache=None,
                cache_index=None, mode="train", mesh=None):
    """One sublayer; returns ``(x, aux)``, ``aux`` the MoE load-balancing
    term (None without an expert block); ``cache`` is written in place.
    ``mode``: ``train`` / ``prefill`` / ``decode``, or ``encoder``
    (bidirectional). An ``ssm`` slot has no MLP: ``x +
    ssm_block(rms_norm(x))``, its training pass through the plain
    differentiable scan, its prefill writing the final state into the
    cache and its decode step the live rows' states. A ``shared_attn``
    slot is attention (window ``cfg.window``) + MLP, as ``attn``. With
    ``cfg.n_experts`` the MLP is :func:`~repro_torch.models.layers.
    moe_block` (over the virtual ``mesh``, if given); a decode step
    dispatches only its ``len(cache_index)`` real rows (finished ones
    included, as the JAX step does), not its padding."""
    aux = None
    if kind == "ssm":
        h = L.rms_norm(x, p["norm"])
        if mode == "decode":
            h, _ = L.ssm_block(p["ssm"], h, cfg, state=cache["state"],
                               rows=cache_index)
        else:
            h, st = L.ssm_block(p["ssm"], h, cfg, train=(mode == "train"),
                                return_state=cache is not None)
            if cache is not None:
                cache["state"].copy_(st)
        return x + h, aux
    window = cfg.local_window if kind == "local" else cfg.window
    h = L.rms_norm(x, p["norm1"])
    h, _ = L.attention_block(
        p["attn"], h, positions, cfg, window=window,
        softcap=cfg.attn_softcap, causal=(mode != "encoder"),
        cache=cache["self"] if cache is not None else None,
        cache_index=cache_index)
    x = x + h
    h = L.rms_norm(x, p["norm2"])
    if cfg.n_experts:
        h, aux = L.moe_block(p["moe"], h, cfg, mesh=mesh, rows=(
            len(cache_index) if mode == "decode" else None))
    else:
        h = L.mlp_block(p["mlp"], h, cfg)
    return x + h, aux


def _layer(tree, r: int):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _units(cfg, params, x, positions, *, cache=None, cache_index=None,
           mode="train", mesh=None):
    """The pattern repetitions in order (``lax.scan`` in the JAX package);
    returns ``(x, aux)``, the MoE term summed over the layers (None
    without an MoE block). ``cache`` (stacked over ``repeats``, as the
    params) is updated in place, one layer's view at a time. A
    ``shared_attn`` slot takes
    ``params["shared"]`` as it is at every repeat (it has no ``repeats``
    axis to index) and its own repeat's cache."""
    aux = None
    for r in range(cfg.repeats):
        for name, kind in zip(slot_names(cfg), cfg.pattern):
            p = (params["shared"] if kind == "shared_attn"
                 else _layer(params["blocks"][name], r))
            c = _layer(cache[name], r) if cache is not None else None
            x, a = _apply_slot(cfg, kind, p, x, positions, cache=c,
                               cache_index=cache_index, mode=mode,
                               mesh=mesh)
            if a is not None:
                aux = a if aux is None else aux + a
    return x, aux


def _embed(cfg, params, batch):
    x = params["embed"][torch.as_tensor(batch["tokens"]).long()]
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


def train_loss(cfg: ModelConfig, params, batch, *, mesh=None):
    """batch: ``tokens``, ``labels`` int ``[B, T]`` -> (loss, metrics
    ``{"loss", "moe_aux"}``). An MoE model's loss holds ``0.01 * aux /
    n_layers``, as the JAX package's; ``mesh=(n_data, n_model)`` runs
    its expert blocks on that virtual mesh (:func:`~repro_torch.models.
    layers.moe_block`)."""
    _check_ported(cfg)
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _units(cfg, params, x, positions, mesh=mesh)
    x = L.rms_norm(x, params["norm_f"])
    loss = _chunked_loss(cfg, params, x, batch["labels"])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"loss": loss, "moe_aux": aux}


# --------------------------------------------------------------------- #
# serving (DESIGN.md §13)
# --------------------------------------------------------------------- #
def _ssm_state(cfg: ModelConfig, rows: int, device) -> dict:
    P = cfg.ssm_d_inner // cfg.ssm_heads
    return {"state": torch.zeros((cfg.repeats, rows, cfg.ssm_heads,
                                  cfg.ssm_state, P), dtype=torch.float32,
                                 device=device)}


def init_cache(cfg: ModelConfig, B: int, T: int, *, device) -> dict:
    """Zeroed contiguous decode cache: per attention slot ``{"self":
    {"k", "v": [R, B, Hkv, T, Dh]}}`` in the model dtype, per SSM slot
    ``{"state": f32[R, B, H, S, P]}``."""
    _check_ported(cfg)
    R, hkv, hd = cfg.repeats, cfg.n_kv_heads, cfg.hd

    def z():
        return torch.zeros((R, B, hkv, T, hd), dtype=cfg.torch_dtype,
                           device=device)

    return {name: (_ssm_state(cfg, B, device) if kind == "ssm"
                   else {"self": {"k": z(), "v": z()}})
            for name, kind in zip(slot_names(cfg), cfg.pattern)}


def init_paged_cache(cfg: ModelConfig, slots: int, n_pages: int,
                     page_size: int, pages_per_slot: int, *, device) -> dict:
    """Zeroed paged decode cache (DESIGN.md §13): per attention slot one
    physical page pool ``k``/``v`` ``[R, P, Hkv, page, Dh]`` shared by the
    batch slots and the page table ``pages`` ``i32[R, slots, npp]`` (one
    row per layer, as in the JAX package). Physical page 0 is the trash
    page: finished rows write there and the allocator never hands it
    out. An SSM slot's state is recurrent (no sequence axis), so it is a
    per-slot row ``{"state": f32[R, slots, H, S, P]}``, overwritten at
    admission."""
    _check_ported(cfg)
    R, hkv, hd = cfg.repeats, cfg.n_kv_heads, cfg.hd

    def z():
        return torch.zeros((R, n_pages, hkv, page_size, hd),
                           dtype=cfg.torch_dtype, device=device)

    return {name: (_ssm_state(cfg, slots, device) if kind == "ssm"
                   else {"self": {
                       "k": z(), "v": z(),
                       "pages": torch.zeros((R, slots, pages_per_slot),
                                            dtype=torch.int32,
                                            device=device)}})
            for name, kind in zip(slot_names(cfg), cfg.pattern)}


def admit_prefill(cfg: ModelConfig, paged: dict, prefill_cache: dict,
                  pages: torch.Tensor, slot: int) -> dict:
    """Scatter a ``B=1`` prefill cache into the paged pool, in place.

    ``prefill_cache`` comes from :func:`prefill` with ``max_len = n *
    page_size``; ``pages`` is the slot's full page-table row ``i32[npp]``
    whose first ``n`` entries are its physical pages (the rest point at
    the trash page and are never valid under the length mask); an SSM
    slot's state row ``slot`` is overwritten. Pure data movement: every
    cached value lands bit-identical in its page or row.
    """
    for name, kind in zip(slot_names(cfg), cfg.pattern):
        if kind == "ssm":
            paged[name]["state"][:, slot] = prefill_cache[name]["state"][:, 0]
            continue
        ent, src = paged[name]["self"], prefill_cache[name]["self"]
        ps = ent["k"].shape[3]
        R, _, hkv, Tp, hd = src["k"].shape
        if Tp % ps:
            raise ValueError(f"prefill cache length {Tp} is not a multiple "
                             f"of the page size {ps}")
        npg = Tp // ps
        dst = pages[:npg].long()
        for key in ("k", "v"):
            blocks = src[key][:, 0].reshape(R, hkv, npg, ps, hd)
            ent[key][:, dst] = blocks.transpose(1, 2)
        ent["pages"][:, slot] = pages
    return paged


def prefill(cfg: ModelConfig, params, batch, max_len: int | None = None,
            *, mesh=None):
    """Forward pass over the prompt ``batch["tokens"] [B, T]`` that also
    writes the KV cache (sized ``max_len``, default ``T``) -> (logits of
    the last position ``[B, 1, V]`` in f32, cache); ``mesh`` as in
    :func:`train_loss`."""
    _check_ported(cfg)
    x = _embed(cfg, params, batch)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)
    cache = init_cache(cfg, B, max_len or T, device=x.device)
    x, _ = _units(cfg, params, x, positions, cache=cache, cache_index=0,
                  mode="prefill", mesh=mesh)
    x = L.rms_norm(x, params["norm_f"])
    return _logits(cfg, params, x[:, -1:]), cache


#: rows of a decode step: every step of up to this many rows runs its
#: products, norms and logits at this one width (the pad rows carry token
#: 0 and see no key), so a row's bits do not depend on how many other
#: rows share the step — a library product or reduction on a card may
#: sum in another order at another row count, and in bf16 one flipped bit
#: can change a greedy token. It is what lets :class:`repro_torch.
#: runtime.serve.DecodeEngine` batch its slots and still match the
#: ``B=1`` :func:`repro_torch.runtime.serve.generate` bitwise.
DECODE_ROWS = 16


def decode_step(cfg: ModelConfig, params, cache, tokens, cache_index, *,
                mesh=None):
    """One serving step: tokens ``[B, 1]`` + cache -> (logits ``[B, 1,
    V]``, cache), with ``B <= DECODE_ROWS``.

    ``cache_index``: an int (the contiguous cache, every row at one
    position) or host ints, one per row, over a paged cache; ``-1`` marks
    a finished row (it writes nothing and sees no key). Each row attends
    over exactly its valid keys (see
    :func:`repro_torch.models.layers.attention_block`); an SSM row's
    recurrence runs at the same fixed width and a finished row writes no
    state (see :func:`repro_torch.models.layers.ssm_block`); an MoE
    block routes the ``B`` rows (finished ones too) with the capacity of
    ``B`` tokens, its expert products at the fixed width's shape;
    ``mesh`` as in :func:`train_loss`.
    """
    _check_ported(cfg)
    B = tokens.shape[0]
    if B > DECODE_ROWS:
        raise ValueError(f"a decode step takes at most DECODE_ROWS = "
                         f"{DECODE_ROWS} rows, got {B}")
    dev = params["embed"].device
    if np.ndim(cache_index) == 0:
        rows = [int(cache_index)] * B
        positions = torch.full((DECODE_ROWS, 1), int(cache_index),
                               dtype=torch.long, device=dev)
    else:
        rows = [int(i) for i in cache_index]
        positions = torch.tensor([max(i, 0) for i in rows]
                                 + [0] * (DECODE_ROWS - B),
                                 device=dev)[:, None]
    tokens = torch.cat([tokens, tokens.new_zeros((DECODE_ROWS - B, 1))])
    x = _embed(cfg, params, {"tokens": tokens})
    x, _ = _units(cfg, params, x, positions, cache=cache, cache_index=rows,
                  mode="decode", mesh=mesh)
    x = L.rms_norm(x, params["norm_f"])
    return _logits(cfg, params, x)[:B], cache


def poisoned_rows(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Poisoned-output sentinel (DESIGN.md §15): ``logits [..., V]`` ->
    bool ``[...]``, True where a row's logits over the real (unpadded)
    vocab hold a non-finite value."""
    return ~torch.isfinite(logits[..., :vocab]).all(dim=-1)
