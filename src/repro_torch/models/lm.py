"""The LMs of the port: init, forward, training loss and serving.

Counterpart of ``repro.models.lm`` for the dense family (``attn`` and
``local`` sublayers with an MLP), the MoE family (the same sublayers
with a top-k expert block in place of the MLP, its load-balancing term
added to the loss), the SSM family (``ssm`` sublayers:
Mamba2's SSD block, no MLP), the hybrid family (zamba2: ``ssm``
sublayers and a ``shared_attn`` block, one attention + MLP parameter set
reused at every occurrence), the enc-dec family (seamless: a
bidirectional encoder over projected audio frames, ``params["enc"]``,
and decoder ``attn`` slots with a cross-attention to its memory) and
the ViT frontend (internvl2: projected patches in place of the first
``frontend_len`` token embeddings): ``init_params`` (same shapes, dtypes and
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
occurrence keeps its own keys), an enc-dec decoder slot's also
``"cross": {"k", "v": [R, B, Hkv, Ts, Dh]}`` (the encoder memory's k/v,
written by the prefill in the memory's dtype, read by every decode
step), an SSM slot's ``{"state": f32[R, B|slots, H, S, P]}``
(recurrent: no sequence axis, no page table).

Parameters are nested dicts of tensors; stacked-layer leaves keep their
leading ``repeats`` axis (the encoder's ``n_enc_layers``), the shared
block lives once, unstacked, in ``params["shared"]`` and the frontend
projection in ``params["front"]["w"]``, as in the JAX package, so the
flat layout of :func:`repro_torch.weights.ravel` matches
``ravel_pytree``.

Rematerialisation follows JAX's ``cfg.remat``. At ``"block"`` (JAX's
default) a training forward under autograd runs each pattern unit (all
its slots, with ``params["shared"]`` and an enc-dec decoder's encoder
memory), each encoder unit and each loss chunk (logits to summed NLL)
under a non-reentrant ``torch.utils.checkpoint``, as JAX wraps the same
bodies in ``jax.checkpoint``: a unit keeps its input and the backward
recomputes the rest, one unit at a time. Torch stops a recompute at the
last tensor the backward needs, as XLA drops a recomputed product that
no residual reads (a unit's last MLP product). Prefill, decode and a
forward without grad are not checkpointed (nothing runs backward);
``"none"`` keeps every activation. Both give the same bits: the
recompute runs the same ops on the same inputs.

``param_specs`` and ``cache_specs`` give the logical axes of every
parameter and cache leaf (JAX's trees). Under a mesh (the step builders'
``axis_rules``; the parameters, batch and cache DTensors) the residual
stream is constrained to JAX's sequence-parallel layout ``("batch",
"seq", "embed")`` after the embedding, after each sublayer's output is
added and at the end of each unit (a row-parallel output's partial sum
becomes a reduce-scatter there), the loss is computed on vocab-split
logits (:func:`_chunked_loss`), a prefill reads its last
position without gathering the stream (:func:`_last`), and
``init_cache`` lays the cache out by ``cache_specs``. Without a mesh
none of this runs and every path is what it was.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import ModelConfig
from ..kernels import ops
from ..launch import partitioning as pt
from ..launch.partitioning import constrain
from . import layers as L

__all__ = ["slot_names", "init_params", "param_specs", "cache_specs",
           "train_loss", "init_cache", "init_paged_cache", "admit_prefill",
           "prefill", "decode_step", "poisoned_rows", "DECODE_ROWS"]

#: the residual stream's layout between blocks: batch over data, the
#: sequence over model (Megatron-SP), features whole
SP = ("batch", "seq", "embed")


def slot_names(cfg: ModelConfig) -> list[str]:
    return [f"{i}_{kind}" for i, kind in enumerate(cfg.pattern)]


def _has_cross(cfg: ModelConfig, kind: str) -> bool:
    """A decoder slot with a cross-attention: every ``attn`` slot of an
    enc-dec model (the encoder's blocks are dense and have none)."""
    return cfg.family == "encdec" and kind == "attn"


def _normal(gen, shape, dtype, scale, device=None):
    """``randn * scale``, scaled in place: no second copy of the leaf
    (moonshot's stacked expert leaves are 17.7 GB each in bf16). With no
    generator, an empty leaf on ``device`` (on ``"meta"``: a shape,
    nothing allocated)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return x.mul_(scale)


def _init_slot(gen, cfg: ModelConfig, kind: str, R: int | None,
               device) -> dict:
    """One slot's parameters, stacked over a leading axis of ``R``
    repeats (``None``: no leading axis, the shared block)."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, sc = cfg.torch_dtype, d ** -0.5
    lead = () if R is None else (R,)

    def z(*shape):
        return torch.zeros((*lead, *(shape or (d,))), dtype=torch.float32,
                           device=device)

    def w(*shape, scale):
        return _normal(gen, (*lead, *shape), dt, scale, device)

    if kind not in ("attn", "local", "shared_attn", "ssm"):
        raise ValueError(f"unknown sublayer kind {kind!r}")
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
    def attention():
        return {"wq": w(d, hq * dh, scale=sc), "wk": w(d, hkv * dh, scale=sc),
                "wv": w(d, hkv * dh, scale=sc), "wo": w(hq * dh, d, scale=sc)}

    p = {"norm1": z(), "attn": attention(), "norm2": z()}
    if _has_cross(cfg, kind):
        p["norm_x"] = z()
        p["cross"] = attention()
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


def init_params(cfg: ModelConfig, gen: torch.Generator | None, *,
                device=None) -> dict:
    """Random parameters on the generator's device (``gen=None`` with
    ``device="meta"``: the same tree on ``meta``, nothing allocated: the
    dry run's parameters); a ``shared_attn``
    slot has no entry in ``params["blocks"]``: its one parameter set,
    with no ``repeats`` axis, is ``params["shared"]``. An enc-dec model
    adds ``params["enc"] = {"blocks": <a dense attn slot stacked over
    n_enc_layers>, "norm"}``, a frontend ``params["front"]["w"]
    [frontend_dim, d]``."""
    d, V = cfg.d_model, cfg.vocab_padded
    dev = gen.device if gen is not None else torch.device(device)
    params = {
        "embed": _normal(gen, (V, d), cfg.torch_dtype, d ** -0.5, dev),
        "norm_f": torch.zeros((d,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["out"] = _normal(gen, (d, V), cfg.torch_dtype, d ** -0.5, dev)
    params["blocks"] = {name: _init_slot(gen, cfg, kind, cfg.repeats, dev)
                        for name, kind in zip(slot_names(cfg), cfg.pattern)
                        if kind != "shared_attn"}
    if "shared_attn" in cfg.pattern:
        params["shared"] = _init_slot(gen, cfg, "shared_attn", None, dev)
    if cfg.n_enc_layers:
        params["enc"] = {
            "blocks": _init_slot(gen, cfg.replace(family="dense"), "attn",
                                 cfg.n_enc_layers, dev),
            "norm": torch.zeros((d,), dtype=torch.float32, device=dev)}
    if cfg.frontend:
        params["front"] = {"w": _normal(gen, (cfg.frontend_dim, d),
                                        cfg.torch_dtype,
                                        cfg.frontend_dim ** -0.5, dev)}
    return params


def _spec_slot(cfg: ModelConfig, kind: str) -> dict:
    if kind == "ssm":
        return {"norm": (None,), "ssm": L.spec_ssm(cfg)}
    p = {"norm1": (None,), "attn": L.spec_attention(cfg), "norm2": (None,)}
    if cfg.n_experts:
        p["moe"] = L.spec_moe(cfg)
    else:
        p["mlp"] = L.spec_mlp(cfg)
    if _has_cross(cfg, kind):
        p["norm_x"] = (None,)
        p["cross"] = L.spec_attention(cfg)
    return p


def _lead(tree):
    """A spec tree with an unsharded leading (stacked-layer) axis."""
    if isinstance(tree, dict):
        return {k: _lead(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def param_specs(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in the tree of
    :func:`init_params` (JAX's ``lm.param_specs``)."""
    specs: dict = {"embed": (L.VOCAB, L.EMBED), "norm_f": (None,)}
    if not cfg.tie_embeddings:
        specs["out"] = (L.EMBED, L.VOCAB)
    specs["blocks"] = {name: _lead(_spec_slot(cfg, kind))
                       for name, kind in zip(slot_names(cfg), cfg.pattern)
                       if kind != "shared_attn"}
    if "shared_attn" in cfg.pattern:
        specs["shared"] = _spec_slot(cfg, "shared_attn")
    if cfg.n_enc_layers:
        specs["enc"] = {
            "blocks": _lead(_spec_slot(cfg.replace(family="dense"), "attn")),
            "norm": (None,)}
    if cfg.frontend:
        specs["front"] = {"w": (None, L.EMBED)}
    return specs


def cache_specs(cfg: ModelConfig) -> dict:
    """Logical axes of the decode cache (JAX's ``lm.cache_specs``): batch
    over data, the cache *sequence* over model (flash-decode style: kv
    head counts are often below the model axis, the sequence always
    divides it)."""
    spec = {}
    for name, kind in zip(slot_names(cfg), cfg.pattern):
        if kind == "ssm":
            spec[name] = {"state": (None, "batch", "ssm_heads", None, None)}
            continue
        kv = {"k": (None, "batch", None, "seq_kv", None),
              "v": (None, "batch", None, "seq_kv", None)}
        ent = {"self": kv}
        if _has_cross(cfg, kind):
            ent["cross"] = dict(kv)
        spec[name] = ent
    return spec


def _cross(cfg, p, h, memory, cache, cache_index, mode):
    """The cross-attention of an enc-dec decoder slot over the encoder
    memory. Training and a prefill attend over ``memory`` (a prefill
    through the kernel, writing the memory's k/v into ``cache["cross"]``);
    a decode step reads the cross cache as it is, its ``len(cache_index)``
    real rows through ``ops.attention`` (no ``valid_len``: the kernel on a
    card, as JAX routes it through Pallas) and the padding rows 0."""
    if mode != "decode":
        out, kv = L.attention_block(p, h, None, cfg, causal=False,
                                    memory=memory, train=(mode == "train"))
        if cache is not None:
            for key in ("k", "v"):
                cache["cross"][key].copy_(kv[key])
        return out
    ck = cache["cross"]
    B = h.shape[0]
    n = B if torch.is_tensor(cache_index) else len(cache_index)
    q = L.dense(h, p["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd).transpose(1, 2)
    if pt.is_dtensor(q):         # the device lane: every row real
        o = L._attend(ops.attention, q, ck["k"], ck["v"], causal=False)
    else:
        o = torch.zeros_like(q)
        o[:n] = ops.attention(q[:n], ck["k"], ck["v"], causal=False)
    return L.dense(o.transpose(1, 2).reshape(B, 1, -1), p["wo"])


def _apply_slot(cfg, kind, p, x, positions, *, cache=None,
                cache_index=None, mode="train", mesh=None, memory=None,
                train=None):
    """One sublayer; returns ``(x, aux)``, ``aux`` the MoE load-balancing
    term (None without an expert block); ``cache`` is written in place.
    ``mode``: ``train`` / ``prefill`` / ``decode``, or ``encoder``
    (bidirectional, no cache: the encoder of a training step or, with
    ``train=False``, of a prefill, whose attention takes the kernel). An
    enc-dec decoder slot adds ``x + cross(rms_norm(x, norm_x))`` after
    its self-attention (:func:`_cross`, over ``memory``; the encoder's
    own slots are dense). An ``ssm`` slot has no MLP: ``x +
    ssm_block(rms_norm(x))``, its training pass through the plain
    differentiable scan, its prefill writing the final state into the
    cache and its decode step the live rows' states. A ``shared_attn``
    slot is attention (window ``cfg.window``) + MLP, as ``attn``. With
    ``cfg.n_experts`` the MLP is :func:`~repro_torch.models.layers.
    moe_block` (over the virtual ``mesh``, if given); a decode step
    dispatches only its ``len(cache_index)`` real rows (finished ones
    included, as the JAX step does), not its padding."""
    aux = None
    train = mode == "train" if train is None else train
    if kind == "ssm":
        h = L.rms_norm(x, p["norm"])
        if mode == "decode":
            h, _ = L.ssm_block(p["ssm"], h, cfg, state=cache["state"],
                               rows=cache_index)
        else:
            h, st = L.ssm_block(p["ssm"], h, cfg, train=train,
                                return_state=cache is not None)
            if cache is not None:
                cache["state"].copy_(pt.constrain(
                    st, ("batch", "ssm_heads", None, None)))
        return x + constrain(h, SP), aux
    window = cfg.local_window if kind == "local" else cfg.window
    h = L.rms_norm(x, p["norm1"])
    h, _ = L.attention_block(
        p["attn"], h, positions, cfg, window=window,
        softcap=cfg.attn_softcap, causal=(mode != "encoder"),
        cache=cache["self"] if cache is not None else None,
        cache_index=cache_index, train=train)
    # reduce-scatter the row-parallel output into the SP layout
    x = x + constrain(h, SP)
    if _has_cross(cfg, kind):
        x = x + constrain(_cross(cfg, p["cross"], L.rms_norm(x, p["norm_x"]),
                                 memory, cache, cache_index, mode), SP)
    h = L.rms_norm(x, p["norm2"])
    if cfg.n_experts:
        h, aux = L.moe_block(p["moe"], h, cfg, mesh=mesh, rows=(
            len(cache_index) if mode == "decode"
            and not torch.is_tensor(cache_index) else None))
    else:
        h = L.mlp_block(p["mlp"], h, cfg)
    return x + constrain(h, SP), aux


def _layer(tree, r: int):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree, R: int) -> list:
    """The ``R`` layers of a stacked parameter tree, by one ``unbind``
    per leaf: its backward is one ``stack`` of the layers' gradients,
    where indexing each layer would make every layer's gradient a
    zero-filled copy of the whole stacked leaf (bytes growing with
    ``R**2``)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, R) for k, v in tree.items()}
        return [{k: subs[k][r] for k in subs} for r in range(R)]
    return list(tree.unbind(0))


def _remat(cfg: ModelConfig, train: bool) -> bool:
    """Whether a training forward checkpoints its units and loss chunks:
    ``cfg.remat == "block"`` under autograd."""
    return train and cfg.remat == "block" and torch.is_grad_enabled()


def _checkpointed(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint: the callers take
    gradients with ``torch.autograd.grad`` to leaves, which the reentrant
    mode refuses. No training forward draws random numbers, so the
    recompute keeps no RNG state (and runs on ``meta`` as on a card)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _units(cfg, params, x, positions, *, cache=None, cache_index=None,
           mode="train", mesh=None, memory=None):
    """The pattern repetitions in order (``lax.scan`` in the JAX package);
    returns ``(x, aux)``, the MoE term summed over the layers (None
    without an MoE block). ``cache`` (stacked over ``repeats``, as the
    params) is updated in place, one layer's view at a time. A
    ``shared_attn`` slot takes
    ``params["shared"]`` as it is at every repeat (it has no ``repeats``
    axis to index) and its own repeat's cache. ``memory``: the encoder
    output an enc-dec decoder's cross-attention reads (training and
    prefill). A training unit runs checkpointed under ``cfg.remat ==
    "block"`` (:func:`_remat`)."""
    slots = list(zip(slot_names(cfg), cfg.pattern))
    layers = {name: _unstack(params["blocks"][name], cfg.repeats)
              for name, kind in slots if kind != "shared_attn"}

    def unit(x, aux, ps, cs):
        for (name, kind), p, c in zip(slots, ps, cs):
            x, a = _apply_slot(cfg, kind, p, x, positions, cache=c,
                               cache_index=cache_index, mode=mode,
                               mesh=mesh, memory=memory)
            if a is not None:
                aux = a if aux is None else aux + a
        return constrain(x, SP), aux

    remat = _remat(cfg, mode == "train")
    aux = None
    for r in range(cfg.repeats):
        ps = [params["shared"] if kind == "shared_attn" else layers[name][r]
              for name, kind in slots]
        cs = [_layer(cache[name], r) if cache is not None else None
              for name, _ in slots]
        x, aux = (_checkpointed(unit, x, aux, ps, cs) if remat
                  else unit(x, aux, ps, cs))
    return x, aux


def _embed_tokens(cfg, params, tokens):
    if pt.is_dtensor(params["embed"]):
        # the table gathered over data (FSDP), its vocab split over model:
        # each shard looks up the ids it holds (a masked partial sum)
        x = constrain(F.embedding(tokens.long(),
                                  pt.gather_data(params["embed"])), SP)
    else:
        x = params["embed"][torch.as_tensor(tokens).long()]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _embed(cfg, params, batch):
    """The token embeddings of ``batch["tokens"] [B, T]``; a ViT model's
    projected ``batch["patches"] [B, P, frontend_dim]``, cast to the
    embedding dtype, take the place of the first ``P`` positions. A
    prompt shorter than the patches is refused (JAX's ``_embed`` returns
    ``P`` positions for it, the prompt's tokens dropped)."""
    x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend == "vit":
        patches = L.dense(torch.as_tensor(batch["patches"]).to(x.device),
                          params["front"]["w"])
        n = patches.shape[1]
        if x.shape[1] < n:
            raise ValueError(f"{cfg.name}: a prompt of {x.shape[1]} tokens "
                             f"is shorter than its {n} patch positions")
        x = torch.cat([patches.to(x.dtype), x[:, n:]], dim=1)
    return constrain(x, SP)


def _encoder(cfg, params, frames, *, train):
    """The bidirectional encoder over ``frames [B, Ts, frontend_dim]``
    (projected by ``params["front"]["w"]``, in the frames' dtype): dense
    ``attn`` slots with RoPE at ``arange(Ts)``, then ``rms_norm``. Its
    attention is the plain one in training and ``ops.attention`` (the
    kernel on a card) in a prefill. A training unit runs checkpointed
    under ``cfg.remat == "block"``, as JAX's encoder scan body."""
    frames = torch.as_tensor(frames).to(params["front"]["w"].device)
    x = L.dense(frames, params["front"]["w"])
    positions = torch.arange(x.shape[1], device=x.device)
    dense = cfg.replace(family="dense")
    enc = _unstack(params["enc"]["blocks"], cfg.n_enc_layers)

    def unit(x, p):
        return _apply_slot(dense, "attn", p, x, positions, mode="encoder",
                           train=train)[0]

    remat = _remat(cfg, train)
    for r in range(cfg.n_enc_layers):
        x = _checkpointed(unit, x, enc[r]) if remat else unit(x, enc[r])
    return L.rms_norm(x, params["enc"]["norm"])


def _logits(cfg, params, x):
    out_w = params["embed"].T if cfg.tie_embeddings else params["out"]
    lg = L.dense(x, out_w).float()
    if cfg.final_softcap:
        lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
    return lg


def _chunked_loss(cfg, params, x, labels):
    """Cross-entropy over seq chunks of the logits (memory: O(chunk *
    vocab)); vocab padding is masked, label ``-1`` is ignored. Under
    ``cfg.remat == "block"`` each chunk's logits-to-NLL runs
    checkpointed, so the backward recomputes one chunk's ``[B, C,
    vocab]`` logits at a time where it would keep all of them; the count
    of valid labels (integers, no gradient) stays outside. On DTensors,
    JAX's sharding-friendly form: the residual stream gathered over the
    sequence once and each chunk's logits split over the vocab (model
    axis), so only ``[B, C]`` scalars cross shards (:func:`_nll_parts`)."""
    B, T, D = x.shape
    C = min(cfg.loss_chunk, T)
    assert T % C == 0
    if pt.is_dtensor(x):
        x = pt.constrain(x, ("batch", None, "embed"))

    def chunk_nll(xc, li):
        m, s, gold = _nll_parts(cfg, _logits(cfg, params, xc), li)
        return torch.where(li >= 0, m + torch.log(s) - gold, 0.0).sum()

    remat = _remat(cfg, True)
    tot = cnt = None
    for c in range(T // C):
        xc, li = x[:, c * C:(c + 1) * C], labels[:, c * C:(c + 1) * C].long()
        nll = (_checkpointed(chunk_nll, xc, li) if remat
               else chunk_nll(xc, li))
        n = (li >= 0).sum()
        tot = nll if tot is None else tot + nll
        cnt = n if cnt is None else cnt + n
    return tot / torch.clamp(cnt, min=1)


def _nll_parts(cfg, lg, li):
    """The pieces of a chunk's NLL from its logits ``lg [B, C, V]`` and
    labels ``li [B, C]``: the row max ``m``, ``s = sum(exp(lg - m))`` and
    the gold logit, the padding past ``cfg.vocab`` masked. On DTensors
    each rank works on its vocab shard (``local_map``): ``m`` is the
    shards' maxima reduced (no gradient flows through it, none would: it
    cancels in ``m + log(s)``), ``s`` and the gold logit (a comparison
    with the shard's vocab ids, summed) ``Partial`` sums over the vocab's
    shards. Left to DTensor's cost model, the backward gathers the
    chunk's whole vocab on every rank."""
    if not pt.is_dtensor(lg):
        vocab_ids = torch.arange(lg.shape[-1], device=lg.device)
        lg = torch.where(vocab_ids < cfg.vocab, lg,
                         torch.tensor(-1e30, device=lg.device))
        m = torch.amax(lg, dim=-1)
        s = torch.sum(torch.exp(lg - m[..., None]), dim=-1)
        gold = torch.gather(lg, -1, torch.clamp(li, min=0)[..., None])[..., 0]
        return m, s, gold
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = lg.device_mesh
    v_dims = [i for i, p in enumerate(lg.placements) if p.is_shard(2)]
    ids = pt.sharded_iota(lg.shape[-1], lg, 2)
    li = li.redistribute(mesh, tuple(Replicate() if i in v_dims else p
                                     for i, p in enumerate(lg.placements)))
    rows = tuple(li.placements)
    part = tuple(Partial() if i in v_dims else p for i, p in enumerate(rows))

    def parts(lg, ids, li):
        lg = torch.where(ids < cfg.vocab, lg, -1e30)
        m = torch.amax(lg, dim=-1).detach()
        for i in v_dims:
            m = all_reduce(m, "max", (mesh, i))
        s = torch.sum(torch.exp(lg - m[..., None]), dim=-1)
        gold = torch.sum(torch.where(ids == torch.clamp(li, min=0)[..., None],
                                     lg, 0.0), dim=-1)
        return m, s, gold

    ins = (tuple(lg.placements), tuple(ids.placements), rows)
    return local_map(parts, out_placements=(rows, part, part),
                     in_placements=ins,
                     in_grad_placements=ins,
                     device_mesh=mesh)(lg, ids, li)


def train_loss(cfg: ModelConfig, params, batch, *, mesh=None):
    """batch: ``tokens``, ``labels`` int ``[B, T]`` (+ ``frames`` for an
    enc-dec model, ``patches`` for a ViT one) -> (loss, metrics
    ``{"loss", "moe_aux"}``). An MoE model's loss holds ``0.01 * aux /
    n_layers``, as the JAX package's; ``mesh=(n_data, n_model)`` runs
    its expert blocks on that virtual mesh (:func:`~repro_torch.models.
    layers.moe_block`)."""
    memory = (_encoder(cfg, params, batch["frames"], train=True)
              if cfg.family == "encdec" else None)
    x = _embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _units(cfg, params, x, positions, mesh=mesh, memory=memory)
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
def _ssm_state(cfg: ModelConfig, rows: int, device, make=None) -> dict:
    P = cfg.ssm_d_inner // cfg.ssm_heads
    make = make or functools.partial(torch.zeros, device=device)
    return {"state": make((cfg.repeats, rows, cfg.ssm_heads, cfg.ssm_state,
                           P), dtype=torch.float32)}


@dataclass(frozen=True)
class _Leaf:
    """A leaf's shape and dtype, no storage: the template a sharded cache
    is laid out from."""
    shape: tuple
    dtype: torch.dtype


def init_cache(cfg: ModelConfig, B: int, T: int, *, device,
               memory=None) -> dict:
    """Zeroed contiguous decode cache: per attention slot ``{"self":
    {"k", "v": [R, B, Hkv, T, Dh]}}`` in the model dtype, per SSM slot
    ``{"state": f32[R, B, H, S, P]}``; an enc-dec decoder slot also
    ``"cross"`` ``{"k", "v": [R, B, Hkv, Ts, Dh]}`` in the dtype of the
    encoder's ``memory [B, Ts, D]`` (without it JAX's template: ``T``
    and the model dtype). Under an active mesh (:func:`repro_torch.
    launch.partitioning.axis_rules`) every leaf is a DTensor placed by
    :func:`cache_specs`, each rank's shard allocated on ``device``."""
    if pt.current_mesh() is not None:
        return pt.shard_like(_init_cache(cfg, B, T, None, memory, _Leaf),
                             cache_specs(cfg), device)
    return _init_cache(cfg, B, T, device, memory)


def _init_cache(cfg, B, T, device, memory, make=None):
    R, hkv, hd = cfg.repeats, cfg.n_kv_heads, cfg.hd
    make = make or functools.partial(torch.zeros, device=device)

    def z(n=T, dtype=cfg.torch_dtype):
        return make((R, B, hkv, n, hd), dtype=dtype)

    def entry(kind):
        if kind == "ssm":
            return _ssm_state(cfg, B, device, make)
        ent = {"self": {"k": z(), "v": z()}}
        if _has_cross(cfg, kind):
            n, dt = ((T, cfg.torch_dtype) if memory is None
                     else (memory.shape[1], memory.dtype))
            ent["cross"] = {"k": z(n, dt), "v": z(n, dt)}
        return ent

    return {name: entry(kind)
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
    admission. An enc-dec model is refused, as the JAX package refuses
    it: its cross caches have no paged layout."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "paged decode does not support enc-dec cross caches; use "
            "the legacy generate() path")
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
    :func:`train_loss`. An enc-dec model's ``batch["frames"] [B, Ts,
    frontend_dim]`` go through the encoder (its attention through the
    kernel) and each decoder slot's cross cache holds the memory's k/v
    in the frames' dtype (f32 frames on a bf16 model: f32 cross caches
    beside bf16 self caches, as in JAX); a ViT model's
    ``batch["patches"]`` replace the first positions (:func:`_embed`)."""
    x = _embed(cfg, params, batch)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device)
    memory = None
    if cfg.family == "encdec":
        memory = _encoder(cfg, params, batch["frames"], train=False)
    cache = init_cache(cfg, B, max_len or T, device=x.device, memory=memory)
    x, _ = _units(cfg, params, x, positions, cache=cache, cache_index=0,
                  mode="prefill", mesh=mesh, memory=memory)
    x = L.rms_norm(x, params["norm_f"])
    return _logits(cfg, params, _last(x)), cache


def _last(x):
    """``x[:, -1:]``. A DTensor whose sequence is split takes each
    shard's last position (one row a shard, no data moved), gathers
    those few rows and keeps the last: the whole stream is never
    gathered for one position."""
    if pt.is_dtensor(x) and any(p.is_shard(1) for p in x.placements):
        from torch.distributed.tensor.experimental import local_map
        x = local_map(lambda t: t[:, -1:], out_placements=list(x.placements),
                      in_placements=(x.placements,),
                      device_mesh=x.device_mesh)(x)
        x = pt.constrain(x, ("batch", None, "embed"))
    return x[:, -1:]


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
    a finished row (it writes nothing and sees no key). A 0-d tensor
    takes the device lane of the step builders (JAX's scalar
    ``cache_index``): every one of any number of rows at that position of
    a contiguous cache, no padding to ``DECODE_ROWS``, and nothing read
    back to the host (see :func:`_decode_step_device`). Each row attends
    over exactly its valid keys (see
    :func:`repro_torch.models.layers.attention_block`); an SSM row's
    recurrence runs at the same fixed width and a finished row writes no
    state (see :func:`repro_torch.models.layers.ssm_block`); an MoE
    block routes the ``B`` rows (finished ones too) with the capacity of
    ``B`` tokens, its expert products at the fixed width's shape; an
    enc-dec slot's cross-attention reads its cross cache for the ``B``
    real rows (:func:`_cross`); ``mesh`` as in :func:`train_loss`.
    """
    if torch.is_tensor(cache_index):
        return _decode_step_device(cfg, params, cache, tokens, cache_index,
                                   mesh=mesh)
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
    x = _embed_tokens(cfg, params, tokens)
    x, _ = _units(cfg, params, x, positions, cache=cache, cache_index=rows,
                  mode="decode", mesh=mesh)
    x = L.rms_norm(x, params["norm_f"])
    return _logits(cfg, params, x)[:B], cache


def _decode_step_device(cfg, params, cache, tokens, cache_index, *,
                        mesh=None):
    """:func:`decode_step` at a device-side position, the twin of JAX's
    ``decode_step`` with a scalar ``cache_index``: tokens ``[B, 1]``, any
    ``B``, every row at position ``cache_index`` (an i32 0-d tensor on the
    cache's device) of the contiguous ``cache``, which is written in
    place. Attention writes each row's k/v there and attends over the
    whole cache with the keys past it masked; an SSM slot advances every
    row's state; an MoE block routes all ``B`` rows. No value is read
    back to the host, so the step runs on ``"meta"`` (the dry run) as on
    a card."""
    if cache_index.dim() != 0:
        raise ValueError(f"a device-side cache_index is a 0-d tensor, got "
                         f"shape {tuple(cache_index.shape)}")
    B = tokens.shape[0]
    positions = cache_index.long().reshape(1, 1).expand(B, 1)
    x = _embed_tokens(cfg, params, tokens)
    x, _ = _units(cfg, params, x, positions, cache=cache,
                  cache_index=cache_index, mode="decode", mesh=mesh)
    x = L.rms_norm(x, params["norm_f"])
    return _logits(cfg, params, x), cache


def poisoned_rows(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Poisoned-output sentinel (DESIGN.md §15): ``logits [..., V]`` ->
    bool ``[...]``, True where a row's logits over the real (unpadded)
    vocab hold a non-finite value."""
    return ~torch.isfinite(logits[..., :vocab]).all(dim=-1)
