"""AdamW with decoupled weight decay and global-norm clipping, in two
forms.

The tree form (:func:`adamw_init`, :func:`clip_by_global_norm`,
:func:`adamw_tree_update`) is ``repro.optim.adamw`` as the JAX step
builders apply it: the state mirrors the parameter tree with f32
moments and an i32 step, the global norm is taken over every leaf, and
the parameters and moments are updated in place (JAX donates them).

The flat form (:func:`adamw_update`) is
``repro.optim.adamw.adamw_update`` as the multi-model trainer applies
it: ``jax.vmap`` over J flat f32 parameter rows becomes the leading axis
of ``[J, D]`` tensors, and each row's clip norm is the norm of that row.
The moments and the parameters are updated IN PLACE (the JAX arrays are
immutable; at full width each ``[J, D]`` copy is several GB). The clip
norm sums ``D`` squares in another order than XLA, so parameters match
the JAX package within tolerance, not bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.spans import span

__all__ = ["AdamWState", "adamw_update", "adamw_init",
           "clip_by_global_norm", "adamw_tree_update", "tree_leaves"]


@dataclass
class AdamWState:
    """The flat form: ``step`` i32 ``[J]``, ``mu`` / ``nu`` f32 ``[J,
    D]``; the tree form (:func:`adamw_init`): ``step`` i32 ``[]``,
    ``mu`` / ``nu`` f32 trees of the parameters' shapes."""
    step: torch.Tensor    # i32 [J] | i32 []
    mu: torch.Tensor      # first moment, f32 [J, D] | f32 tree
    nu: torch.Tensor      # second moment, f32 [J, D] | f32 tree


def adamw_update(params: torch.Tensor, grads: torch.Tensor,
                 state: AdamWState, *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float | None = 1.0) -> torch.Tensor:
    """One AdamW step of every row of ``params [J, D]`` (f32), in place.

    ``grads [J, D]`` f32 is consumed (scaled in place by the clip).
    Returns the per-row gradient norms ``[J]``. Inside an open span
    recorder (:mod:`repro_torch.core.spans`) the clip is timed as
    ``update.clip`` and the moments and parameters as ``update.adamw``.
    """
    with span("update.clip"):
        if max_grad_norm is not None:
            gn = torch.sqrt(torch.sum(torch.square(grads), dim=1))
            scale = torch.clamp(max_grad_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            grads.mul_(scale[:, None])
        else:
            gn = torch.zeros(params.shape[0], device=params.device)
    with span("update.adamw"):
        state.step += 1
        t = state.step.float()[:, None]
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        state.mu.mul_(b1).add_(grads * (1 - b1))
        state.nu.mul_(b2).add_(torch.square(grads).mul_(1 - b2))
        delta = state.mu / bc1
        delta.div_(torch.sqrt(state.nu / bc2).add_(eps))
        delta.add_(params * weight_decay)
        params.sub_(delta.mul_(lr))
    return gn


def tree_leaves(tree) -> list:
    """The tensors of nested dicts in JAX's leaf order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):      # its shards, placed as the leaf
        return torch.zeros_like(tree, dtype=torch.float32)
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def adamw_init(params) -> AdamWState:
    """The tree form's state of ``params`` (nested dicts of tensors): step
    0, f32 zero moments of the parameters' shapes on their devices (of a
    DTensor parameter, a DTensor of its placements)."""
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_zeros_like_tree(params),
                      nu=_zeros_like_tree(params))


def clip_by_global_norm(grads: list, max_norm: float):
    """``repro.optim.adamw.clip_by_global_norm`` over a list of gradient
    leaves: the global norm ``gn`` (f32, over every leaf's f32 squares)
    and the leaves scaled by ``min(1, max_norm / max(gn, 1e-9))`` in f32,
    each rounded back to its own dtype (new tensors)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], gn


def adamw_tree_update(params, grads: list, state: AdamWState, *, lr: float,
                      b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                      weight_decay: float = 0.1,
                      max_grad_norm: float | None = 1.0) -> torch.Tensor:
    """One AdamW step of the tree form, in place: ``params`` (nested
    dicts), ``grads`` their gradients as a list in the order of
    :func:`tree_leaves`, ``state`` from
    :func:`adamw_init`. Each parameter is updated in f32 and rounded to
    its own dtype, as ``repro.optim.adamw.adamw_update``. Returns the
    global gradient norm (f32 0-d; 0 without clipping)."""
    ps = tree_leaves(params)
    if len(grads) != len(ps):
        raise ValueError(f"{len(grads)} gradients for {len(ps)} parameters")
    if max_grad_norm is not None:
        grads, gn = clip_by_global_norm(grads, max_grad_norm)
    else:
        gn = torch.zeros((), device=ps[0].device)
    state.step += 1
    t = state.step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, m, v in zip(ps, grads, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        gf = g.float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
        pf = p.float()
        delta.add_(pf * weight_decay)
        p.copy_(pf.sub_(delta.mul_(lr)))
    return gn
