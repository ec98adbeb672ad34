"""AdamW with decoupled weight decay and global-norm clipping, batched
over a leading job axis.

Counterpart of ``repro.optim.adamw.adamw_update`` as the multi-model
trainer applies it: ``jax.vmap`` over J flat f32 parameter rows becomes
the leading axis of ``[J, D]`` tensors, and each row's clip norm is the
norm of that row. The moments and the parameters are updated IN PLACE
(the JAX arrays are immutable; at full width each ``[J, D]`` copy is
several GB). The clip norm sums ``D`` squares in another order than
XLA, so parameters match the JAX package within tolerance, not bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["AdamWState", "adamw_update"]


@dataclass
class AdamWState:
    step: torch.Tensor    # i32 [J]
    mu: torch.Tensor      # first moment, f32 [J, D]
    nu: torch.Tensor      # second moment, f32 [J, D]


def adamw_update(params: torch.Tensor, grads: torch.Tensor,
                 state: AdamWState, *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float | None = 1.0) -> torch.Tensor:
    """One AdamW step of every row of ``params [J, D]`` (f32), in place.

    ``grads [J, D]`` f32 is consumed (scaled in place by the clip).
    Returns the per-row gradient norms ``[J]``.
    """
    if max_grad_norm is not None:
        gn = torch.sqrt(torch.sum(torch.square(grads), dim=1))
        scale = torch.clamp(max_grad_norm / torch.clamp(gn, min=1e-9),
                            max=1.0)
        grads.mul_(scale[:, None])
    else:
        gn = torch.zeros(params.shape[0], device=params.device)
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
