"""Step builders: the train, prefill and decode step of any (arch, shape)
on one device, the twin of ``repro.launch.steps``.

``build_step(cfg, shape, device=...)`` returns a :class:`StepBundle`:
the step function and its arguments, built on ``device``. On ``"meta"``
(the dry run, :mod:`repro_torch.launch.dryrun`) every argument is a
shape and nothing is allocated; on a card (or the CPU) the parameters
are random from ``seed`` and the inputs those of
:func:`repro_torch.configs.input_specs`. The steps compute what JAX's
compute:

* train: ``lm.train_loss`` (at the config's ``remat``), its gradient
  averaged over ``cfg.microbatches`` (accumulated in f32, as JAX's scan
  carry), each
  f32 gradient first cast to ``cfg.grad_sync_dtype``, then AdamW with
  global-norm clipping (:func:`repro_torch.optim.adamw_tree_update`);
  returns ``(params, opt, {"loss", "gnorm"})``;
* prefill: ``lm.prefill`` over a fresh cache of ``global_batch x
  seq_len``; returns ``(logits, cache)``;
* decode: one ``lm.decode_step`` against a full-length cache at a
  device-side ``cache_index`` (no host read); returns ``(logits,
  cache)``.

Parameters keep the JAX tree layout and dtypes and the moments are f32
trees, so the arguments' bytes are JAX's. Where JAX donates an argument
(``donate_argnums``: the train step's parameters and optimiser state,
the decode step's cache) the port updates it in place and returns it.
There is no sharding: the port's one mesh is one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs import ModelConfig, ShapeSpec, input_specs
from ..models import lm
from ..optim import adamw_init, adamw_tree_update, tree_leaves

__all__ = ["StepBundle", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_step"]


@dataclass
class StepBundle:
    """Everything the dry run and a card run need for one (cfg, shape)
    cell: ``fn(*args)`` runs the step; ``donate`` lists the positions of
    the arguments it updates in place."""
    fn: Callable
    args: tuple
    device: torch.device
    donate: tuple = ()


def _params(cfg: ModelConfig, device, seed: int):
    dev = torch.device(device)
    if dev.type == "meta":
        return lm.init_params(cfg, None, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return lm.init_params(cfg, gen)


def _inputs(cfg, shape, device, seed):
    dev = torch.device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
    return input_specs(cfg, shape, device=dev, gen=gen)


def _tree_like(tree, values: list):
    """``values`` (in sorted-key leaf order) in the structure of
    ``tree``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def train_step_fn(cfg: ModelConfig, lr: float = 3e-4) -> Callable:
    """``train_step(params, opt, batch) -> (params, opt, {"loss",
    "gnorm"})``, updating ``params`` and ``opt`` in place."""
    nmb = cfg.microbatches
    gdt = getattr(torch, cfg.grad_sync_dtype)

    def loss_and_grads(params, mb):
        ps = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in ps]
        with torch.enable_grad():
            loss = lm.train_loss(cfg, _tree_like(params, live), mb)[0]
            grads = torch.autograd.grad(loss, live)
        # the JAX step's cast before the sync: f32 gradients only
        grads = [g.to(gdt) if g.dtype == torch.float32 else g for g in grads]
        return loss.detach(), grads

    def train_step(params, opt, batch):
        if nmb == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % nmb:
                raise ValueError(f"global batch {B} does not split into "
                                 f"{nmb} microbatches")
            b = B // nmb
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            for i in range(nmb):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                l, g = loss_and_grads(params, mb)
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            loss = loss / nmb
            for g in grads:
                g.div_(nmb)
        gnorm = adamw_tree_update(params, grads, opt, lr=lr)
        return params, opt, {"loss": loss, "gnorm": gnorm}

    return train_step


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
                     lr: float = 3e-4, seed: int = 0) -> StepBundle:
    """The train step and its arguments ``(params, opt, batch)``."""
    params = _params(cfg, device, seed)
    opt = adamw_init(params)
    batch = _inputs(cfg, shape, device, seed)["batch"]
    return StepBundle(fn=train_step_fn(cfg, lr), args=(params, opt, batch),
                      device=torch.device(device), donate=(0, 1))


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
                       seed: int = 0) -> StepBundle:
    """The prefill step ``(params, batch) -> (logits, cache)``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch)

    params = _params(cfg, device, seed)
    batch = _inputs(cfg, shape, device, seed)["batch"]
    return StepBundle(fn=prefill_step, args=(params, batch),
                      device=torch.device(device))


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
                      seed: int = 0) -> StepBundle:
    """The decode step ``(params, cache, tokens, cache_index) -> (logits,
    cache)``, the cache written in place."""
    @torch.no_grad()
    def decode(params, cache, tokens, cache_index):
        return lm.decode_step(cfg, params, cache, tokens, cache_index)

    params = _params(cfg, device, seed)
    spec = _inputs(cfg, shape, device, seed)
    return StepBundle(fn=decode, args=(params, spec["cache"], spec["tokens"],
                                       spec["cache_index"]),
                      device=torch.device(device), donate=(1,))


def build_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
               lr: float = 3e-4, seed: int = 0) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, device=device, lr=lr, seed=seed)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, device=device, seed=seed)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, device=device, seed=seed)
    raise ValueError(shape.kind)
