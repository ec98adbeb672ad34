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

With ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh` of
:func:`repro_torch.launch.mesh.make_production_mesh`) every argument is
a DTensor placed by JAX's ``in_shardings``: parameters and moments by
``lm.param_specs`` (JAX's ``_shard``), the batch over the data axes when
the global batch divides them, else replicated (``_batch_axes``), the
decode cache by ``lm.cache_specs`` with the axes that do not divide
dropped (JAX's ``_sanitize``), ``cache_index`` and the optimiser's step
whole. The
step runs under :func:`repro_torch.launch.partitioning.axis_rules`, so
the models' ``constrain`` points redistribute. Each gradient is cast to
``grad_sync_dtype``, then pinned to its parameter's placement (a
reduce-scatter over data, JAX's ``_constrain_grads``); the outputs take
JAX's ``out_shardings``: logits ``(batch, None, "model")``, the cache
and the parameters as they came in. The arguments are each rank's
shards only (random from ``seed`` on a device, empty on ``meta``); a
step's microbatches are each rank's local rows split in ``microbatches``
parts (XLA's reshard of the batch for its scan is a choice of its
own). Without a mesh nothing of this runs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch

from ..configs import ModelConfig, ShapeSpec, input_specs
from ..models import lm
from ..optim import AdamWState, adamw_init, adamw_tree_update, tree_leaves
from . import partitioning as pt
from .mesh import data_axes

__all__ = ["StepBundle", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_step", "shard_args", "arg_specs"]


@dataclass
class StepBundle:
    """Everything the dry run and a card run need for one (cfg, shape)
    cell: ``fn(*args)`` runs the step; ``donate`` lists the positions of
    the arguments it updates in place."""
    fn: Callable
    args: tuple
    device: torch.device
    donate: tuple = ()
    mesh: object = None


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


def _rules(mesh):
    return pt.axis_rules(mesh, data_axes=data_axes(mesh))


def _with_rules(f, mesh):
    """``f`` run under the mesh's axis rules (a no-op without a mesh)."""
    if mesh is None:
        return f

    @functools.wraps(f)
    def g(*a, **k):
        with _rules(mesh):
            return f(*a, **k)
    return g


def _batch_axes(mesh, global_batch: int):
    """Batch partition axes, or None when the batch cannot shard evenly
    (e.g. long_500k's global_batch=1 -> model-parallel only)."""
    ba = data_axes(mesh)
    return ba if global_batch % pt.axis_size(mesh, ba) == 0 else None


def _micro(v, i: int, nmb: int):
    """Microbatch ``i`` of ``nmb``: rows ``[i*b, (i+1)*b)`` of ``v``'s
    batch, or, on a mesh, of each rank's local rows."""
    if not pt.is_dtensor(v):
        b = v.shape[0] // nmb
        return v[i * b:(i + 1) * b]
    from torch.distributed.tensor import DTensor
    loc = v.to_local()
    b = loc.shape[0] // nmb
    shape = (v.shape[0] // nmb, *v.shape[1:])
    return DTensor.from_local(loc[i * b:(i + 1) * b], v.device_mesh,
                              v.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=pt.contiguous_stride(shape))


def train_step_fn(cfg: ModelConfig, lr: float = 3e-4, *,
                  mesh=None) -> Callable:
    """``train_step(params, opt, batch) -> (params, opt, {"loss",
    "gnorm"})``, updating ``params`` and ``opt`` in place; on ``mesh``,
    the sharded step (see the module docstring)."""
    nmb = cfg.microbatches
    gdt = getattr(torch, cfg.grad_sync_dtype)
    specs = tree_leaves(lm.param_specs(cfg)) if mesh is not None else None

    def loss_and_grads(params, mb):
        ps = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in ps]
        with torch.enable_grad():
            loss = lm.train_loss(cfg, _tree_like(params, live), mb)[0]
            grads = torch.autograd.grad(loss, live)
        # the JAX step's cast before the sync: f32 gradients only
        grads = [g.to(gdt) if g.dtype == torch.float32 else g for g in grads]
        if specs is not None:      # pinned: reduce-scattered over data
            grads = [pt.constrain(g, s) for g, s in zip(grads, specs)]
        return loss.detach(), grads

    def train_step(params, opt, batch):
        if nmb == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % nmb:
                raise ValueError(f"global batch {B} does not split into "
                                 f"{nmb} microbatches")
            ps = tree_leaves(params)
            if mesh is None:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=ps[0].device)
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in ps]
            else:
                loss = None
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in ps]
            for i in range(nmb):
                mb = {k: _micro(v, i, nmb) for k, v in batch.items()}
                l, g = loss_and_grads(params, mb)
                loss = l if loss is None else loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            loss = loss / nmb
            for g in grads:
                g.div_(nmb)
        gnorm = adamw_tree_update(params, grads, opt, lr=lr)
        return params, opt, {"loss": loss, "gnorm": gnorm}

    return _with_rules(train_step, mesh)


def _mesh_params(cfg, device, seed, mesh):
    """Each rank's shards of the parameters, placed by
    ``lm.param_specs``: random from ``seed`` on a device (normal over the
    square root of the fan-in, vectors zero), empty on ``meta``."""
    dev = torch.device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    with _rules(mesh):
        return pt.shard_like(
            lm.init_params(cfg, None, device="meta"), lm.param_specs(cfg),
            dev, gen, scale=lambda t: (t.shape[-2] ** -0.5 if t.dim() > 1
                                       else 0.0))


def arg_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> tuple:
    """The logical axes of the step's arguments on ``mesh``, in the order
    of ``StepBundle.args``: JAX's ``in_shardings`` (the optimiser's step
    and ``cache_index`` whole)."""
    ba = _batch_axes(mesh, shape.global_batch)
    bax = None if ba is None else "batch"

    def batch_specs(b):
        return {k: (bax,) + (None,) * (v.dim() - 1) for k, v in b.items()}

    pspecs = lm.param_specs(cfg)
    spec = input_specs(cfg, shape, device="meta")
    if shape.kind == "train":
        return (pspecs, AdamWState(step=(), mu=pspecs, nu=pspecs),
                batch_specs(spec["batch"]))
    if shape.kind == "prefill":
        return (pspecs, batch_specs(spec["batch"]))
    return (pspecs, lm.cache_specs(cfg), (bax, None), ())


def shard_args(cfg: ModelConfig, shape: ShapeSpec, mesh, args) -> tuple:
    """A one-device step's arguments (whole tensors, ``StepBundle.args``
    of a ``mesh=None`` build) distributed over ``mesh`` with the sharded
    step's placements (:func:`arg_specs`); a 0-d tensor stays as it
    is."""
    from torch.distributed.tensor import distribute_tensor

    def put(a, s):
        if isinstance(a, AdamWState):
            return AdamWState(step=a.step, mu=put(a.mu, s.mu),
                              nu=put(a.nu, s.nu))
        if isinstance(a, dict):
            return {k: put(a[k], s[k]) for k in a}
        if a.dim() == 0:
            return a
        return distribute_tensor(a, mesh, pt.placements_for(s, a.shape))

    with _rules(mesh):
        return tuple(put(a, s) for a, s in
                     zip(args, arg_specs(cfg, shape, mesh)))


def _mesh_args(cfg, shape, device, seed, mesh) -> tuple:
    dev = torch.device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
    params = _mesh_params(cfg, dev, seed, mesh)
    specs = arg_specs(cfg, shape, mesh)
    meta = input_specs(cfg, shape, device="meta")
    with _rules(mesh):
        if shape.kind == "train":
            return (params, adamw_init(params),
                    pt.shard_like(meta["batch"], specs[2], dev, gen,
                                  high=cfg.vocab))
        if shape.kind == "prefill":
            return (params, pt.shard_like(meta["batch"], specs[1], dev, gen,
                                          high=cfg.vocab))
        index = (torch.empty((), dtype=torch.int32, device=dev)
                 if dev.type == "meta" else
                 torch.full((), shape.seq_len - 1, dtype=torch.int32,
                            device=dev))
        return (params, pt.shard_like(meta["cache"], specs[1], dev),
                pt.shard_like(meta["tokens"], specs[2], dev, gen,
                              high=cfg.vocab), index)


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
                     lr: float = 3e-4, seed: int = 0,
                     mesh=None) -> StepBundle:
    """The train step and its arguments ``(params, opt, batch)``."""
    if mesh is not None:
        args = _mesh_args(cfg, shape, device, seed, mesh)
    else:
        params = _params(cfg, device, seed)
        args = (params, adamw_init(params),
                _inputs(cfg, shape, device, seed)["batch"])
    return StepBundle(fn=train_step_fn(cfg, lr, mesh=mesh), args=args,
                      device=torch.device(device), donate=(0, 1), mesh=mesh)


def _logits_out(fn, mesh):
    """JAX's logits ``out_shardings`` ``(batch, None, "model")``."""
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def g(*a):
        logits, cache = fn(*a)
        return pt.constrain(logits, ("batch", None, "vocab")), cache
    return g


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
                       seed: int = 0, mesh=None) -> StepBundle:
    """The prefill step ``(params, batch) -> (logits, cache)``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch)

    if mesh is not None:
        args = _mesh_args(cfg, shape, device, seed, mesh)
    else:
        args = (_params(cfg, device, seed),
                _inputs(cfg, shape, device, seed)["batch"])
    return StepBundle(fn=_with_rules(_logits_out(prefill_step, mesh), mesh),
                      args=args, device=torch.device(device), mesh=mesh)


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
                      seed: int = 0, mesh=None) -> StepBundle:
    """The decode step ``(params, cache, tokens, cache_index) -> (logits,
    cache)``, the cache written in place."""
    @torch.no_grad()
    def decode(params, cache, tokens, cache_index):
        return lm.decode_step(cfg, params, cache, tokens, cache_index)

    if mesh is not None:
        args = _mesh_args(cfg, shape, device, seed, mesh)
    else:
        spec = _inputs(cfg, shape, device, seed)
        args = (_params(cfg, device, seed), spec["cache"], spec["tokens"],
                spec["cache_index"])
    return StepBundle(fn=_with_rules(_logits_out(decode, mesh), mesh),
                      args=args, device=torch.device(device), donate=(1,),
                      mesh=mesh)


def build_step(cfg: ModelConfig, shape: ShapeSpec, *, device,
               lr: float = 3e-4, seed: int = 0, mesh=None) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, device=device, lr=lr, seed=seed,
                                mesh=mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, device=device, seed=seed,
                                  mesh=mesh)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, device=device, seed=seed,
                                 mesh=mesh)
    raise ValueError(shape.kind)
