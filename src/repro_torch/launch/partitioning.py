"""Logical-axis partitioning: maps model-level axis names to mesh axes,
the twin of ``repro.launch.partitioning`` on DTensor.

Parameters and activations are annotated with *logical* axes
(``"embed"``, ``"ffn"``, ``"heads"``, ``"batch"``, ``"seq"``, ...); a
rule set maps them to the axes of a
:class:`~torch.distributed.device_mesh.DeviceMesh` (``mesh_dim_names``
``("data", "model")`` or ``("pod", "data", "model")``, see
:func:`repro_torch.launch.mesh.make_production_mesh`). The step builders
activate ``(mesh, rules)`` with :func:`axis_rules`; outside that context
every annotation is a no-op, and :func:`constrain` is one on a plain
tensor too, so the one-device paths run as they did.

JAX's names map to DTensor's:

* a ``PartitionSpec`` (one entry per tensor dimension, each a mesh axis
  name, a tuple of them or None) is :func:`logical_to_parts`; the
  DTensor placements of the same sharding (one per *mesh* dimension:
  ``Shard(d)`` where tensor dimension ``d`` is split over that mesh
  axis, else ``Replicate()``) are :func:`logical_to_spec` /
  :func:`named_sharding`;
* ``with_sharding_constraint`` is ``DTensor.redistribute`` in
  :func:`constrain` (a ``Partial`` sum becomes a reduce-scatter or an
  all-reduce, a ``Shard`` to ``Replicate`` an all-gather);
* ``tree_shardings`` maps a spec tree to a tree of placements.

An axis whose dimension does not divide the mesh axes it maps to is
dropped, as JAX's ``constrain`` and the step builders' ``_sanitize``
drop it (``seq = 1`` in decode, 8 kv heads over 16 model shards).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch

__all__ = ["DEFAULT_RULES", "no_seq_parallel_rules", "axis_rules",
           "current_mesh", "current_rules", "logical_to_parts",
           "logical_to_spec", "parts_to_placements", "placements_for",
           "constrain", "named_sharding", "tree_shardings", "is_dtensor",
           "axis_size", "gather_data", "like", "local_shape",
           "sharded_iota", "new_dtensor", "shard_like", "grad_placements",
           "contiguous_stride"]


class _State:
    """The active ``(mesh, rules)``. Process-wide, not thread-local as
    JAX's: the autograd engine runs a backward (and the recompute of a
    checkpointed block inside it) on a thread of its own for some
    devices, and that recompute must see the rules its forward saw."""
    ctx = None


_state = _State()

# default rule set for the production (16, 16) mesh ('data', 'model'),
# extended with a leading 'pod' axis for the multi-pod mesh
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("data",),       # data parallel (pod axis prepended if present)
    "seq": ("model",),        # sequence-parallel residual stream between
    #                           blocks (Megatron-SP)
    "embed": None,            # residual feature dim replicated over model
    "fsdp": ("data",),        # parameter FSDP shard
    "ffn": ("model",),        # tensor parallel
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "experts": ("model",),    # expert parallel
    "ssm_in": ("model",),
    "ssm_heads": ("model",),
    "seq_kv": ("model",),     # KV-cache sequence dim (flash-decode)
    "state": None,
}


def no_seq_parallel_rules() -> dict[str, Any]:
    """Ablation: residual stream replicated over 'model' between
    blocks."""
    rules = dict(DEFAULT_RULES)
    rules["seq"] = None
    return rules


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, Any] | None = None,
               data_axes: tuple[str, ...] = ("data",)):
    """Activate the logical->mesh mapping. ``data_axes`` lets multi-pod
    meshes map 'batch' to ('pod', 'data'); FSDP stays within a pod."""
    rules = dict(rules or DEFAULT_RULES)
    if data_axes != ("data",):
        rules["batch"] = data_axes
        rules["fsdp"] = ("data",)
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules)
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def current_rules() -> dict | None:
    ctx = getattr(_state, "ctx", None)
    return ctx[1] if ctx else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def axis_size(mesh, names) -> int:
    """The number of devices along the mesh axes ``names`` (one name or
    a tuple)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)


def logical_to_parts(axes: tuple) -> tuple:
    """JAX's ``logical_to_spec``: one entry per tensor dimension, a mesh
    axis name, a tuple of names or None (the entries of a
    ``PartitionSpec``); ``()`` with no active context."""
    rules = current_rules()
    if rules is None:
        return ()
    parts = []
    for ax in axes:
        r = rules.get(ax) if ax is not None else None
        if r is None:
            parts.append(None)
        else:
            parts.append(r if len(r) > 1 else r[0])
    return tuple(parts)


def parts_to_placements(parts: tuple, mesh, shape=None) -> tuple:
    """DTensor placements (one per mesh dimension) of the
    ``PartitionSpec`` entries ``parts``. With ``shape``, an entry whose
    dimension does not divide its mesh axes is dropped (JAX's
    ``_sanitize``). A tensor dimension over several mesh axes is split
    over them in mesh order, as JAX splits it major to minor."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for d, p in enumerate(parts):
        if p is None:
            continue
        names = p if isinstance(p, tuple) else (p,)
        if shape is not None and shape[d] % axis_size(mesh, names):
            continue
        for a in names:
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def logical_to_spec(axes: tuple, shape=None) -> tuple:
    """The DTensor placements of logical ``axes`` on the active mesh:
    one per mesh dimension (``()`` with no active context); ``shape``
    drops the axes that do not divide."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return parts_to_placements(logical_to_parts(axes), mesh, shape)


def placements_for(axes, shape) -> tuple:
    """:func:`logical_to_spec` of a leaf's axes (None: replicated) padded
    to its rank, the non-dividing axes dropped."""
    axes = tuple(axes or ())
    axes = axes + (None,) * (len(shape) - len(axes))
    return logical_to_spec(axes, tuple(shape))


def constrain(x, axes: tuple):
    """``with_sharding_constraint`` by logical axes: ``x`` (a DTensor)
    redistributed to the placements of ``axes`` on the active mesh;
    axes whose dimension does not divide the mesh axes are dropped (e.g.
    seq = 1 in decode cannot be sequence-parallel). A no-op without an
    active context or on a plain tensor."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    want = placements_for(axes, x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def named_sharding(axes: tuple) -> tuple | None:
    """The placements of ``axes`` on the active mesh (None without a
    context): JAX's ``NamedSharding``."""
    if current_mesh() is None:
        return None
    return logical_to_spec(axes)


def tree_shardings(spec_tree, extra_leading: int = 0):
    """Map a tree of logical-axis tuples (nested dicts) to placements;
    ``extra_leading`` prepends unsharded dims."""
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, extra_leading)
                for k, v in spec_tree.items()}
    if spec_tree is None:
        return named_sharding(())
    return named_sharding((None,) * extra_leading + tuple(spec_tree))


# --------------------------------------------------------------------- #
# DTensor helpers of the model code (all but gather_data need a mesh)
# --------------------------------------------------------------------- #
def gather_data(w):
    """An FSDP-sharded weight gathered over the data axes (``pod``,
    ``data``) before use (its gradient is reduce-scattered back on the
    way out, JAX's FSDP); a plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def like(t, ref):
    """``t`` (a plain tensor every rank holds whole) as a replicated
    DTensor on ``ref``'s mesh, fit to meet the DTensor ``ref`` in one op;
    ``t`` itself when ``ref`` is plain."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_shape(shape, placements, mesh) -> tuple:
    """This rank's shard shape of a tensor of global ``shape`` (every
    split even)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def sharded_iota(n: int, ref, dim: int):
    """``arange(n)`` (int64) as a DTensor split over the mesh dimensions
    that split dimension ``dim`` of the DTensor ``ref``: each rank holds
    the global indices of its shard of that dimension (JAX's
    ``broadcasted_iota`` on a sharded axis)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = ref.device_mesh
    pl = [Shard(0) if p.is_shard(dim) else Replicate()
          for p in ref.placements]
    full = torch.arange(n, device=ref.device)
    return distribute_tensor(full, mesh, pl, src_data_rank=None)


def new_dtensor(shape, dtype, placements, mesh, device, gen=None,
                scale=None, high=None):
    """A DTensor of global ``shape``: each rank's shard allocated on
    ``device``, zero (nothing written on ``meta``), or drawn from
    ``gen`` (on ``device``): integers in ``[0, high)`` when ``high`` is
    given, else normal times ``scale``."""
    from torch.distributed.tensor import DTensor
    loc = local_shape(shape, placements, mesh)
    if torch.device(device).type == "meta":
        t = torch.empty(loc, dtype=dtype, device=device)
    elif gen is None:
        t = torch.zeros(loc, dtype=dtype, device=device)
    elif high is not None:
        t = torch.randint(0, high, loc, generator=gen, device=gen.device,
                          dtype=dtype)
    else:
        t = torch.randn(loc, generator=gen, device=gen.device, dtype=dtype)
        if scale is not None:
            t.mul_(scale)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def shard_like(tree, specs, device, gen=None, scale=None, high=None):
    """A tree of DTensors on the active mesh with the shapes and dtypes
    of ``tree``'s leaves (tensors or anything with ``shape`` and
    ``dtype``), each placed by its logical axes in ``specs`` (the axes
    that do not divide dropped) and allocated shard by shard on
    ``device`` (:func:`new_dtensor`): integer leaves drawn below
    ``high``, float leaves normal times ``scale(leaf)``."""
    if isinstance(tree, dict):
        return {k: shard_like(tree[k], specs[k], device, gen, scale, high)
                for k in tree}
    ints = not tree.dtype.is_floating_point
    return new_dtensor(tuple(tree.shape), tree.dtype,
                       placements_for(specs, tree.shape), current_mesh(),
                       device, gen=gen,
                       scale=None if scale is None or ints else scale(tree),
                       high=high if ints else None)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (no tensor made)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def grad_placements(in_placements, out_placements) -> tuple:
    """``local_map``'s ``in_grad_placements`` for a body whose ranks do
    different work along the mesh dimensions where ``out_placements`` is
    not ``Replicate``: there an input held whole (``Replicate``) gets a
    different gradient on each rank, a ``Partial`` sum; along the other
    dimensions the work is the same on every rank and so is the
    gradient."""
    from torch.distributed.tensor import Partial
    return tuple(
        None if pl is None else tuple(
            Partial() if p.is_replicate() and not o.is_replicate() else p
            for p, o in zip(pl, out_placements))
        for pl in in_placements)
