"""Weights across the two packages, and the flat parameter layout.

* :func:`params_from_jax` turns the output of the JAX package's
  ``repro.models.lm.init_params``, exported as a tree of numpy arrays
  (``jax.tree.map(np.asarray, params)``), into the port's params.
* :func:`ravel` / :func:`unravel` reproduce ``jax.flatten_util.
  ravel_pytree`` exactly: dict keys in sorted order, leaves raveled in C
  order (stacked-layer leaves keep their leading ``repeats`` axis), the
  flat vector in the promoted dtype of the leaves (f32 for bf16 matrices
  beside f32 norms), and ``unravel`` casting each leaf back to its own
  dtype. The trainer's worker shards of the flat vector are therefore
  the JAX trainer's, element for element.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["params_from_jax", "leaves", "FlatSpec", "flat_spec", "ravel",
           "split", "tree", "unravel"]


def leaves(tree, prefix=()):
    """``(path, leaf)`` pairs in ``jax.tree_util`` order (sorted keys)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])      # copies read-only arrays
    if a.dtype.name == "bfloat16":          # ml_dtypes: same bits as torch
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return t.to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device=None) -> dict:
    """A tree of numpy arrays (dicts of arrays) -> the same tree of
    torch tensors on ``device`` (bit-for-bit, bf16 included)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)


@dataclass(frozen=True)
class FlatSpec:
    """Layout of a raveled parameter tree."""
    paths: tuple          # leaf paths in flat order
    shapes: tuple
    dtypes: tuple
    offsets: tuple        # start of each leaf in the flat vector
    size: int             # D, total elements
    dtype: torch.dtype    # the flat vector's (promoted) dtype


def flat_spec(params) -> FlatSpec:
    paths, shapes, dtypes, offsets = [], [], [], []
    off = 0
    for path, leaf in leaves(params):
        paths.append(path)
        shapes.append(tuple(leaf.shape))
        dtypes.append(leaf.dtype)
        offsets.append(off)
        off += leaf.numel()
    return FlatSpec(tuple(paths), tuple(shapes), tuple(dtypes),
                    tuple(offsets), off,
                    functools.reduce(torch.promote_types, dtypes))


def ravel(params) -> torch.Tensor:
    """The flat vector of ``ravel_pytree(params)[0]``."""
    spec = flat_spec(params)
    return torch.cat([leaf.reshape(-1).to(spec.dtype)
                      for _, leaf in leaves(params)])


def split(flat: torch.Tensor, spec: FlatSpec) -> list:
    """The leaves of ``flat[:spec.size]`` in flat order: views, each cast
    to its own dtype (a bf16 leaf is a rounded copy)."""
    return [flat[off:off + int(np.prod(shape, dtype=np.int64))]
            .view(shape).to(dtype)
            for shape, dtype, off in zip(spec.shapes, spec.dtypes,
                                         spec.offsets)]


def tree(spec: FlatSpec, values: list) -> dict:
    """Leaves in flat order -> the parameter tree."""
    out: dict = {}
    for path, leaf in zip(spec.paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def unravel(flat: torch.Tensor, spec: FlatSpec) -> dict:
    """The parameter tree of ``flat`` (``ravel_pytree``'s unravel)."""
    return tree(spec, split(flat, spec))
