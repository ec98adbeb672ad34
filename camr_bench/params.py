"""The J models' initial weights, made on the device from the seed.

Every normally drawn leaf of all J models comes out of one
``torch.randn`` call per dtype on a generator seeded from the run's
seed, in the dtype the model is served in, and is scaled in place; the
constant leaves are filled. The same seed on the same device gives the
same weights, so the check makes them again instead of keeping a copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .feed import seed_words

__all__ = ["make_weights", "as_tree", "offsets"]


def make_weights(leaves: list, J: int, seed: int, device) -> list:
    """``J`` lists of tensors, one per leaf of ``leaves`` (the layout in
    flat order), on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(seed_words(seed, 2))
                        .generate_state(1, np.uint64)[0]))
    out = [[None] * len(leaves) for _ in range(J)]
    for dt in sorted({leaf.dtype for leaf in leaves
                      if leaf.init[0] == "normal"}):
        idx = [i for i, leaf in enumerate(leaves)
               if leaf.init[0] == "normal" and leaf.dtype == dt]
        total = sum(leaves[i].size for i in idx)
        buf = torch.randn((J, total), generator=gen, device=device,
                          dtype=getattr(torch, dt))
        off = 0
        for i in idx:
            leaf = leaves[i]
            part = buf[:, off:off + leaf.size].mul_(leaf.init[1])
            for j in range(J):
                out[j][i] = part[j].view(leaf.shape)
            off += leaf.size
    for i, leaf in enumerate(leaves):
        if leaf.init[0] == "const":
            for j in range(J):
                out[j][i] = torch.full(leaf.shape, leaf.init[1], device=device,
                                       dtype=getattr(torch, leaf.dtype))
        elif leaf.init[0] != "normal":
            raise ValueError(f"{leaf.path}: unknown init {leaf.init!r}")
    return out


def as_tree(leaves: list, values: list) -> dict:
    """The nested dict of ``values`` at the paths of ``leaves``."""
    tree: dict = {}
    for leaf, val in zip(leaves, values):
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = val
    return tree


def offsets(leaves: list) -> list:
    """Start of each leaf in a row of all leaves, in order."""
    return [int(o) for o in
            np.cumsum([0] + [leaf.size for leaf in leaves[:-1]])]
