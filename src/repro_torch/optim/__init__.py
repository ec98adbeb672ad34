"""Optimiser of the port."""

from .adamw import (AdamWState, adamw_init, adamw_tree_update,
                    adamw_update, clip_by_global_norm, tree_leaves)
from .schedule import cosine_schedule, linear_warmup

__all__ = ["AdamWState", "adamw_update", "adamw_init", "adamw_tree_update",
           "clip_by_global_norm", "tree_leaves", "cosine_schedule",
           "linear_warmup"]
