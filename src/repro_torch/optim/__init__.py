"""Optimiser of the port."""

from .adamw import AdamWState, adamw_update
from .schedule import cosine_schedule, linear_warmup

__all__ = ["AdamWState", "adamw_update", "cosine_schedule", "linear_warmup"]
