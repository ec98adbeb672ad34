"""Optimiser of the port."""

from .adamw import AdamWState, adamw_update

__all__ = ["AdamWState", "adamw_update"]
