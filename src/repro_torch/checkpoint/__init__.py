"""Integrity-checked, async checkpointing in the JAX package's format."""

from .ckpt import (CheckpointManager, available_steps, load_checkpoint,
                   save_checkpoint)

__all__ = ["CheckpointManager", "available_steps", "save_checkpoint",
           "load_checkpoint"]
