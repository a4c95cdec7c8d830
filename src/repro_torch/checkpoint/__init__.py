"""Checkpointing: save/restore in the JAX package's on-disk layout, with
async writes."""

from .ckpt import (CheckpointManager, latest_step, restore_state,
                   save_state)

__all__ = ["CheckpointManager", "latest_step", "restore_state", "save_state"]
