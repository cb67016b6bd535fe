"""Checkpoints of tensor trees, in the reference's on-disk format (port of
``repro.checkpoint``)."""
from .manager import (CheckpointConfig, CheckpointManager, latest_step,
                      restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "CheckpointConfig", "save_pytree",
           "restore_pytree", "latest_step"]
