"""Atomic, async checkpoints on numpy files (the counterpart of the
reference package's ``checkpoint``)."""

from .checkpointer import (
    CheckpointManager,
    committed_steps,
    restore_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "committed_steps", "restore_pytree",
           "save_pytree"]
