"""Atomic, async checkpointing of tensor trees, after ``repro.checkpoint``."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
    tree_leaves_with_paths,
    tree_unflatten,
    unflatten,
)
