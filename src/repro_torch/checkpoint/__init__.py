"""Checkpointing: atomic, keep-N, async-write, the reference's layout."""
from .manager import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
