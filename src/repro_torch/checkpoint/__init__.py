"""Checkpointing (port of ``src/repro/checkpoint``)."""

from .manager import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
