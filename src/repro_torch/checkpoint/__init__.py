"""Checkpointing (port of ``src/repro/checkpoint``)."""

from .manager import CheckpointManager, RankCheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "RankCheckpointManager", "restore_tree",
           "save_tree"]
