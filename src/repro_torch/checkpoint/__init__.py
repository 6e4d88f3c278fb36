"""Checkpoints in the reference's on-disk layout."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
