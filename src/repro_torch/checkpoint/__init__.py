"""Checkpoints of the port (mirrors :mod:`repro.checkpoint`)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
