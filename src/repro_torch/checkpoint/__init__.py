"""Checkpointing (port of ``src/repro/checkpoint``): atomic, async saves in
the reference's file format."""
from repro_torch.checkpoint.manager import CheckpointCorruptError, CheckpointManager

__all__ = ["CheckpointCorruptError", "CheckpointManager"]
