"""Fault-tolerance substrate: async checkpointing and restore onto any
device (the port of ``repro.checkpoint``)."""
from .store import CheckpointManager, save_checkpoint, restore_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
