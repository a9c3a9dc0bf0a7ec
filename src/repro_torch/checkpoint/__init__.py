"""Checkpointing: two-phase atomic commit, async save, restart recovery."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
