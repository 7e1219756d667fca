"""Checkpointing: atomic save/restore of a train state (single device)."""
