"""Checkpointing of the port."""
