"""Checkpoints (``manager``)."""
