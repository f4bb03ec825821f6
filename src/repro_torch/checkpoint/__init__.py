"""Checkpoints: atomic, asynchronous, retention-limited."""
