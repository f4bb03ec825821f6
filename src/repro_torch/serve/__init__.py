"""Serving: the continuous-batching engine and its state-cache pool."""
