"""Parallel execution of the port over ``torch.distributed``."""
