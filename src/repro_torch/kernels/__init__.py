"""Scan kernels: plain oracles, the launch spec, the CUDA wrappers and the
differentiable dispatch."""

from repro_torch.kernels.spec import ScanSpec  # noqa: F401
