"""GSPN-2 in PyTorch with hand-written CUDA scan kernels for Hopper.

The package mirrors the layout of the JAX reference package ``repro``
module for module, and imports nothing of it: on a host without JAX it
runs on its own.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version, on the card it launches the kernel or raises.
"""
