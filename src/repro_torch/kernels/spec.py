"""Declarative scan configuration: the ``ScanSpec`` (DESIGN.md §14).

One frozen, hashable value describes a scan launch: the fused entry
(``direction``), the implementation, the compact channel mode and the
dtype legs.  The attention module builds one from its configuration; the
dispatch layer (:mod:`repro_torch.kernels.ops`) resolves its
implementation per call, and :meth:`ScanSpec.adjoint` names the launch of
its backward pass.

Implementations:

* ``auto``  resolves to ``cuda`` for CUDA tensors and ``torch`` for CPU
  tensors (:func:`resolve_impl`);
* ``cuda``  is the hand-written kernel; it refuses CPU tensors and any
  carry narrower than float32: the Pallas kernels round the carry only at
  row-tile boundaries, and a kernel without row tiles has no such boundary,
  so that narrowing is refused rather than imitated;
* ``torch`` is the plain PyTorch version, on any device.

This module is a leaf: it imports nothing else of the package.
"""

from __future__ import annotations

import dataclasses

import torch

# Fused entries: the single scan and the fused pair, each with its adjoint.
DIRECTIONS = ("fwd", "bwd", "pair_fwd", "pair_bwd")
_ADJOINT = {"fwd": "bwd", "pair_fwd": "pair_bwd"}
# How a scan segment relates to state outside itself: the whole sequence
# in one launch from a zero carry.
BOUNDARIES = ("one_shot",)
IMPLS = ("auto", "cuda", "torch")


def dtype_name(dtype) -> str:
    """Canonical name of a dtype given as a ``torch.dtype`` or a string
    (``"float32"``, ``"bfloat16"``, ``"float"``, ``"torch.float32"``)."""
    if isinstance(dtype, str):
        resolved = getattr(torch, dtype.removeprefix("torch."), None)
        if not isinstance(resolved, torch.dtype):
            raise ValueError(f"unknown dtype {dtype!r}")
        dtype = resolved
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return str(dtype).removeprefix("torch.")


def resolve_impl(impl: str, tensor: torch.Tensor) -> str:
    """``auto`` by the tensor's device; ``cuda`` on a CPU tensor raises."""
    if impl == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if impl == "cuda" and not tensor.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; use impl='torch' "
                         "or 'auto' for CPU tensors")
    return impl


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """Everything one fused scan launch needs to know about itself.
    The kernels take ``channels_per_weight`` and the stream dtype from the
    operands; the fields name them for the launch's identity
    (:meth:`canonical`)."""

    direction: str = "fwd"             # DIRECTIONS
    impl: str = "auto"                 # IMPLS
    channels_per_weight: int = 1       # compact channel mode: G = G_w·cpw
    stream_dtype: str = "float32"      # streamed operands and output
    carry_dtype: str = "float32"       # the row carry
    boundary: str = "one_shot"         # BOUNDARIES

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {self.direction!r}; "
                             f"expected one of {DIRECTIONS}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; "
                             f"expected one of {IMPLS}")
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"unknown boundary {self.boundary!r}; "
                             f"expected one of {BOUNDARIES}")
        if not isinstance(self.channels_per_weight, int) \
                or self.channels_per_weight < 1:
            raise ValueError(f"channels_per_weight must be a positive int, "
                             f"got {self.channels_per_weight!r}")
        # Normalise dtype spellings so equality and hashing never split on
        # spelling.
        object.__setattr__(self, "stream_dtype",
                           dtype_name(self.stream_dtype))
        object.__setattr__(self, "carry_dtype", dtype_name(self.carry_dtype))
        if self.impl == "cuda":
            self.check_cuda()

    def check_cuda(self) -> None:
        """Raise if the CUDA kernel cannot run this spec's carry (the
        wrappers check the operands themselves)."""
        if self.carry_dtype != "float32":
            raise ValueError(
                f"the CUDA scan keeps its carry in float32; carry_dtype="
                f"{self.carry_dtype!r} is refused")

    @property
    def channel_shared(self) -> bool:
        """Compact channel propagation active (weights span cpw planes)."""
        return self.channels_per_weight > 1

    def canonical(self) -> str:
        """The policy serialization, in the reference package's format:
        ``direction|impl|stream|carry-C|csN|bnd-B``."""
        return (f"{self.direction}|{self.impl}|{self.stream_dtype}"
                f"|carry-{self.carry_dtype}|cs{int(self.channel_shared)}"
                f"|bnd-{self.boundary}")

    def with_(self, **changes) -> "ScanSpec":
        """``dataclasses.replace`` with re-validation (frozen update)."""
        return dataclasses.replace(self, **changes)

    def adjoint(self) -> "ScanSpec":
        """The spec of this launch's backward pass: the adjoint direction
        with the always-f32 adjoint carry (DESIGN.md §10).  Only forward
        directions have a fused adjoint kernel."""
        if self.direction not in _ADJOINT:
            raise ValueError(f"no fused adjoint for direction "
                             f"{self.direction!r}")
        return self.with_(direction=_ADJOINT[self.direction],
                          carry_dtype="float32")
