"""Declarative scan configuration: the ``ScanSpec`` (DESIGN.md §14).

One frozen, hashable value describes a scan launch: the fused entry
(``direction``), the implementation, the compact channel mode and the
dtype legs.  The attention module builds one from its configuration; the
dispatch layer (:mod:`repro_torch.kernels.ops`) resolves its
implementation per call, and :meth:`ScanSpec.adjoint` names the launch of
its backward pass.

Implementations:

* ``auto``  resolves to ``cuda`` for CUDA tensors, ``meta`` for ``meta``
  tensors and ``torch`` for CPU tensors (:func:`resolve_impl`); never to
  ``per_step``;
* ``cuda``  is the hand-written kernel; it refuses CPU tensors and any
  carry narrower than float32: the Pallas kernels round the carry only at
  row-tile boundaries, and a kernel without row tiles has no such boundary,
  so that narrowing is refused rather than imitated;
* ``torch`` is the plain PyTorch version, on any device;
* ``meta`` is the shape-only path of a ``meta`` operand: the kernel's
  wrapper checks it as it would on the card, records the one launch the
  card would run (``cuda_lib.meta_launches``: name, shape, bytes) and
  returns empty outputs of the right shapes.  ``meta`` has no data to
  compute on, so this is no fallback: CPU and CUDA tensors never take
  it, and it is never asked for by name;
* ``per_step`` is the GSPN-1 emulation, one dispatch per row
  (``ref.gspn_scan_per_step``), for the single ``fwd`` direction only;
* ``sp`` shards the scan's rows over the ``seq`` axis of a device mesh
  (:mod:`repro_torch.parallel.gspn_sp`); its block-local launches
  resolve as ``auto`` does, under the ``sp_block_local`` boundary.

The reference names the kernel legs ``pallas`` (single scan) and
``multidir`` (pair and quad) and the plain leg ``xla``; here they are
``cuda`` and ``torch``, so a canonical string reads the reference's with
those names swapped (``quad|cuda|...`` for ``quad|multidir|...``).

This module is a leaf: it imports nothing else of the package.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

# Fused entries: the single scan and the fused pair, each with its adjoint,
# and the forward-only single launch of all four directions.
DIRECTIONS = ("fwd", "bwd", "pair_fwd", "pair_bwd", "quad")
_ADJOINT = {"fwd": "bwd", "pair_fwd": "pair_bwd"}
# How a scan segment relates to state outside itself (DESIGN.md §14):
#   one_shot        the whole sequence in one launch from a zero carry;
#   chunk_resume    serve chunked prefill: the carry enters as a synthetic
#                   resumed row 0 (core.gspn.gspn_seq_prefill_chunk);
#   sp_block_local  one block of a sequence-parallel scan from a zero
#                   carry; the true incoming boundary is folded in after
#                   the exchange (parallel.gspn_sp).
# The label changes no number; it names the launch (canonical()).
BOUNDARIES = ("one_shot", "chunk_resume", "sp_block_local")
IMPLS = ("auto", "cuda", "torch", "per_step", "sp")


def canonical_key(direction: str, impl: str, stream_dtype: str,
                  carry_dtype: str, channel_shared: bool,
                  boundary: str) -> str:
    """The policy leg of the schema-3 tuning-cache key, in the reference
    package's format ``direction|impl|stream|carry-C|csN|bnd-B``: shared
    by :meth:`ScanSpec.canonical` and ``autotune.ScanKey.encode``, so a
    key ends with its spec's canonical string."""
    return (f"{direction}|{impl}|{stream_dtype}|carry-{carry_dtype}"
            f"|cs{int(channel_shared)}|bnd-{boundary}")


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
    """``auto`` by the tensor's device (``meta`` for a ``meta`` tensor);
    ``cuda`` on a CPU or ``meta`` tensor raises."""
    if impl == "auto":
        return "cuda" if tensor.is_cuda else \
            "meta" if tensor.is_meta else "torch"
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
        if self.impl == "per_step" and self.direction != "fwd":
            raise ValueError(f"impl='per_step' runs the single 'fwd' scan "
                             f"only, not {self.direction!r}")
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
        """The policy serialization (:func:`canonical_key`)."""
        return canonical_key(self.direction, self.impl, self.stream_dtype,
                             self.carry_dtype, self.channel_shared,
                             self.boundary)

    def with_(self, **changes) -> "ScanSpec":
        """``dataclasses.replace`` with re-validation (frozen update)."""
        return dataclasses.replace(self, **changes)

    def adjoint(self) -> "ScanSpec":
        """The spec of this launch's backward pass: the adjoint direction
        with the always-f32 adjoint carry (DESIGN.md §10).  Only forward
        directions have a fused adjoint kernel; ``quad`` is forward-only
        (training uses the pair dispatch)."""
        if self.direction not in _ADJOINT:
            raise ValueError(f"no fused adjoint for direction "
                             f"{self.direction!r}")
        return self.with_(direction=_ADJOINT[self.direction],
                          carry_dtype="float32")


def enumerate_specs(*, boundaries=("one_shot",),
                    cpws=(1, 3)) -> list[ScanSpec]:
    """The admissible forward spec grid, the one the conformance sweep runs
    (every spec forward, and except ``quad`` its gradient, through
    ``ScanSpec.adjoint``).

    The reference's grid (``repro.kernels.spec.enumerate_specs``) with its
    kernel legs ``pallas``/``multidir`` named ``cuda`` and ``xla`` named
    ``torch``: fwd and pair_fwd on both legs, quad on the kernel leg only;
    stream float32 and bfloat16 with the carry in float32 (the narrow
    carry the reference also enumerates is refused for ``cuda``, see
    :meth:`ScanSpec.check_cuda`, and the plain leg has none); each
    requested boundary label and each ``channels_per_weight`` of
    ``cpws``.  The reference's pipeline depths are a TPU launch knob the
    port has no counterpart for.
    """
    impls_for = {"fwd": ("cuda", "torch"), "pair_fwd": ("cuda", "torch"),
                 "quad": ("cuda",)}
    return [ScanSpec(direction=direction, impl=impl, channels_per_weight=cpw,
                     stream_dtype=stream, boundary=boundary)
            for direction, boundary, cpw in itertools.product(
                impls_for, boundaries, cpws)
            for impl in impls_for[direction]
            for stream in ("float32", "bfloat16")]
