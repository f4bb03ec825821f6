"""Config registry, the shape catalogue and the mixed-precision policy,
the port's copy of ``repro.configs.base`` with torch dtypes.

The :class:`Precision` policy (DESIGN.md §10) says how dtypes thread
through the stack: ``param_dtype`` (storage), ``compute_dtype`` (matrix
products and streamed scan operands) and ``carry_dtype`` (scan carries and
accumulators).  ``with_precision`` rewrites an LMConfig to a preset of
:data:`PRECISIONS`; launchers accept the preset names.

The registry holds the architectures the port runs; ``get_arch`` of any
other architecture of the reference raises and names the ROADMAP.md item
that brings it.  ``input_specs`` (the dry run's shape stand-ins) waits for
ROADMAP.md §1 item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.models.lm import LMConfig

DTYPES = {
    "f32": torch.float32, "float32": torch.float32, "fp32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Map a CLI/config dtype name ("f32", "bf16", ...) to a torch dtype;
    a torch dtype passes through."""
    if isinstance(name, str):
        try:
            return DTYPES[name.lower()]
        except KeyError:
            raise ValueError(
                f"unknown dtype {name!r}; expected one of {sorted(DTYPES)}")
    return name


@dataclasses.dataclass(frozen=True)
class Precision:
    """End-to-end dtype policy: params / streamed compute / carries.  The
    default is the reference's production mix, bf16 storage and streams
    with f32 carries: the scan is a long dependent product, and a bf16
    carry loses the non-expansiveness guarantee to rounding."""
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    carry_dtype: Any = torch.float32


PRECISIONS: Dict[str, Precision] = {
    # full f32, the numerics oracle
    "f32": Precision(torch.float32, torch.float32, torch.float32),
    # production default: bf16 streams, f32 carries
    "bf16": Precision(),
    # bf16 compute over f32 parameters, cast at use
    "bf16_f32params": Precision(torch.float32, torch.bfloat16, torch.float32),
}


def resolve_precision(p: Union[str, Precision]) -> Precision:
    if isinstance(p, str):
        try:
            return PRECISIONS[p]
        except KeyError:
            raise ValueError(f"unknown precision preset {p!r}; "
                             f"expected one of {sorted(PRECISIONS)}")
    return p


def with_precision(cfg: LMConfig, precision: Union[str, Precision]) -> LMConfig:
    """Rewrite an LMConfig to a precision policy: parameter storage, the
    FFN's compute, the GSPN mixer's streamed compute and the scan carry
    all follow it (DESIGN.md §10)."""
    p = resolve_precision(precision)
    return dataclasses.replace(
        cfg,
        param_dtype=resolve_dtype(p.param_dtype),
        compute_dtype=resolve_dtype(p.compute_dtype),
        gspn_compute_dtype=resolve_dtype(p.compute_dtype),
        carry_dtype=resolve_dtype(p.carry_dtype))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    family: str
    full: Callable[..., LMConfig]
    reduced: Callable[[], LMConfig]
    # cells skipped per assignment rules, with reasons (DESIGN.md §4)
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""


REGISTRY: Dict[str, ArchEntry] = {}

# The reference's architectures the port does not run yet, and the
# ROADMAP.md §1 item that brings each.
NOT_PORTED = {
    "qwen2-vl-72b": "item 3.6 (the other families: M-RoPE and vision "
                    "embeddings)",
    "kimi-k2-1t-a32b": "item 3.6 (the other families: MoE)",
    "grok-1-314b": "item 3.6 (the other families: MoE)",
    "zamba2-2.7b": "item 3.6 (the other families: SSM)",
    "xlstm-1.3b": "item 3.6 (the other families: xLSTM)",
    "whisper-base": "item 3.6 (the other families: encoder-decoder)",
}


FULL_ATTENTION_SKIP = (
    "full attention is quadratic in context; assignment rule: skip "
    "long_500k for pure full-attention archs (decode itself is O(L) but "
    "the rule is applied as written; see DESIGN.md §4)")


def register(entry: ArchEntry):
    REGISTRY[entry.name] = entry
    return entry


def _populate():
    import repro_torch.configs.granite_3_2b  # noqa: F401
    import repro_torch.configs.qwen1_5_32b  # noqa: F401
    import repro_torch.configs.qwen2_1_5b  # noqa: F401
    import repro_torch.configs.qwen2_1_5b_gspn  # noqa: F401
    import repro_torch.configs.qwen2_5_3b  # noqa: F401


def get_arch(name: str) -> ArchEntry:
    _populate()
    if name in REGISTRY:
        return REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not in the port yet; ROADMAP.md §1 "
            f"{NOT_PORTED[name]} brings it")
    raise KeyError(f"unknown architecture {name!r}; the port runs "
                   f"{list_archs()}")


def list_archs():
    _populate()
    return sorted(REGISTRY)
