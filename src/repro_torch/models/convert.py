"""Carry the reference package's parameters into the port's modules: the
vision backbone (``GSPNVision``) and the language model (``LM``).

The reference keeps its parameters as a pytree: per-block leaves stacked
along leading depth axes (its blocks are initialised under ``vmap`` and
walked by ``scan``) and convolution weights in HWIO.  The port keeps one
module per block and OIHW weights (a depthwise ``(3,3,1,C)`` becomes
``(C,1,3,3)`` for ``groups=C``).  The pytree arrives as numpy arrays, so
this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# Leaves of one block, by sub-module, in the reference's names.
_BLOCK_LEAVES = {
    "lpu": ("w", "b"),
    "ln1": ("scale", "bias"),
    "gspn": ("down", "w_taps", "w_lam", "w_u", "up"),
    "lpu2": ("w", "b"),
    "ln2": ("scale", "bias"),
    "mlp": ("fc1", "b1", "fc2", "b2"),
}
_CONV_MODULES = ("lpu", "lpu2")
# Leaves of one LM block, by kind.  The attn kind's qkv biases exist only
# under ``qkv_bias``: present as a group or not at all.
_LM_BLOCK_LEAVES = {
    "gspn": {
        "ln1": ("scale",),
        "mix": ("down", "w_taps", "w_row", "w_lam", "w_u", "up"),
        "ln2": ("scale",),
        "ffn": ("gate", "up", "down"),
    },
    "attn": {
        "ln1": ("scale",),
        "attn": ("wq", "wk", "wv", "wo"),
        "ln2": ("scale",),
        "ffn": ("gate", "up", "down"),
    },
}
_QKV_BIAS = ("bq", "bk", "bv")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (i,))
    else:
        yield prefix, tree


def _taker(leaves):
    def take(*path):
        if path not in leaves:
            raise KeyError(f"missing leaf {'/'.join(map(str, path))}")
        return np.asarray(leaves.pop(path))
    return take


def _to_state(leaves, state) -> dict[str, torch.Tensor]:
    if leaves:
        raise ValueError("leaves with no counterpart: " + ", ".join(
            "/".join(map(str, p)) for p in leaves))
    return {k: torch.from_numpy(np.array(v, copy=True, order="C"))
            for k, v in state.items()}


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    if a.ndim != 4:
        raise ValueError(f"convolution weight must be 4-D, got {a.shape}")
    return a.transpose(3, 2, 0, 1)


def vision_state_from_jax(params_np) -> dict[str, torch.Tensor]:
    """``state_dict`` of a ``GSPNVision`` from the reference's
    ``init_vision`` pytree given as numpy arrays.

    Every leaf maps to exactly one entry; a missing leaf raises
    ``KeyError`` and a leaf left over raises ``ValueError``.
    """
    leaves = dict(_flatten(params_np))
    state: dict[str, np.ndarray] = {}
    take = _taker(leaves)

    state["stem.w"] = _hwio_to_oihw(take("stem", "w"))
    state["stem.b"] = take("stem", "b")
    n_stages = 1 + max((p[1] for p in leaves if p[0] == "stages"), default=-1)
    for si in range(n_stages):
        depth = None
        for mod, names in _BLOCK_LEAVES.items():
            for name in names:
                stacked = take("stages", si, "blocks", mod, name)
                if depth is None:
                    depth = stacked.shape[0]
                elif stacked.shape[0] != depth:
                    raise ValueError(
                        f"stage {si}: {mod}/{name} stacks "
                        f"{stacked.shape[0]} blocks, expected {depth}")
                for k in range(depth):
                    a = stacked[k]
                    if mod in _CONV_MODULES and name == "w":
                        a = _hwio_to_oihw(a)
                    state[f"stages.{si}.blocks.{k}.{mod}.{name}"] = a
        if si + 1 < n_stages:
            state[f"stages.{si}.down.w"] = _hwio_to_oihw(
                take("stages", si, "down", "w"))
            state[f"stages.{si}.down.b"] = take("stages", si, "down", "b")
    state["ln_f.scale"] = take("ln_f", "scale")
    state["ln_f.bias"] = take("ln_f", "bias")
    state["head"] = take("head")
    return _to_state(leaves, state)


def lm_state_from_jax(params_np) -> dict[str, torch.Tensor]:
    """``state_dict`` of an ``LM`` from the reference's ``init_lm`` pytree
    given as numpy arrays.

    Each stage ``stages/s{i}_{kind}`` (kind ``gspn`` or ``attn``) stacks
    its blocks' leaves along leading axes: (n,) for a prelude stage,
    (n_units, n) for a unit stage, told apart by the rank of
    ``ln1/scale``.  They unstack into ``stages.s{i}_{kind}.{i}`` or
    ``stages.s{i}_{kind}.{u}.{i}``.  Every leaf maps to exactly one entry;
    a missing leaf raises ``KeyError`` and a leaf left over raises
    ``ValueError``.
    """
    leaves = dict(_flatten(params_np))
    state: dict[str, np.ndarray] = {}
    take = _taker(leaves)
    state["embed"] = take("embed")
    state["ln_f.scale"] = take("ln_f", "scale")
    if ("head",) in leaves:
        state["head"] = take("head")
    keys = sorted({p[1] for p in leaves if p[0] == "stages"})
    for key in keys:
        kind = key.split("_", 1)[1]
        if kind not in _LM_BLOCK_LEAVES:
            raise ValueError(f"stage {key}: the {kind} kind is not ported")
        lead = np.asarray(leaves[("stages", key, "ln1", "scale")]).shape[:-1]
        modules = dict(_LM_BLOCK_LEAVES[kind])
        if ("stages", key, "attn", "bq") in leaves:
            modules["attn"] += _QKV_BIAS
        for mod, names in modules.items():
            for name in names:
                stacked = take("stages", key, mod, name)
                if stacked.shape[:len(lead)] != lead:
                    raise ValueError(
                        f"stage {key}: {mod}/{name} stacks "
                        f"{stacked.shape[:len(lead)]} blocks, expected "
                        f"{lead}")
                for idx in np.ndindex(*lead):
                    where = ".".join(map(str, idx))
                    state[f"stages.{key}.{where}.{mod}.{name}"] = \
                        stacked[idx]
    return _to_state(leaves, state)
