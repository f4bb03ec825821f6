"""Carry the reference package's parameters into the port's modules: the
vision backbone (``GSPNVision``) and the language model (``LM``, its
gspn, attn, attn_moe, xattn, mamba, mlstm and slstm kinds, the shared attn
block, and whisper's encoder and K/V projection).

The reference keeps its parameters as a pytree: per-block leaves stacked
along leading depth axes (its blocks are initialised under ``vmap`` and
walked by ``scan``) and convolution weights in HWIO.  The port keeps one
module per block and OIHW weights (a depthwise ``(3,3,1,C)`` becomes
``(C,1,3,3)`` for ``groups=C``; the LM's causal conv ``(k,1,C)`` becomes
``(C,1,k)``).  The pytree arrives as numpy arrays, so
this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.tensor_parallel import model_slice

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
# Leaves of one LM block, by kind, as paths inside the block, under an
# rmsnorm and a SwiGLU FFN.  A layernorm adds ``bias`` beside each ``ln*``
# scale and the GELU MLP takes the FFN's place (``_lm_block_paths``).  The
# attn kinds' qkv biases exist only under ``qkv_bias``, and the MoE's
# shared expert only under ``shared_expert_ff``: each present as a group
# or not at all.  The MoE's slabs keep their (M, E_loc, ...) shape.  The
# xattn kind's ``xattn/wk`` and ``xattn/wv`` are carried though nothing
# reads them (the reference keeps them too).
_LM_BLOCK_LEAVES = {
    "gspn": ("ln1/scale", "mix/down", "mix/w_taps", "mix/w_row",
             "mix/w_lam", "mix/w_u", "mix/up", "ln2/scale", "ffn/gate",
             "ffn/up", "ffn/down"),
    "attn": ("ln1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
             "ln2/scale", "ffn/gate", "ffn/up", "ffn/down"),
    "attn_moe": ("ln1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
                 "ln2/scale", "moe/router", "moe/gate_slab", "moe/up_slab",
                 "moe/down_slab"),
    "xattn": ("ln1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
              "ln_x/scale", "xattn/wq", "xattn/wk", "xattn/wv", "xattn/wo",
              "ln2/scale", "ffn/gate", "ffn/up", "ffn/down"),
    "mamba": ("ln1/scale", "mix/in_proj", "mix/conv/w", "mix/conv/b",
              "mix/a_log", "mix/dt_bias", "mix/d_skip", "mix/norm/scale",
              "mix/out_proj"),
    "mlstm": ("ln1/scale", "mix/in_proj", "mix/norm/scale", "mix/out_proj"),
    "slstm": ("ln1/scale", "mix/w_in", "mix/r", "mix/b", "mix/out_proj"),
}
_QKV_BIAS = ("attn/bq", "attn/bk", "attn/bv")
_XATTN_BIAS = ("xattn/bq", "xattn/bk", "xattn/bv")
_SHARED_EXPERT = ("moe/shared/gate", "moe/shared/up", "moe/shared/down")
_GELU_MLP = ("ffn/fc1", "ffn/b1", "ffn/fc2", "ffn/b2")


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


def _lm_block_paths(kind, leaves, prefix):
    """The leaf paths of one ``kind`` block whose leaves sit under
    ``prefix`` in the reference's pytree."""
    layernorm = prefix + ("ln1", "bias") in leaves
    gelu = prefix + ("ffn", "fc1") in leaves
    paths = ()
    for path in _LM_BLOCK_LEAVES[kind]:
        if gelu and path.startswith("ffn/"):
            continue
        paths += (path,)
        if layernorm and path.startswith("ln"):
            paths += (path.replace("/scale", "/bias"),)
    if gelu:
        paths += _GELU_MLP
    for head, group in (("attn", _QKV_BIAS), ("xattn", _XATTN_BIAS)):
        if prefix + (head, "bq") in leaves:
            paths += group
    if prefix + ("moe", "shared", "gate") in leaves:
        paths += _SHARED_EXPERT
    return paths


def _unstack(take, leaves, state, kind, src, dst):
    """The blocks of one stage, whose ``kind`` leaves sit under ``src`` in
    the reference's pytree stacked along leading axes (told apart by the
    rank of ``ln1/scale``), into ``dst.{i}`` or ``dst.{u}.{i}``."""
    lead = np.asarray(leaves[src + ("ln1", "scale")]).shape[:-1]
    for path in _lm_block_paths(kind, leaves, src):
        stacked = take(*src, *path.split("/"))
        if stacked.shape[:len(lead)] != lead:
            raise ValueError(
                f"{'/'.join(src)}: {path} stacks "
                f"{stacked.shape[:len(lead)]} blocks, expected {lead}")
        for idx in np.ndindex(*lead):
            where = ".".join(map(str, idx))
            state[f"{dst}.{where}.{path.replace('/', '.')}"] = \
                _lm_leaf(path, stacked[idx])


def _norm(take, leaves, state, src, dst):
    """A norm's ``scale`` (and a layernorm's ``bias``)."""
    for name in ("scale", "bias"):
        if src + (name,) in leaves:
            state[f"{dst}.{name}"] = take(*src, name)


def _lm_leaf(path, a):
    """A reference block leaf in the port's layout: the causal conv's
    weight (k, 1, C) becomes (C, 1, k), not flipped."""
    return a.transpose(2, 1, 0) if path == "mix/conv/w" else a


def relayout_slab(slab: np.ndarray, n_experts: int, n_shards: int,
                  down: bool = False) -> np.ndarray:
    """A MoE slab laid out for ``slab.shape[0]`` model shards re-laid for
    ``n_shards``: of M shards, ``ep = min(E, M)`` expert groups of
    ``E_loc = E / ep`` experts and ``tp = M / ep`` hidden slices, slab
    ``(m, e)`` holding expert ``(m // tp) · E_loc + e``, hidden slice ``m %
    tp``.  ``down``: the (M, E_loc, F_loc, D) down slab, else (M, E_loc,
    D, F_loc)."""
    slab = np.asarray(slab)
    if down:
        return relayout_slab(slab.swapaxes(2, 3), n_experts,
                             n_shards).swapaxes(2, 3)
    m, e_loc, d, f_loc = slab.shape
    ep = min(n_experts, m)
    # (ep, tp, E_loc, D, F_loc) -> the experts whole, (E, D, F).
    full = slab.reshape(ep, m // ep, e_loc, d, f_loc) \
        .transpose(0, 2, 3, 1, 4).reshape(n_experts, d, -1)
    ep = min(n_experts, n_shards)
    tp = n_shards // ep
    return full.reshape(ep, n_experts // ep, d, tp, -1) \
        .transpose(0, 3, 1, 2, 4).reshape(n_shards, n_experts // ep, d, -1)


def _relayout(state: dict, n_shards: int) -> None:
    """Every MoE slab of ``state`` re-laid for ``n_shards`` model shards
    (the block's router gives E)."""
    for k in list(state):
        head, _, leaf = k.rpartition(".")
        if leaf in ("gate_slab", "up_slab", "down_slab"):
            e = np.asarray(state[head + ".router"]).shape[-1]
            state[k] = relayout_slab(state[k], e, n_shards,
                                     down=leaf == "down_slab")


def lm_state_from_jax(params_np, *, n_model_shards: int | None = None,
                      model_rank: int | None = None
                      ) -> dict[str, torch.Tensor]:
    """``state_dict`` of an ``LM`` from the reference's ``init_lm`` pytree
    given as numpy arrays.

    Each stage ``stages/s{i}_{kind}`` (kind ``gspn``, ``attn``,
    ``attn_moe``, ``xattn``, ``mamba``, ``mlstm`` or ``slstm``) stacks its
    blocks' leaves along leading axes: (n,) for a prelude stage, (n_units,
    n) for a unit stage, told apart by the rank of ``ln1/scale``.  They
    unstack into ``stages.s{i}_{kind}.{i}`` or
    ``stages.s{i}_{kind}.{u}.{i}``.  ``shared_attn``, one attn block with
    no stacking, maps to ``shared_attn``; whisper's ``encoder/layers``
    (attn blocks stacked (n,)) to ``encoder.layers.{i}``, with
    ``encoder/ln_f``, ``encoder/pos_embed`` and ``enc_kv_proj/{wk,wv}``
    beside them.  Every leaf maps to exactly one entry; a missing leaf
    raises ``KeyError`` and a leaf left over raises ``ValueError``.

    The reference's parameters may come at any ``n_model_shards`` (its
    MoE slabs' leading M).  ``n_model_shards`` re-lays the slabs for
    another M (:func:`relayout_slab`); ``model_rank`` then gives that
    rank's shard of every parameter over a model axis of M
    (``parallel.tensor_parallel.model_slice``: its contiguous part of each
    leaf the rules split over ``model``), the state of a model that
    ``shard_model`` has sharded.
    """
    if model_rank is not None and n_model_shards is None:
        raise ValueError("model_rank needs n_model_shards")
    leaves = dict(_flatten(params_np))
    state = _lm_state(leaves)
    if n_model_shards is not None:
        _relayout(state, n_model_shards)
    if model_rank is not None:
        state = {k: model_slice(k, np.asarray(v), n_model_shards,
                                model_rank) for k, v in state.items()}
    return _to_state(leaves, state)


def _lm_state(leaves: dict) -> dict[str, np.ndarray]:
    """The LM's entries taken out of ``leaves`` (what is left over stays
    there)."""
    state: dict[str, np.ndarray] = {}
    take = _taker(leaves)
    state["embed"] = take("embed")
    _norm(take, leaves, state, ("ln_f",), "ln_f")
    if ("head",) in leaves:
        state["head"] = take("head")
    if ("shared_attn", "ln1", "scale") in leaves:
        for path in _lm_block_paths("attn", leaves, ("shared_attn",)):
            state["shared_attn." + path.replace("/", ".")] = take(
                "shared_attn", *path.split("/"))
    if ("encoder", "pos_embed") in leaves:
        _unstack(take, leaves, state, "attn", ("encoder", "layers"),
                 "encoder.layers")
        _norm(take, leaves, state, ("encoder", "ln_f"), "encoder.ln_f")
        state["encoder.pos_embed"] = take("encoder", "pos_embed")
        for name in ("wk", "wv"):
            state[f"enc_kv_proj.{name}"] = take("enc_kv_proj", name)
    keys = sorted({p[1] for p in leaves if p[0] == "stages"})
    for key in keys:
        kind = key.split("_", 1)[1]
        if kind not in _LM_BLOCK_LEAVES:
            raise ValueError(f"stage {key}: unknown block kind {kind!r}")
        _unstack(take, leaves, state, kind, ("stages", key),
                 f"stages.{key}")
    return state
