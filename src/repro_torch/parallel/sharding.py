"""Sharding rules: a parameter's name -> the placement of each of its
dims, the port of the reference's ``parallel/sharding.py`` as pure
functions of names, shapes and mesh sizes.

Parallelism layout (DESIGN.md §5):

* ``model`` axis: tensor parallelism of attention heads, FFN hidden,
  vocabulary and expert groups;
* ``data`` axis: data parallelism **and** FSDP: most 2-D weights also
  shard their non-TP dim over ``data`` (ZeRO-3: gathered before a block
  runs, gradients reduce-scattered after its backward);
* ``pod`` axis: outer data parallelism; parameters are replicated across
  pods and gradients all-reduce over it.

A placement (a *spec*) is a tuple with one entry per dim: ``None``
(replicated), a mesh axis name, or a tuple of axis names (the batch
dim over ``("pod", "data")``).  ``torch.distributed.tensor`` placements
follow from it: an axis on dim d is ``Shard(d)`` over that axis, and
``Replicate()`` over every axis that no dim names.

Rules match by regex on the reference's pytree path of the leaf a port
parameter comes from (``optim.adamw.reference_leaf``) and give the spec of
its *trailing* dims; the reference's stacking axes (its blocks are
stacked along depth) are the port's module indices, so they are padded
with ``None`` and dropped again.  :func:`sanitize_spec` drops an axis the
mesh lacks or whose size does not divide the dim, so one rule set serves
every architecture and mesh.

The reference's ``constrain`` (``with_sharding_constraint``) steers XLA's
SPMD partitioner; PyTorch runs eagerly and has no partitioner to steer,
so it has no counterpart here: the data-parallel step places its
activations by slicing the batch (:func:`batch_shardings`).
"""

from __future__ import annotations

import re

from repro_torch.optim.adamw import reference_leaf

# (pattern, trailing-dims spec).  First match wins.  "fsdp" is substituted
# with the data axis name, "tp" with the model axis name.  FSDP shards a
# weight on its contraction dim; embed and head are vocab-sharded only.
# The rules are the reference's as they are, its dead entries included
# (``(gate|up|fc1)$`` and ``(down|fc2)$`` catch ``mix/up`` and
# ``mix/down`` before the GSPN rules below them).
PARAM_RULES = [
    # --- embeddings / head ---
    (r"embed$",                ("tp", None)),
    (r"head$",                 (None, "tp")),
    (r"pos_embed$",            (None, None)),
    # --- MoE slabs: (M, E_loc, D, F_loc) laid out per model shard ---
    (r"(gate_slab|up_slab)$",  ("tp", None, "fsdp", None)),
    (r"down_slab$",            ("tp", None, None, "fsdp")),
    (r"router$",               (None, None)),
    # --- attention ---
    (r"(wq|wk|wv)$",           ("fsdp", "tp")),
    (r"wo$",                   ("tp", "fsdp")),
    (r"(bq|bk|bv)$",           ("tp",)),
    # --- dense FFN ---
    (r"(gate|up|fc1)$",        ("fsdp", "tp")),
    (r"(down|fc2)$",           ("tp", "fsdp")),
    (r"b1$",                   ("tp",)),
    (r"b2$",                   (None,)),
    # --- mixers (mamba/mlstm/slstm): column-, then row-parallel ---
    (r"(in_proj|w_in)$",       ("fsdp", "tp")),
    (r"out_proj$",             ("tp", "fsdp")),
    (r"\br$",                  (None, "tp", None, None)),   # sLSTM recurrent
    (r"conv/w$",               (None, None, "tp")),
    # --- GSPN mixer / attention generators (small): fsdp only ---
    (r"(w_taps|w_lam|w_u|w_row)$", ("fsdp", None)),
    (r"gspn/(down|up)$",       ("fsdp", None)),
    (r"mix/(down|up)$",        ("fsdp", None)),
    # --- encoder kv proj ---
    (r"enc_kv_proj/(wk|wv)$",  ("fsdp", "tp")),
    # --- vision convs / everything small: replicate ---
    (r".*",                    None),
]

# Port parameters whose dims are the reference leaf's in another order:
# the causal conv's (k, 1, C) is (C, 1, k) in the port (models/convert.py).
_PERMUTED = {r"conv/w$": (2, 1, 0)}

SEQ_AXIS = "seq"


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, of a dict (returned as it
    is) or of anything with the reference mesh's ``.shape`` mapping."""
    if isinstance(mesh, dict):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def normalize(spec) -> tuple:
    """A spec with each one-axis tuple entry written as the axis name
    (the reference's ``P(("data",))`` and ``P("data")`` are one spec)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def sanitize_spec(spec, shape, mesh) -> tuple:
    """Drop mesh axes that the mesh lacks or that do not divide the dim;
    one entry per dim of ``shape`` (``spec`` None: all replicated)."""
    sizes = mesh_shape(mesh)
    if spec is None:
        return (None,) * len(shape)
    spec = tuple(spec)
    out = []
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a not in sizes for a in axes):
            out.append(None)
            continue
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(entry if dim % size == 0 else None)
    return tuple(out)


def _rule(path: str):
    for pattern, trailing in PARAM_RULES:
        if re.search(pattern, path):
            return trailing
    return None


def spec_for_param(name: str, shape, mesh, *, fsdp_axis: str = "data",
                   tp_axis: str = "model") -> tuple:
    """The placement of port parameter ``name`` of ``shape``: the rule of
    its reference leaf, whose stacking axes are padded with ``None`` and
    then dropped, sanitised against ``mesh``."""
    path, stacked = reference_leaf(name)
    shape = tuple(shape)
    perm = next((p for pat, p in _PERMUTED.items() if re.search(pat, path)),
                None)
    ref_shape = tuple(shape[i] for i in perm) if perm else shape
    trailing = _rule(path)
    if trailing is None:
        return (None,) * len(shape)
    sub = tuple(fsdp_axis if t == "fsdp" else tp_axis if t == "tp" else t
                for t in trailing)
    ndim = len(ref_shape) + stacked
    spec = (None,) * (ndim - len(sub)) + sub
    # The stacking dims never carry an axis unless a rule is longer than
    # the leaf (none is): give them size 1, which no axis divides.
    spec = sanitize_spec(spec, (1,) * stacked + ref_shape, mesh)[stacked:]
    if perm:
        spec = tuple(spec[perm.index(i)] for i in range(len(shape)))
    return spec


def param_shardings(shapes: dict, mesh, *, fsdp_axis: str = "data",
                    tp_axis: str = "model") -> dict:
    """{name: spec} for ``shapes`` ({name: shape}, e.g. from
    ``named_parameters()``)."""
    return {n: spec_for_param(n, s, mesh, fsdp_axis=fsdp_axis,
                              tp_axis=tp_axis) for n, s in shapes.items()}


def opt_state_shardings(param_specs: dict) -> dict:
    """AdamW's moments mirror the parameters; the step is replicated."""
    return {"m": dict(param_specs), "v": dict(param_specs), "step": ()}


def _dp_entry(dp_axes):
    return tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]


def batch_shardings(shapes: dict, mesh, dp_axes=("data",)) -> dict:
    """{key: spec}: each batch leaf's first dim over the dp axes."""
    return {k: sanitize_spec((tuple(dp_axes),), s, mesh)
            for k, s in shapes.items()}


def _cache_path(key: str, leaf: str) -> str:
    """The reference's path of a port cache leaf: a KV cache's leaves sit
    one level deeper there, under ``attn``."""
    return f"{key}/attn/{leaf}" if leaf in ("k", "v", "length") \
        else f"{key}/{leaf}"


def kv_cache_split(n_kv_heads: int, max_len: int, size: int):
    """The dim of a KV cache that a model axis of ``size`` splits:
    ``"heads"`` where the kv heads divide it, else ``"seq"`` where the
    ``max_len`` positions do (so a long cache is not replicated), else
    None (replicated)."""
    if n_kv_heads % size == 0:
        return "heads"
    if max_len % size == 0:
        return "seq"
    return None


def cache_shardings(shapes: dict, mesh, dp_axes=("data",),
                    tp_axis: str = "model") -> dict:
    """{stage key: {leaf: spec}} of decode caches shaped as
    ``models.lm.init_lm_cache``'s ({key: {leaf: shape}}): a KV cache's
    batch dim over dp and its kv-head dim over ``model`` where it
    divides, else its sequence dim; any other leaf's first dim that the
    dp size divides (usually the batch) over dp."""
    sizes = mesh_shape(mesh)
    dp_size = 1
    for a in dp_axes:
        dp_size *= sizes[a]
    out = {}
    for key, leaves in shapes.items():
        out[key] = {}
        for leaf, shape in leaves.items():
            shape = tuple(shape)
            spec = [None] * len(shape)
            if re.search(r"attn/(k|v)$", _cache_path(key, leaf)) \
                    and len(shape) >= 4:
                if shape[-4] % dp_size == 0:
                    spec[-4] = _dp_entry(dp_axes)
                split = kv_cache_split(shape[-2], shape[-3],
                                       sizes[tp_axis])
                if split is not None:
                    spec[-2 if split == "heads" else -3] = tp_axis
            else:
                for i, d in enumerate(shape):
                    if d % dp_size == 0 and d >= dp_size:
                        spec[i] = _dp_entry(dp_axes)
                        break
            out[key][leaf] = sanitize_spec(spec, shape, mesh)
    return out


def scan_dim_spec(ndim: int, scan_dim: int = -2, *,
                  batch_dim: int | None = 0, dp_axes=("data",),
                  seq_axis: str = SEQ_AXIS) -> tuple:
    """The spec sharding ``scan_dim`` over the seq axis (and the batch dim
    over dp): (G, H, W) scan operands by default, (B, H, W, C) vision
    activations with ``scan_dim=1``."""
    spec = [None] * ndim
    spec[scan_dim % ndim] = seq_axis
    if batch_dim is not None and batch_dim % ndim != scan_dim % ndim:
        spec[batch_dim % ndim] = _dp_entry(dp_axes)
    return tuple(spec)


def sp_activation_shardings(shapes: dict, mesh, *, scan_dim: int = -2,
                            batch_dim: int | None = 0, dp_axes=("data",),
                            seq_axis: str = SEQ_AXIS) -> dict:
    """{key: spec} for scan-dim-sharded activations of ``shapes``,
    sanitised, so a mesh without a seq axis degrades to plain dp
    sharding; a leaf of fewer than two dims is replicated."""
    sizes = mesh_shape(mesh)
    dp_axes = tuple(a for a in dp_axes if a in sizes)
    have_seq = seq_axis in sizes
    out = {}
    for k, shape in shapes.items():
        shape = tuple(shape)
        if len(shape) < 2 or not (have_seq or dp_axes):
            out[k] = (None,) * len(shape)
            continue
        spec = scan_dim_spec(len(shape), scan_dim,
                             batch_dim=batch_dim if dp_axes else None,
                             dp_axes=dp_axes or ("data",), seq_axis=seq_axis)
        if not have_seq:
            spec = tuple(None if s == seq_axis else s for s in spec)
        out[k] = sanitize_spec(spec, shape, mesh)
    return out


def sharded_dim(spec, axis: str = "data"):
    """(dim, axes) of the one dim of ``spec`` that names ``axis`` (alone or
    in a tuple), or None when no dim does."""
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if axis in axes:
            return d, axes
    return None
