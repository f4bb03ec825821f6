"""The model axis of parallelism: tensor parallelism of attention heads,
FFN hidden width, vocabulary and MoE expert groups over a mesh's
``model`` axis, in PyTorch's eager idiom.

The reference gets tensor parallelism from XLA's SPMD partitioner: it
places each weight by ``parallel.sharding``'s rules and the partitioner
inserts the collectives.  PyTorch has no partitioner, so the port writes
them: every block whose weights the rules split over ``model`` runs the
Megatron pattern with explicit autograd Functions over the counted
collectives of :mod:`parallel.collectives`:

* ``copy`` (identity forward, all-reduce SUM of the gradient backward)
  where a replicated activation enters a branch that each rank computes
  a part of (a column-parallel product, the MoE's experts);
* ``reduce`` (all-reduce SUM forward, identity backward) where the parts
  meet again (after a row-parallel product, the vocabulary's partial
  sums);
* ``mean`` (all-reduce mean forward, the gradient over the ranks
  backward): the MoE's aux loss, equal on every rank;
* ``gather``: the whole of a leaf stored sharded, gathered before use.
  Where every rank then runs the same computation on it (the GSPN
  mixer's ``mix/up`` and ``mix/down``), each rank's gradient of the whole
  is complete and the backward keeps its own slice; where each rank uses
  it for its part only (attention's K/V columns when the kv heads do not
  divide the axis), the backward sums the ranks' gradients first.

Every activation outside those branches is replicated over ``model``
and computed identically on each rank (the norms, the GSPN mixer and its
scans, the router), so its gradient is complete on every rank and the
replicated parameters need no reduction over ``model``.

:func:`shard_model` turns a whole model into this rank's shard: each
parameter the rules split over ``model`` keeps its contiguous slice,
rank ``r`` of ``M`` taking part ``r``, in the rules' order; the layers
that split their arithmetic along it get the :class:`ModelAxis`
(``module.tp``).  Only ``gspn_impl="sp"`` raises under a model axis
larger than 1 (ROADMAP.md §1 item 6.2).

Whisper's encoder runs its attention and GELU MLP split as the decoder's
blocks do (its ``pos_embed``, which the rules split as a vocabulary,
gathered whole), its output whole on every rank; its keys and values
(``models.lm.lm_encode``) are each rank's product with its columns of
``enc_kv_proj``, gathered whole (:meth:`ModelAxis.product`), and each
xattn block's cross-attention reads the kv heads of its own query heads
from them.  The VL model's M-RoPE rotates each rank's heads, and its
vision embeddings replace the first positions after the vocab-parallel
lookup is summed.  Where the axis does not divide the vocabulary
(whisper's 51 865) the rules keep the embedding and the head whole, the
LM has no ``tp`` and its loss is the whole cross entropy.

The recurrent mixers (``mamba``, ``mlstm``, ``slstm``) pack several
heads' projections into one matrix (Mamba-2's z | x | B | C | dt, the
mLSTM's q | k | v | o | f | i, the sLSTM's gates i | f | z | o), so the
rules' column split of ``in_proj`` and ``w_in`` cuts across heads.  Each
mixer (a :class:`HeadParallel`) runs one body over heads [h0, h1), and
:func:`head_split` says which of two paths it takes.  Where the
axis divides the head count, each rank runs the recurrence of its own
heads: the column-parallel product's outputs are gathered whole
(:meth:`ModelAxis.product`), each rank reads its heads' columns of them
and its heads' entries of the other leaves (:meth:`ModelAxis.pick`),
the norm over the inner width takes its sum of squares over the axis
(:meth:`ModelAxis.rmsnorm`), ``out_proj``'s stored rows are the rank's
heads and its partial products are summed; the decode caches stay whole
on every rank, the new state of each rank's heads gathered.  Else every
rank gathers the mixer's split leaves whole and runs it over all its
heads (:meth:`ModelAxis.whole`), as the GSPN mixer does.

The one-shot prefill and the decode step run sharded, as the
reference's dry-run cells lay them out (``launch.lowering``): the KV
caches split by kv heads where they divide the axis, else by positions
(``parallel.sharding.cache_shardings``); a decode step over split
positions combines the ranks' softmax parts with counted collectives
(``models.attention.decode_attention_split``).  The chunked prefill and
the serving engine run without a model axis, as the reference's serving
does, and refuse a sharded model.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import sharded_dim, spec_for_param

MODEL_AXIS = "model"


class ModelAxis:
    """This rank's place on the model axis: its ``group``, ``size`` and
    ``rank``, and the collectives of tensor parallelism over it.  Ranks
    that share a card (gloo) count their payloads' bytes through host
    memory (``collectives.staged_bytes``)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    @classmethod
    def of(cls, mesh) -> "ModelAxis | None":
        """The mesh's model axis, or None when it has none of more than
        one rank."""
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if MODEL_AXIS not in names:
            return None
        i = names.index(MODEL_AXIS)
        if mesh.size(i) == 1:
            return None
        return cls(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i))

    # -- the collectives (no autograd) -----------------------------------
    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """A new tensor: ``t`` reduced over the axis."""
        return collectives.model_all_reduce(
            t.clone(memory_format=torch.contiguous_format), self.group, op)

    def all_gather(self, t, dim: int):
        return collectives.model_all_gather(t, self.group, dim)

    def max(self, t):
        """The elementwise maximum of ``t`` over the axis, in f32."""
        return self.all_reduce(t.detach().float(), dist.ReduceOp.MAX)

    # -- the autograd Functions ------------------------------------------
    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def mean(self, x):
        return _Mean.apply(x, self)

    def gather(self, t, dim: int, partial: bool):
        """The whole of ``t``, this rank's part ``rank`` of ``size`` along
        ``dim``; ``partial``: each rank uses it for its own part (the
        backward sums the ranks' gradients before keeping this rank's
        slice), else every rank computes the same thing with it."""
        return _Gather.apply(t, self, dim % t.dim(), partial)

    # -- parameters of a sharded module ----------------------------------
    def whole(self, module: nn.Module, name: str):
        """``module``'s parameter ``name`` whole, for arithmetic that every
        rank runs in full (gathered where it is stored sliced)."""
        p = getattr(module, name)
        dim = module._tp_dims.get(name)
        return p if dim is None else self.gather(p, dim, partial=False)

    def pick(self, module: nn.Module, name: str, ranges, dim: int = -1):
        """The entries ``ranges[rank]`` (this rank's (lo, hi) pairs along
        ``dim``, joined in order) of ``module``'s parameter ``name``, as a
        branch that each rank computes a part of uses them.  ``ranges``
        holds every rank's pairs, so all ranks agree on the collectives:
        the local slice itself where each rank's pairs are its stored
        slice; else the whole, gathered where the leaf is stored sliced
        along ``dim`` (copied where it is replicated), so the backward
        sums the ranks' gradients, then cut."""
        p = getattr(module, name)
        dim %= p.dim()
        stored = module._tp_dims.get(name)
        if stored is None:
            whole = self.copy(p)
        else:
            assert stored == dim, name
            n = p.shape[dim]
            if all(list(r) == [(i * n, (i + 1) * n)]
                   for i, r in enumerate(ranges)):
                return p
            whole = self.gather(p, dim, partial=True)
        parts = [whole.narrow(dim, lo, hi - lo) for lo, hi in ranges[self.rank]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    def product(self, module: nn.Module, name: str, xc, cast):
        """``xc @ cast(w)`` for ``module``'s whole (D, N) parameter ``name``
        as an activation that each rank then reads its own columns of:
        where the rules split its columns, each rank's product with its
        slice, gathered over the axis (its bytes grow with the tokens, not
        with the weight); where they replicate it, the product itself.
        Either way the backward sums the ranks' gradients of the whole
        activation, so the input's and the weight's are complete."""
        if name in module._tp_dims:
            y = self.copy(xc) @ cast(getattr(module, name))
            return self.gather(y, -1, partial=True)
        return self.copy(xc @ cast(getattr(module, name)))

    def rmsnorm(self, x, scale, eps: float, dim: int):
        """The reference's rmsnorm of rows whose ``dim`` entries are split
        over the axis, ``x`` (..., dim / size) and ``scale`` this rank's
        part: the mean square from the rows' sums of squares summed over
        the axis (forward and backward), then ``x * inv * scale`` in
        ``x.dtype``, as :func:`models.layers._rmsnorm`."""
        ss = self.copy(self.reduce(x.float().square().sum(-1)))
        inv = torch.rsqrt(ss / dim + eps)
        return x * inv[..., None].to(x.dtype) * scale.to(x.dtype)

    # -- the vocabulary ---------------------------------------------------
    def embed(self, table, tokens):
        """The vocab-parallel lookup: rows of this rank's slice of the
        table (V/M, D), zero for tokens outside it, summed over the axis
        (one non-zero term a token: exact)."""
        v = table.shape[0]
        local = tokens.long() - self.rank * v
        inside = (local >= 0) & (local < v)
        rows = table[local.clamp(0, v - 1)]
        return torch.where(inside[..., None], rows, 0.0)

    def cross_entropy(self, logits, labels, mask=None):
        """``models.layers.cross_entropy_loss`` over vocab-sharded logits
        (B, S, V/M): the row maximum by an all-reduce MAX (taken in the
        logits' dtype, exact in f32), the sum of exponentials in f32 and
        the label's logit by all-reduces SUM, the mean over the tokens or
        the mask.  No rank builds the whole (B, S, V)."""
        v = logits.shape[-1]
        lf = logits.float()
        m = self.max(logits.amax(-1, keepdim=True))
        lse = m[..., 0] + torch.log(self.reduce(torch.exp(lf - m).sum(-1)))
        local = labels.long() - self.rank * v
        inside = (local >= 0) & (local < v)
        ll = lf.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
        nll = lse - self.reduce(torch.where(inside, ll, 0.0))
        if mask is not None:
            mask = mask.float()
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.size = axis.size
        return axis.all_reduce(x) / axis.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim, partial):
        ctx.axis, ctx.dim, ctx.partial, ctx.n = axis, dim, partial, \
            t.shape[dim]
        return axis.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        if ctx.partial:
            g = axis.all_reduce(g)
        return g.narrow(ctx.dim, axis.rank * ctx.n, ctx.n).contiguous(), \
            None, None, None


# ---------------------------------------------------------------------------
# Sharding a model.
# ---------------------------------------------------------------------------

def model_dim(name: str, shape, size: int):
    """The dim that the rules split parameter ``name`` of (whole) ``shape``
    along over a model axis of ``size``, or None."""
    d = sharded_dim(spec_for_param(name, shape, {MODEL_AXIS: size}),
                    MODEL_AXIS)
    return None if d is None else d[0]


def model_slice(name: str, t, size: int, rank: int):
    """Rank ``rank``'s part of the whole tensor ``t`` of parameter
    ``name`` over a model axis of ``size`` (``t`` itself where the rules
    replicate it)."""
    dim = model_dim(name, tuple(t.shape), size)
    if dim is None:
        return t
    n = t.shape[dim] // size
    return t[(slice(None),) * dim + (slice(rank * n, (rank + 1) * n),)]


def head_split(n_heads: int, size: int):
    """Every rank's heads [h0, h1) over a model axis of ``size`` where it
    divides ``n_heads`` (each rank then runs its own heads), else None
    (the mixer runs whole on every rank)."""
    if n_heads % size:
        return None
    n = n_heads // size
    return [(r * n, (r + 1) * n) for r in range(size)]


class HeadParallel(nn.Module):
    """A recurrent mixer (``cfg.n_heads`` heads) on the model axis
    (``tp``, set by :func:`shard_model`): where the axis divides the heads
    each rank runs its own heads [h0, h1) (:meth:`_heads`), else every
    rank runs all of them with its split leaves gathered.  The mixer's
    one body runs over [h0, h1) on either path (all heads without an
    axis) through the helpers below."""

    tp = None

    def _split(self):
        """Every rank's heads [(h0, h1), ...] where a model axis divides
        them, else None (no axis, or the mixer runs whole)."""
        if self.tp is None:
            return None
        return head_split(self.cfg.n_heads, self.tp.size)

    def _own(self):
        """This rank's heads (h0, h1) on the heads path, else None."""
        split = self._split()
        return None if split is None else split[self.tp.rank]

    def _heads(self):
        """This rank's heads (h0, h1): its own on the heads path, else
        all of them."""
        return self._own() or (0, self.cfg.n_heads)

    def _leaf(self, name: str, cols=None, dim: int = -1, module=None):
        """Parameter ``name`` of ``module`` (this mixer by default) as the
        body uses it: on the heads path the entries ``cols(h0, h1)`` (the
        (lo, hi) pairs along ``dim`` of heads [h0, h1)) of this rank's
        heads (:meth:`ModelAxis.pick`); else the whole leaf, gathered
        over a model axis where it is stored sliced (``cols`` of all the
        heads then covers it)."""
        module = self if module is None else module
        split = self._split()
        if split is not None:
            return self.tp.pick(module, name, [cols(*h) for h in split], dim)
        return getattr(module, name) if self.tp is None \
            else self.tp.whole(module, name)

    def _column_product(self, name: str, x):
        """``x`` @ parameter ``name`` (D, N) in the compute dtype, every
        column: on the heads path each rank's product with its slice,
        gathered (:meth:`ModelAxis.product`); each rank then reads its
        heads' columns."""
        cast = self.policy.cast
        if self._split() is None:
            return cast(x) @ cast(self._leaf(name))
        return self.tp.product(self, name, cast(x), cast)

    def _row_product(self, y, rows):
        """``y`` (this rank's heads' columns) @ ``out_proj`` in the compute
        dtype: on the heads path its rows ``rows(h0, h1)`` (the stored
        slice where the rules split them) and the partial products
        summed over the axis."""
        cast = self.policy.cast
        out = cast(y) @ cast(self._leaf("out_proj", rows, 0))
        return out if self._split() is None else self.tp.reduce(out)

    def _norm(self, y, cols, dim: int):
        """``self.norm`` over the ``dim`` channels of ``y``: on the heads
        path this rank's columns ``cols(h0, h1)``, the mean square summed
        over the axis (:meth:`ModelAxis.rmsnorm`)."""
        if self._split() is None:
            return self.norm(y)
        return self.tp.rmsnorm(y, self._leaf("scale", cols, module=self.norm),
                               self.norm.eps, dim)

    def _whole_state(self, state, dim: int = 1):
        """A recurrent state over every head: this rank's heads' gathered
        along ``dim`` on the heads path."""
        return state if self._split() is None \
            else self.tp.all_gather(state, dim)


def check_model_axis(cfg, size: int) -> None:
    """Raise for what does not run under a model axis of ``size`` > 1:
    ``gspn_impl="sp"`` and an attn_moe layer whose slabs are laid out for
    another extent."""
    if size <= 1:
        return
    kinds = {kind for _, kind, _ in cfg.stages()}
    if "gspn" in kinds and cfg.gspn_impl == "sp":
        raise NotImplementedError(
            f'{cfg.name}: gspn_impl="sp" under a model axis of {size} is '
            f"not in the port yet; ROADMAP.md §1 item 6.2 keeps it")
    if "attn_moe" in kinds and cfg.n_model_shards != size:
        raise ValueError(
            f"{cfg.name}: the MoE's slabs are laid out for n_model_shards="
            f"{cfg.n_model_shards}; the model axis has {size} ranks")


def _split_by(module):
    """The parameter whose split turns ``module``'s tensor parallelism on
    ("*": any of its or its submodules' parameters), or None for a module
    that has none."""
    from repro_torch.core.gspn import GSPNSeqMixer
    from repro_torch.models.attention import Attention
    from repro_torch.models.layers import GeluMLP, SwiGLU
    from repro_torch.models.lm import LM, Encoder
    from repro_torch.models.moe import MoE

    for cls, key in ((SwiGLU, "down"), (GeluMLP, "fc2"), (Attention, "wo"),
                     (MoE, "gate_slab"), (GSPNSeqMixer, "*"),
                     (HeadParallel, "*"), (LM, "embed"),
                     (Encoder, "pos_embed")):
        if isinstance(module, cls):
            return key
    return None


def shard_model(model: nn.Module, mesh) -> dict:
    """Keep this rank's part of every parameter of ``model`` (a whole
    ``models.lm.LM``) that the rules split over ``mesh``'s model axis, and
    give each layer that then splits its arithmetic the axis
    (``module.tp``; the LM's own ``model.model_axis`` in any case).
    Returns {parameter name: (dim, size, rank)}, empty without a model
    axis of more than one rank.  Run it once, on every rank of the axis,
    on the same whole weights."""
    axis = ModelAxis.of(mesh)
    if axis is None:
        return {}
    if getattr(model, "model_axis", None) is not None:
        raise ValueError("the model is sharded over a model axis already")
    check_model_axis(model.cfg, axis.size)
    placements = {}
    for mod_name, module in model.named_modules():
        module._tp_dims = {}
        for pname, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            dim = model_dim(name, tuple(p.shape), axis.size)
            if dim is None:
                continue
            part = model_slice(name, p.detach(), axis.size, axis.rank)
            module._parameters[pname] = nn.Parameter(
                part.clone(), requires_grad=p.requires_grad)
            module._tp_dims[pname] = dim
            placements[name] = (dim, axis.size, axis.rank)
    for module in model.modules():
        key = _split_by(module)
        if key is not None:
            module.tp = axis if key in module._tp_dims or (
                key == "*" and any(m._tp_dims for m in module.modules())) \
                else None
    model.model_axis, model.tp_placements = axis, placements
    return placements
