"""The layout of the train step on a mesh: ZeRO-3 sharding of
parameters, gradients and optimizer state over the mesh's ``data`` axis
(and replication over ``pod``) by the rules of :mod:`parallel.sharding`,
realised with FSDP2 (``torch.distributed.fsdp.fully_shard``), on top of
the tensor parallelism of its ``model`` axis
(:mod:`parallel.tensor_parallel`): FSDP2 wraps each rank's model-local
shard, so a 2-D ``(data, model)`` mesh shards a weight both ways.  A
data-parallel extent of 1 runs no FSDP at all.

Each block of the model (``LM.walk``'s blocks, the encoder's layers) is
one FSDP unit and the model the root: a block's weights are gathered
before it runs and freed after, and again for its backward (under
``remat="unit"`` the recompute finds them gathered); its gradients are
reduce-scattered, as a mean over the data-parallel ranks, when its
backward ends.  A parameter whose spec puts ``data`` on dim d is
``Shard(d)``; the leaves the rules replicate (the embedding, the norms,
the biases, whatever ``r".*"`` catches) are kept out of FSDP
(``ignored_params``), whole on every rank, and their gradients are
all-reduced as a mean here.  On a ``("pod", "data")`` mesh FSDP runs
hybrid: sharded over ``data``, replicated over ``pod``.

Where the ranks share a card, gloo carries the collectives and moves
every CUDA payload through pinned host memory; FSDP2's gathers and
reduce-scatters and the replicated gradients' all-reduces then run as
the counted collectives of :mod:`parallel.collectives` (bytes through
host memory and host time), synchronously.

The optimizer walks each rank's local shards (``to_local()``, views of
FSDP's sharded storage, updated in place); the global gradient norm sums
squares once per distinct element: a leaf's squares summed over each
axis that slices it (data, model or both), a replicated leaf's once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch.mesh import dp_axes_for
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import param_shardings, sharded_dim
from repro_torch.parallel.tensor_parallel import ModelAxis, shard_model


def _axis_group(mesh, axis):
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


class DataParallel:
    """The layout of ``model`` on ``mesh``: construct, then :meth:`shard`
    once, on every rank, with the same full weights.  Construction keeps
    this rank's slices over the model axis (``shard_model``, unless the
    model is sharded over it already) and reads which leaves that axis
    splits from ``model.tp_placements``."""

    def __init__(self, model: nn.Module, mesh, dp_axes=None):
        self.model = model
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes or dp_axes_for(mesh))
        if "data" not in self.dp_axes:
            raise ValueError(f"the data-parallel step needs a 'data' axis; "
                             f"the mesh has {mesh.mesh_dim_names}")
        self.model_axis = ModelAxis.of(mesh)
        if self.model_axis is not None and \
                getattr(model, "model_axis", None) is None:
            shard_model(model, mesh)
        # {name: (dim, parts, index)} of the leaves the model axis splits.
        self.model_placements = getattr(model, "tp_placements", {})
        # The rules read whole shapes: a model-sharded leaf's is its
        # slice's times the axis along the split dim.
        shapes = {}
        for n, p in model.named_parameters():
            shape = list(p.shape)
            if n in self.model_placements:
                dim, parts, _ = self.model_placements[n]
                shape[dim] *= parts
            shapes[n] = tuple(shape)
        self.specs = param_shardings(shapes, mesh)
        names = mesh.mesh_dim_names
        self.data_index = mesh.get_local_rank(names.index("data"))
        self.data_size = mesh.size(names.index("data"))
        self.groups = [_axis_group(mesh, a) for a in self.dp_axes]
        self.data_group = _axis_group(mesh, "data")
        self.dp_size = 1
        for a in self.dp_axes:
            self.dp_size *= mesh.size(names.index(a))
        self.fsdp = self.dp_size > 1
        # Ranks that share a card talk over gloo through host memory.
        self.counted = (next(model.parameters()).device.type == "cuda"
                        and dist.get_backend(self.data_group) != "nccl")
        self.sharded = {n for n, s in self.specs.items()
                        if self.fsdp and sharded_dim(s, "data") is not None}
        self.model_sharded = set(self.model_placements)

    # -- layout ----------------------------------------------------------
    def placements(self) -> dict:
        """{name: placement} of this rank's slices: (dim, parts, index)
        where one axis slices the leaf, a tuple of two such (data, then
        model) where both do."""
        out = {}
        for n in sorted(self.sharded | self.model_sharded):
            parts = []
            if n in self.sharded:
                dim, _ = sharded_dim(self.specs[n], "data")
                parts.append((dim, self.data_size, self.data_index))
            if n in self.model_sharded:
                parts.append(self.model_placements[n])
            out[n] = parts[0] if len(parts) == 1 else tuple(parts)
        return out

    def skipped(self) -> set:
        """The sliced parameters this rank holds and another rank of the
        same slice writes to a checkpoint: a slice is written by the rank
        at index 0 on every axis that does not slice the leaf."""
        names = self.mesh.mesh_dim_names
        zero = {a for i, a in enumerate(names)
                if self.mesh.get_local_rank(i) == 0}
        out = set()
        for n in self.sharded | self.model_sharded:
            slicing = {"data"} if n in self.sharded else set()
            if n in self.model_sharded:
                slicing.add("model")
            if not set(names) - slicing <= zero:
                out.add(n)
        return out

    def _units(self):
        seen, units = set(), []
        for _, _, block in self.model.walk():
            if id(block) not in seen:
                seen.add(id(block))
                units.append(block)
        encoder = getattr(self.model, "encoder", None)
        if encoder is not None:
            units.extend(encoder.layers)
        return units

    def shard(self):
        """Apply FSDP2 to every block and to the model over the data axes
        (each rank's model-local shard); returns self."""
        from torch.distributed.fsdp import (FSDPModule, fully_shard,
                                            register_fsdp_forward_method)
        from torch.distributed.tensor import Shard

        if not self.fsdp or isinstance(self.model, FSDPModule):
            return self
        names = {id(p): n for n, p in self.model.named_parameters()}
        ignored = {p for p in self.model.parameters()
                   if names[id(p)] not in self.sharded}
        fsdp_mesh = self.mesh[self.dp_axes] if len(self.dp_axes) > 1 \
            else self.mesh["data"]

        def place(p):
            return Shard(sharded_dim(self.specs[names[id(p)]], "data")[0])

        modules = self._units() + [self.model]
        for mod in modules:
            fully_shard(mod, mesh=fsdp_mesh, shard_placement_fn=place,
                        ignored_params=ignored)
        if getattr(self.model, "encoder", None) is not None:
            # The root's own sharded leaves (``enc_kv_proj``) are gathered
            # around the encoder's call, the root's forward in a step.
            register_fsdp_forward_method(self.model, "encode")
        if self.counted:
            for mod in modules:
                mod.set_custom_all_gather(collectives.CountedAllGather())
                mod.set_custom_reduce_scatter(
                    collectives.CountedReduceScatter())
        return self

    # -- the step's reductions -------------------------------------------
    def grads(self) -> dict:
        """{name: local gradient} after ``backward``: the reduce-scattered
        mean shard of each sharded parameter, the all-reduced mean of each
        replicated one (exact zeros where the loss does not read a
        parameter).  Clears the parameters' ``.grad``."""
        out = {}
        for n, p in self.model.named_parameters():
            g = p.grad
            if g is None:
                g = torch.zeros_like(local(p))
            elif n in self.sharded:
                g = local(g)
            else:
                g = self.all_mean(g)
            out[n] = g
            p.grad = None
        return out

    def _all_reduce(self, t, op=dist.ReduceOp.SUM, groups=None):
        for group in groups or self.groups:
            if self.counted:
                collectives.all_reduce_counted(t, group, op)
            else:
                dist.all_reduce(t, op=op, group=group)
        return t

    def all_mean(self, t):
        """The mean of ``t`` over the data-parallel ranks."""
        if self.dp_size == 1:
            return t
        return self._all_reduce(t.float().clone()).div_(self.dp_size) \
            .to(t.dtype)

    def all_true(self, flag: bool) -> bool:
        """True iff ``flag`` holds on every rank of the mesh (the model
        axis's ranks hold different slices of the gradients)."""
        t = torch.tensor([0.0 if flag else 1.0])
        if self.dp_size > 1:
            self._all_reduce(t)
        if self.model_axis is not None:
            t = self.model_axis.all_reduce(t)
        return t.item() == 0.0

    def norm(self, grads: dict) -> torch.Tensor:
        """The global gradient norm, each distinct element's square once:
        a leaf's sum of squares summed over the data axis where it is
        data-sharded and over the model axis where it is model-sharded,
        a replicated leaf's taken once."""
        dev = next(iter(grads.values())).device
        by_axes: dict = {}
        for n, g in grads.items():
            key = (n in self.sharded, n in self.model_sharded)
            by_axes.setdefault(key, []).append(g.float().square().sum())
        total = torch.zeros((), device=dev)
        for (data, model), squares in sorted(by_axes.items()):
            part = torch.stack(squares).sum()
            if data:
                part = self._all_reduce(part, groups=[self.data_group])
            if model:
                part = self.model_axis.all_reduce(part)
            total = total + part
        return torch.sqrt(total)

    def leaf_max(self, maxima: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``maxima`` over the data and model
        axes: each global leaf's largest magnitude (a replicated leaf's
        entries agree on every rank already)."""
        if self.fsdp:
            maxima = self._all_reduce(maxima.clone(), dist.ReduceOp.MAX,
                                      [self.data_group])
        if self.model_axis is not None:
            maxima = self.model_axis.all_reduce(maxima, dist.ReduceOp.MAX)
        return maxima


def local(t):
    """A sharded tensor's local shard (a view of FSDP's storage, detached
    from autograd) or the tensor itself."""
    return t.to_local().detach() if hasattr(t, "to_local") else t
