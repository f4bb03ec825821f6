"""The data axis of the train step: ZeRO-3 sharding of parameters,
gradients and optimizer state over the mesh's ``data`` axis (and
replication over ``pod``) by the rules of :mod:`parallel.sharding`,
realised with FSDP2 (``torch.distributed.fsdp.fully_shard``).

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
the shards' squares over the data axis and counts the replicated leaves
once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch.mesh import dp_axes_for
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import param_shardings, sharded_dim


def _axis_group(mesh, axis):
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


class DataParallel:
    """The data-parallel layout of ``model`` on ``mesh``: construct, then
    :meth:`shard` once, on every rank, with the same full weights."""

    def __init__(self, model: nn.Module, mesh, dp_axes=None):
        self.model = model
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes or dp_axes_for(mesh))
        if "data" not in self.dp_axes:
            raise ValueError(f"the data-parallel step needs a 'data' axis; "
                             f"the mesh has {mesh.mesh_dim_names}")
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.specs = param_shardings(shapes, mesh)
        names = mesh.mesh_dim_names
        self.data_index = mesh.get_local_rank(names.index("data"))
        self.data_size = mesh.size(names.index("data"))
        self.groups = [_axis_group(mesh, a) for a in self.dp_axes]
        self.data_group = _axis_group(mesh, "data")
        self.dp_size = 1
        for a in self.dp_axes:
            self.dp_size *= mesh.size(names.index(a))
        # Ranks that share a card talk over gloo through host memory.
        self.counted = (next(model.parameters()).device.type == "cuda"
                        and dist.get_backend(self.data_group) != "nccl")
        self.sharded = {n for n, s in self.specs.items()
                        if sharded_dim(s, "data") is not None}

    # -- layout ----------------------------------------------------------
    def placements(self) -> dict:
        """{name: (dim, parts, index)} of this rank's shards."""
        out = {}
        for n in self.sharded:
            dim, _ = sharded_dim(self.specs[n], "data")
            out[n] = (dim, self.data_size, self.data_index)
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
        """Apply FSDP2 to every block and to the model; returns self."""
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

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
        return self._all_reduce(t.float().clone()).div_(self.dp_size) \
            .to(t.dtype)

    def all_true(self, flag: bool) -> bool:
        """True iff ``flag`` holds on every data-parallel rank."""
        t = torch.tensor([0.0 if flag else 1.0])
        self._all_reduce(t)
        return t.item() == 0.0

    def norm(self, grads: dict) -> torch.Tensor:
        """The global gradient norm: the shards' sum of squares summed
        over the data axis, plus the replicated leaves' once."""
        dev = next(iter(grads.values())).device
        sharded = [g.float().square().sum() for n, g in grads.items()
                   if n in self.sharded]
        whole = [g.float().square().sum() for n, g in grads.items()
                 if n not in self.sharded]
        total = torch.zeros((), device=dev)
        if sharded:
            total = self._all_reduce(torch.stack(sharded).sum(),
                                     groups=[self.data_group])
        if whole:
            total = total + torch.stack(whole).sum()
        return torch.sqrt(total)

    def leaf_max(self, maxima: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``maxima`` over the data axis (the
        replicated leaves' entries agree on every rank already)."""
        return self._all_reduce(maxima.clone(), dist.ReduceOp.MAX,
                                [self.data_group])


def local(t):
    """A sharded tensor's local shard (a view of FSDP's storage, detached
    from autograd) or the tensor itself."""
    return t.to_local().detach() if hasattr(t, "to_local") else t
