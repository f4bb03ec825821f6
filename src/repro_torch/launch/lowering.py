"""Cell builders for the dry run, the port of ``repro.launch.lowering``:
one (architecture × input shape × mesh) combination -> a callable, its
``meta`` arguments and its metadata, ready to run under
``roofline.cost.CostMode``.

The reference jit-lowers each cell for XLA's partitioner, which places
the parameters by the sharding rules and inserts the collectives.  Here
a cell is rank 0's program of the production mesh, run eagerly on
``meta`` tensors under a fake process group (``launch.dryrun``):

* The LM is built on ``meta`` at ``full(n_model_shards=tp)`` and sharded
  over the mesh's ``model`` axis as the launcher shards it
  (``parallel.tensor_parallel.shard_model``): its collectives run
  through the fake group and are counted
  (``parallel.collectives.link_bytes``).
* The data axis is FSDP2's in training (``parallel.data_parallel``),
  which refuses ``meta`` parameters.  So the cell runs each unit with
  its weights whole over ``data`` and charges what FSDP2 would run from
  the rules' per-dimension specs (``parallel.sharding.param_shardings``):
  every data-sharded weight gathered once a pass (forward, and again in
  the backward), its gradient reduce-scattered, every replicated
  gradient all-reduced in f32 over each data-parallel axis (and a
  sharded one over ``pod``), once a microbatch; the optimizer updates
  this rank's shards.  The peak counts the state at its sharded size
  plus two units' gathered weights (the one running and the one
  prefetched).  A prefill or decode cell gathers each data-sharded
  weight once.
* Train cells follow the reference's rules: the ``BF16_PARAM_ARCHS``
  store bf16 parameters, AdamW keeps bf16 moments above 5e10 parameters,
  and ``grad_accum`` splits the rank's batch until a microbatch holds at
  most ~25M token-features (at most 8 for the MoE).
* The vision cells (:data:`VISION_SHAPES`) run the port's kernels'
  ``meta`` path, which records each launch the card would run; the
  reference runs its plain scans (``impl="xla"``) there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES, ShapeSpec, get_arch, input_specs
from repro_torch.launch.mesh import dp_axes_for
from repro_torch.models import lm as lm_mod
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel.sharding import (batch_shardings, mesh_shape,
                                           param_shardings, sharded_dim)
from repro_torch.parallel.tensor_parallel import shard_model

# Archs whose params+Adam state exceed HBM in f32: store bf16 (DESIGN §5).
BF16_PARAM_ARCHS = {"kimi-k2-1t-a32b", "grok-1-314b", "qwen2-vl-72b"}

VISION_SHAPES = {
    "img_train_224": ShapeSpec("img_train_224", "train", 224, 1024),
    "img_infer_1024": ShapeSpec("img_infer_1024", "prefill", 1024, 16),
}


@dataclasses.dataclass
class Cell:
    """``fn(*args)`` is rank 0's program.  ``resident`` is what it holds
    at the start (state at its sharded size, the batch, caches),
    ``collectives`` the data axis's (op, payload) list that FSDP2 would
    run, ``gathered_bytes`` the weights two units hold gathered."""
    name: str
    fn: Callable
    args: tuple
    meta: dict
    resident: Any = ()
    collectives: list = dataclasses.field(default_factory=list)
    gathered_bytes: int = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _prod(xs) -> int:
    return math.prod(xs) if xs else 1


class _DataAxis:
    """The data axis of a cell: each parameter's spec (of its whole leaf),
    which of them FSDP2 shards, their units, and this rank's shard of a
    tensor shaped as a parameter."""

    def __init__(self, model, mesh, units, tp_placements=None):
        self.sizes = mesh_shape(mesh)
        self.dp_axes = dp_axes_for(mesh)
        self.data = self.sizes.get("data", 1)
        self.pod = self.sizes.get("pod", 1)
        self.params = dict(model.named_parameters())
        placements = tp_placements or {}
        shapes = {}
        for n, p in self.params.items():
            shape = list(p.shape)
            if n in placements:
                dim, parts, _ = placements[n]
                shape[dim] *= parts
            shapes[n] = tuple(shape)
        self.specs = param_shardings(shapes, mesh)
        self.dims = {}
        for n in self.params:
            d = sharded_dim(self.specs[n], "data") if self.data > 1 else None
            if d is not None:
                self.dims[n] = d[0]
        unit_of = {}
        for i, unit in enumerate(units):
            for p in unit.parameters():
                unit_of.setdefault(id(p), i)
        self.units: dict = {}
        for n, p in self.params.items():
            if n in self.dims:
                self.units.setdefault(unit_of.get(id(p), -1), []).append(n)

    def shard(self, name, t):
        """This rank's (rank 0's) slice of ``t`` along the parameter's
        data dim: a view."""
        dim = self.dims.get(name)
        if dim is None:
            return t
        return t.narrow(dim, 0, t.shape[dim] // self.data)

    def local_state(self):
        """This rank's parameters: a ``meta`` shard beside each sharded
        parameter, the parameter itself where the data axis replicates
        it."""
        return {n: torch.empty(self.shard(n, p).shape, dtype=p.dtype,
                               device="meta") if n in self.dims else p
                for n, p in self.params.items()}

    def gathered_bytes(self) -> int:
        """Two units' gathered weights: the largest unit's, twice."""
        per = [sum(_nbytes(self.params[n]) for n in names)
               for names in self.units.values()]
        return 2 * max(per, default=0)

    def collectives(self, kind: str, k: int) -> list:
        """The (op, payload) list of one call of a ``kind`` cell with ``k``
        microbatches: one all-gather a unit a pass (two passes to train),
        a reduce-scatter a unit and, over ``pod``, an all-reduce of the
        shard a unit, an f32 all-reduce of each replicated gradient over
        each data-parallel axis; each once a microbatch."""
        out = []
        passes = 2 if kind == "train" else 1
        for names in self.units.values():
            nb = sum(_nbytes(self.params[n]) for n in names)
            out += [("all-gather", nb)] * (passes * k)
            if kind == "train":
                out += [("reduce-scatter", nb)] * k
                if self.pod > 1:
                    out += [("all-reduce", nb // self.data)] * k
        if kind == "train":
            axes = [a for a in self.dp_axes if self.sizes[a] > 1]
            for n, p in self.params.items():
                if n not in self.dims:
                    out += [("all-reduce", 4 * p.numel())] * (k * len(axes))
        return out


def _local_batch(batch: dict, mesh, dp_axes) -> dict:
    """Rank 0's rows of each leaf: its first dim over the data-parallel
    axes where they divide it (``batch_shardings``), else whole."""
    sizes = mesh_shape(mesh)
    specs = batch_shardings({k: tuple(v.shape) for k, v in batch.items()},
                            mesh, dp_axes)
    out = {}
    for k, v in batch.items():
        parts = _prod([sizes[a] for a in dp_axes]) if specs[k][0] else 1
        out[k] = torch.empty((v.shape[0] // parts,) + tuple(v.shape[1:]),
                             dtype=v.dtype, device="meta")
    return out


def _grad_accum(cfg, shape: ShapeSpec, dp: int, grad_accum) -> int:
    """The reference's microbatch rule: split the rank's batch until a
    microbatch holds at most ~25M token-features, capped at 8 for the
    MoE (its FSDP weight gathers scale with the count)."""
    b_loc = max(shape.global_batch // dp, 1)
    tokens_feat = b_loc * shape.seq_len * cfg.d_model
    if grad_accum is not None:
        return grad_accum
    grad_accum = 1
    k_cap = 8 if cfg.n_experts else b_loc
    while (tokens_feat // grad_accum > 25e6
           and grad_accum < min(b_loc, k_cap)
           and b_loc % (grad_accum * 2) == 0):
        grad_accum *= 2
    return grad_accum


def _train_fn(loss_of, axis: _DataAxis, ocfg: AdamWConfig, k: int):
    """One step of rank 0: the loss of each of ``k`` microbatches and its
    backward, each gradient cut to this rank's shard (the reduce-scatter)
    as it is accumulated (in f32, or bf16 for bf16 parameters), then
    AdamW on the shards."""
    params = axis.params

    def step(state, batch):
        acc = {n: torch.zeros(axis.shard(n, p).shape,
                              dtype=p.dtype if p.dtype == torch.bfloat16
                              else torch.float32, device=p.device)
               for n, p in params.items()}
        hooks = []
        for n, p in params.items():
            def add(p, n=n):
                acc[n].add_(axis.shard(n, p.grad).to(acc[n].dtype))
                p.grad = None
            hooks.append(p.register_post_accumulate_grad_hook(add))
        rows = next(iter(batch.values())).shape[0]
        loss_sum = 0.0
        try:
            for i in range(k):
                mb = {key: v[i * (rows // k):(i + 1) * (rows // k)]
                      for key, v in batch.items()}
                loss = loss_of(mb)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
        finally:
            for h in hooks:
                h.remove()
        grads = {n: (a.float() / k).to(state["params"][n].dtype)
                 for n, a in acc.items()}
        stats = adamw_update(ocfg, grads, state["opt"], state["params"])
        return state, {"loss": loss_sum / k, **stats}

    return step


def _units(model) -> list:
    seen, units = set(), []
    for _, _, block in model.walk():
        if id(block) not in seen:
            seen.add(id(block))
            units.append(block)
    return units


def build_lm_cell(arch: str, shape_name: str, mesh, *,
                  remat: str | None = None, grad_accum: int | None = None,
                  extra_overrides: dict | None = None,
                  spec: ShapeSpec | None = None,
                  reduced: bool = False) -> Cell:
    """The (arch, shape) cell of rank 0 on ``mesh`` (a ``DeviceMesh`` over
    the fake group, with a ``model`` axis).  Raises for a config the
    model axis does not run yet (``gspn_impl="sp"``:
    ``check_model_axis``, ROADMAP.md §1 item 6.2).  A decode cell of the
    ``audio`` family takes the encoder's ``enc_kv`` as the reference's
    does: (B_local, enc_len, Hkv, D) each in the compute dtype, split
    over the data axes and whole over ``model``.  ``spec`` stands in for
    ``SHAPES[shape_name]`` and ``reduced`` takes the arch's reduced
    config (at ``n_model_shards`` = the model extent), for small
    checks."""
    entry = get_arch(arch)
    shape = spec or SHAPES[shape_name]
    sizes = mesh_shape(mesh)
    tp = sizes["model"]
    dp_axes = dp_axes_for(mesh)
    dp = _prod([sizes[a] for a in dp_axes])
    cfg = dataclasses.replace(entry.reduced(), n_model_shards=tp) \
        if reduced else entry.full(n_model_shards=tp)
    overrides = {}
    if arch in BF16_PARAM_ARCHS:
        overrides["param_dtype"] = torch.bfloat16
    if remat is not None:
        overrides["remat"] = remat
    if extra_overrides:
        overrides.update(extra_overrides)
    cfg = dataclasses.replace(cfg, **overrides)
    model = lm_mod.LM(cfg, device="meta")
    n_params = lm_mod.count_params(model)
    shard_model(model, mesh)
    ctx = lm_mod.Ctx(mesh=mesh)
    axis = _DataAxis(model, mesh, _units(model),
                     getattr(model, "tp_placements", None))
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "n_params": n_params, "family": cfg.family,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    name = f"{arch}__{shape_name}"

    if shape.kind == "train":
        ocfg = AdamWConfig(state_dtype=torch.bfloat16 if n_params > 5e10
                           else torch.float32)
        params = axis.local_state()
        state = {"params": params, "opt": adamw_init(ocfg, params)}
        batch = _local_batch(input_specs(cfg, shape), mesh, dp_axes)
        k = _grad_accum(cfg, shape, dp, grad_accum)
        meta["grad_accum"] = k
        fn = _train_fn(lambda mb: lm_mod.lm_loss(model, mb, ctx=ctx)[0],
                       axis, ocfg, k)
        return Cell(name=name, fn=fn, args=(state, batch), meta=meta,
                    resident=(state, batch),
                    collectives=axis.collectives("train", k),
                    gathered_bytes=axis.gathered_bytes())

    params = axis.local_state()
    if shape.kind == "prefill":
        batch = _local_batch(input_specs(cfg, shape), mesh, dp_axes)

        def prefill_fn(batch):
            with torch.no_grad():
                enc_kv = None
                if "enc_frames" in batch:
                    enc_kv = lm_mod.lm_encode(model, batch["enc_frames"])
                return lm_mod.lm_prefill(
                    model, batch["tokens"], shape.seq_len, ctx=ctx,
                    vision_embeds=batch.get("vision_embeds"), enc_kv=enc_kv)

        return Cell(name=name, fn=prefill_fn, args=(batch,), meta=meta,
                    resident=(params, batch),
                    collectives=axis.collectives("prefill", 1),
                    gathered_bytes=axis.gathered_bytes())

    token = _local_batch(input_specs(cfg, shape), mesh, dp_axes)["token"]
    caches = lm_mod.init_lm_cache(cfg, token.shape[0], shape.seq_len,
                                  device="meta",
                                  model_axis=model.model_axis)

    enc_kv = None
    if cfg.family == "audio":
        enc_kv = tuple(torch.empty((token.shape[0], cfg.enc_len,
                                    cfg.n_kv_heads, cfg.hd),
                                   dtype=cfg.compute_dtype, device="meta")
                       for _ in "kv")

    def decode_fn(token, caches, enc_kv):
        with torch.no_grad():
            return lm_mod.lm_decode_step(model, token, caches, ctx=ctx,
                                         enc_kv=enc_kv)

    return Cell(name=name, fn=decode_fn, args=(token, caches, enc_kv),
                meta=meta, resident=(params, token, caches, enc_kv),
                collectives=axis.collectives("decode", 1),
                gathered_bytes=axis.gathered_bytes())


def build_vision_cell(arch: str, shape_name: str, mesh) -> Cell:
    """The GSPN-2 vision cell of rank 0: the backbone replicated over
    ``model``, the batch over the data-parallel axes, on the kernels'
    ``meta`` path."""
    from repro_torch.configs.gspn2_vision import VISION_CONFIGS
    from repro_torch.models import vision as vis_mod

    shape = VISION_SHAPES[shape_name]
    vcfg = dataclasses.replace(VISION_CONFIGS[arch], img_size=shape.seq_len)
    dp_axes = dp_axes_for(mesh)
    model = vis_mod.GSPNVision(vcfg, device="meta")
    blocks = [b for stage in model.stages for b in stage.blocks]
    axis = _DataAxis(model, mesh, blocks)
    b = shape.global_batch
    batch = _local_batch({
        "images": torch.empty((b, vcfg.img_size, vcfg.img_size, 3),
                              device="meta"),
        "labels": torch.empty((b,), dtype=torch.int32, device="meta")},
        mesh, dp_axes)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "n_params": sum(p.numel() for p in model.parameters()),
            "family": "vision", "seq_len": vcfg.img_size,
            "global_batch": b}
    name = f"{arch}__{shape_name}"
    params = axis.local_state()
    if shape.kind == "train":
        ocfg = AdamWConfig()
        state = {"params": params, "opt": adamw_init(ocfg, params)}
        fn = _train_fn(lambda mb: vis_mod.vision_loss(model, mb)[0], axis,
                       ocfg, 1)
        return Cell(name=name, fn=fn, args=(state, batch), meta=meta,
                    resident=(state, batch),
                    collectives=axis.collectives("train", 1),
                    gathered_bytes=axis.gathered_bytes())

    def infer_fn(batch):
        return vis_mod.apply_vision(model, batch["images"])

    return Cell(name=name, fn=infer_fn, args=(batch,), meta=meta,
                resident=(params, batch),
                collectives=axis.collectives("prefill", 1),
                gathered_bytes=axis.gathered_bytes())
