"""The LM train step: loss -> gradients -> (compression) -> AdamW, the
port of the reference's ``train/step.py``.

A train state is a dict: ``params`` (the model's own parameters by name,
``dict(model.named_parameters())``; on a data-parallel mesh, each rank's
local shards), ``opt`` (:func:`adamw_init`'s moments and step), and
optionally ``errors`` (int8 compression's residuals), ``master`` and
``loss_scale``.  :func:`init_train_state` builds it;
:func:`build_train_step` returns ``train_step(state, batch) -> (state,
metrics)``, which updates the state in place (AdamW writes parameters and
moments in place) and returns it.

**Data parallelism.**  With a ``mesh`` that has a ``data`` axis (and
optionally ``pod``), the model's weights, gradients, moments and
residuals are sharded as ``parallel.sharding``'s rules say
(``parallel.data_parallel``: FSDP2, ZeRO-3), each rank's batch is its
slice of the global one, gradients reach the optimizer as the mean over
the ranks, the clipping norm is the global one and the reported loss is
the ranks' mean.  :func:`make_train_setup` builds the whole of it from a
seed: every rank draws the same full weights, keeps its shards and frees
the rest.

**Tensor parallelism.**  A ``model`` axis of more than one rank splits
heads, FFN hidden width, vocabulary and expert groups
(``parallel.tensor_parallel``): each rank keeps its slice of every leaf
the rules split over ``model``, the collectives run inside the layers'
autograd Functions, and FSDP2 over ``data`` wraps the model-local shards.
The loss is vocab-parallel and equal on the model axis's ranks; the
gradient norm counts each distinct element once.

**int8 error feedback** (``grad_compression="int8_ef"``, the
reference's): each leaf's reduced gradient plus its residual is
quantised to int8 with one scale for the whole (global) reference leaf,
which stacks a stage's blocks, and dequantised; the residual stays in
``state["errors"]`` (f32, placed as its parameter).

Mixed-precision training (DESIGN.md §10): with ``master_weights`` the
working parameters stay in the model's ``param_dtype`` (bf16 under the
``bf16`` preset) while an f32 master copy lives in ``state["master"]``;
the optimizer updates the master, whose moments are f32, and the working
copy is re-cast from it after every applied step.  ``loss_scaling``
multiplies the loss by a running scale before differentiation, checks the
raw (scaled) gradients for non-finite values, unscales them in f32 and
backs the scale off on overflow; ``growth_interval`` finite steps in a
row grow it.  A step with a non-finite gradient changes nothing: the
reference keeps the old parameters, moments, master and step count with a
``jnp.where``; here the update is skipped outright (no moment update, no
step increment), which reads one flag back from the device per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.lm import LM, Ctx, LMConfig, lm_loss
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm, lr_at, reference_leaf)
from repro_torch.parallel.data_parallel import DataParallel, local

GRAD_COMPRESSION = ("none", "int8_ef")


# ---------------------------------------------------------------------------
# Dynamic loss scaling (DESIGN.md §10).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    init_scale: float = 2.0 ** 15
    growth_interval: int = 200     # consecutive finite steps before growth
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24


def loss_scale_init(cfg: LossScaleConfig) -> dict:
    """{"scale": f32, "good_steps": int32}, 0-dim CPU tensors."""
    return {"scale": torch.tensor(cfg.init_scale, dtype=torch.float32),
            "good_steps": torch.tensor(0, dtype=torch.int32)}


def loss_scale_update(cfg: LossScaleConfig, state: dict,
                      grads_finite) -> dict:
    """The pure scale-state transition: back off on overflow, grow after
    ``growth_interval`` consecutive finite steps."""
    finite = torch.as_tensor(grads_finite, dtype=torch.bool)
    scale, good = state["scale"], state["good_steps"]
    grown = torch.clamp(scale * cfg.growth_factor, max=cfg.max_scale)
    backed = torch.clamp(scale * cfg.backoff_factor, min=cfg.min_scale)
    hit = good + 1 >= cfg.growth_interval
    new_scale = torch.where(finite, torch.where(hit, grown, scale), backed)
    new_good = torch.where(finite & ~hit, good + 1, torch.zeros_like(good))
    return {"scale": new_scale, "good_steps": new_good}


def tree_all_finite(tensors) -> torch.Tensor:
    """A 0-dim bool tensor: every element of every tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


# ---------------------------------------------------------------------------
# State and step.
# ---------------------------------------------------------------------------

def init_train_state(model: LM, opt_cfg: AdamWConfig, *,
                     master_weights: bool = False,
                     loss_scaling: LossScaleConfig | None = None,
                     grad_compression: str = "none") -> dict:
    """The train state of ``model``: its parameters (this rank's shards of
    a sharded model), AdamW's state for the parameters the optimizer walks
    (the f32 master copy when ``master_weights``), f32 zero residuals
    under ``grad_compression="int8_ef"``, and the loss-scale state when
    ``loss_scaling``."""
    params = {n: local(p) for n, p in model.named_parameters()}
    state = {"params": params}
    if master_weights:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in params.items()}
    state["opt"] = adamw_init(opt_cfg, state.get("master", params))
    if grad_compression == "int8_ef":
        state["errors"] = {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for n, p in params.items()}
    if loss_scaling is not None:
        state["loss_scale"] = loss_scale_init(loss_scaling)
    return state


def _leaf_amax(xs: dict, dp=None) -> dict:
    """{name: the largest magnitude of the reference leaf that parameter
    ``name`` belongs to}: the reference quantises each pytree leaf with
    one scale, and a leaf stacks the parameters of every block of a
    stage (``optim.adamw.reference_leaf``).  Under ``dp`` the maxima are
    of the global leaves (one all-reduce MAX over the data axis)."""
    groups: dict = {}
    for n in xs:
        groups.setdefault(reference_leaf(n)[0], []).append(n)
    paths = list(groups)
    local = torch.stack([torch.stack([xs[n].abs().max() for n in groups[p]])
                         .max() for p in paths])
    if dp is not None:
        local = dp.leaf_max(local)
    return {n: local[i] for i, p in enumerate(paths) for n in groups[p]}


def _int8_ef(g, e, amax):
    """The reference's per-leaf int8 error feedback with the leaf's
    largest magnitude ``amax`` (of the global leaf under sharding):
    (the dequantised gradient in ``g``'s dtype, the new residual)."""
    x = g.float() + e
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    gh = q.float() * scale
    return gh.to(g.dtype), x - gh


def build_train_step(model: LM, opt_cfg: AdamWConfig, *, mesh=None,
                     dp_axes=None, grad_compression: str = "none",
                     grad_accum: int = 1, master_weights: bool = False,
                     loss_scaling: LossScaleConfig | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a state
    from :func:`init_train_state` over ``model``.

    With ``mesh`` (a ``DeviceMesh`` with a ``data`` axis; ``dp_axes`` its
    data-parallel axes, ``launch.mesh.dp_axes_for`` by default) the step
    is data-parallel (and, over a ``model`` axis, tensor-parallel):
    ``model`` is sharded first if it is not yet (build the state after
    this call, or use :func:`make_train_setup`), and the batch is this
    rank's slice of the data axes (the model axis's ranks read the same
    one).  ``grad_compression`` is ``"none"`` or ``"int8_ef"``: each
    global leaf's one scale comes from an all-reduce MAX over the axes
    that slice it.

    ``grad_accum`` > 1 splits the batch into that many microbatches along
    its first axis and sums their gradients in f32 (in bf16 for bf16
    parameters, as the reference does to save memory), then takes the
    mean; the master path keeps the mean in f32.  Metrics carry the
    reference's names: ``loss``, ``ce``, ``aux``, ``lr``, ``grad_norm``,
    ``step``, and ``loss_scale`` (the scale the step ran at) and
    ``grads_finite`` under loss scaling.
    """
    if grad_compression not in GRAD_COMPRESSION:
        raise ValueError(f"grad_compression must be one of "
                         f"{GRAD_COMPRESSION}, got {grad_compression!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be at least 1, got {grad_accum}")
    ctx = Ctx(mesh=mesh) if mesh is not None else None
    dp = None
    if mesh is not None:
        dp = DataParallel(model, mesh, dp_axes).shard()

    def loss_and_grads(params, batch, scale):
        """(unscaled loss, metrics, gradients of the scaled loss).  A
        parameter the loss does not read (an xattn block's ``xattn.wk``
        and ``xattn.wv``) gets an exact zero gradient, as in the
        reference.  On a mesh: FSDP's hooks reduce the gradients in
        ``backward`` (the model axis's reductions run inside the layers),
        and loss and metrics are the data-parallel ranks' means."""
        loss, metrics = lm_loss(model, batch, ctx=ctx)
        scaled = loss if scale is None else loss * scale
        if dp is not None:
            scaled.backward()
            return dp.all_mean(loss.detach()), {
                k: dp.all_mean(v.detach()) for k, v in metrics.items()}, \
                dp.grads()
        grads = torch.autograd.grad(scaled, list(params.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def grads_of(params, batch, scale):
        if grad_accum == 1:
            return loss_and_grads(params, batch, scale)
        k = grad_accum
        rows = next(iter(batch.values())).shape[0]
        if rows % k:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{k} microbatches")
        micro = [{n: v[i * (rows // k):(i + 1) * (rows // k)]
                  for n, v in batch.items()} for i in range(k)]
        acc = {n: torch.zeros(p.shape, dtype=p.dtype if p.dtype ==
                              torch.bfloat16 else torch.float32,
                              device=p.device)
               for n, p in params.items()}
        loss_sum = aux_sum = 0.0
        for mb in micro:
            loss, metrics, g = loss_and_grads(params, mb, scale)
            for n, a in acc.items():
                a.add_(g[n].to(a.dtype))
            del g
            loss_sum = loss_sum + loss
            aux_sum = aux_sum + metrics["aux"]
        # The master path never rounds the mean back to the bf16 parameter
        # dtype: the master exists to receive those bits.
        grads = {n: (a.float() / k).to(torch.float32 if master_weights
                                       else params[n].dtype)
                 for n, a in acc.items()}
        loss = loss_sum / k
        return loss, {"ce": loss - aux_sum / k, "aux": aux_sum / k}, grads

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        scale = state["loss_scale"]["scale"] if loss_scaling else None
        loss, metrics, grads = grads_of(params, batch, scale)

        finite = True
        if loss_scaling is not None:
            # Overflow check on the raw, still-scaled gradients (on every
            # rank's shards); the unscale runs in f32.
            finite = bool(tree_all_finite(grads.values()))
            if dp is not None:
                finite = dp.all_true(finite)
            inv = 1.0 / scale
            grads = {n: (g.float() * inv).to(
                torch.float32 if master_weights else g.dtype)
                for n, g in grads.items()}
        elif master_weights:
            grads = {n: g.float() for n, g in grads.items()}

        if grad_compression == "int8_ef":
            errors = state["errors"]
            xs = {n: g.float() + errors[n] for n, g in grads.items()}
            amax = _leaf_amax(xs, dp)
            for n, g in grads.items():
                grads[n], errors[n] = _int8_ef(g, errors[n], amax[n])

        norm = dp.norm if dp is not None else None
        if finite:
            stats = adamw_update(opt_cfg, grads, opt,
                                 state["master"] if master_weights
                                 else params, norm=norm)
            if master_weights:
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(state["master"][n])
        else:
            # Skipped: parameters, master, moments and step stay as they
            # were; the statistics are those the update would report.
            stats = {"lr": lr_at(opt_cfg, opt["step"] + 1),
                     "grad_norm": norm(grads) if norm is not None
                     else global_norm(grads.values()),
                     "step": opt["step"] + 1}
        del grads

        out = {"loss": loss, **metrics, **stats}
        if loss_scaling is not None:
            out["loss_scale"] = scale
            out["grads_finite"] = torch.tensor(float(finite))
            state["loss_scale"] = loss_scale_update(
                loss_scaling, state["loss_scale"], finite)
        return state, out

    return train_step


# ---------------------------------------------------------------------------
# The sharded state, built from a seed.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainSetup:
    """Everything a trainer needs on one rank: the (sharded) model, its
    train state, the step, the mesh, each parameter's spec (of the whole
    leaf), this rank's placements of the state (flat state key -> (dim,
    parts, index), or a tuple of two such where the data and the model
    axis both slice the leaf) and the sliced state keys another rank
    writes (``state_skip``), for the checkpoint manager."""
    model: LM
    state: dict
    train_step: Callable
    mesh: Any
    dp_axes: tuple
    param_specs: dict
    state_placements: dict
    state_skip: frozenset = frozenset()


def _state_keys(state: dict, names) -> dict:
    """{flat key: parameter name} of every state leaf that mirrors one of
    the parameters ``names``."""
    out = {}
    for n in names:
        out[f"params/{n}"] = out[f"opt/m/{n}"] = out[f"opt/v/{n}"] = n
        for sub in ("master", "errors"):
            if sub in state:
                out[f"{sub}/{n}"] = n
    return out


def _state_placements(state: dict, placements: dict) -> dict:
    """Every state leaf that mirrors a sharded parameter takes its
    placement."""
    return {k: placements[n]
            for k, n in _state_keys(state, placements).items()}


def make_train_setup(model_cfg: LMConfig, opt_cfg: AdamWConfig, *,
                     mesh=None, dp_axes=None, grad_compression="none",
                     device=None, seed: int = 0, grad_accum: int = 1,
                     master_weights: bool = False,
                     loss_scaling: LossScaleConfig | None = None
                     ) -> TrainSetup:
    """The model drawn from ``seed`` on ``device``, sharded over ``mesh``'s
    data and model axes when a mesh is given (the same full weights on
    every rank, each keeping its shards), its state and its step."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import dp_axes_for

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = LM(model_cfg, device=device, generator=gen)
    specs, placements, skip = {}, {}, set()
    if mesh is not None:
        dp_axes = tuple(dp_axes or dp_axes_for(mesh))
        dp = DataParallel(model, mesh, dp_axes).shard()
        specs, placements, skip = dp.specs, dp.placements(), dp.skipped()
    step = build_train_step(model, opt_cfg, mesh=mesh, dp_axes=dp_axes,
                            grad_compression=grad_compression,
                            grad_accum=grad_accum,
                            master_weights=master_weights,
                            loss_scaling=loss_scaling)
    state = init_train_state(model, opt_cfg, master_weights=master_weights,
                             loss_scaling=loss_scaling,
                             grad_compression=grad_compression)
    return TrainSetup(model=model, state=state, train_step=step, mesh=mesh,
                      dp_axes=tuple(dp_axes or ()), param_specs=specs,
                      state_placements=_state_placements(state, placements),
                      state_skip=frozenset(_state_keys(state, skip)))
