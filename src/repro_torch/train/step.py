"""The LM train step: loss -> gradients -> AdamW, the port of the
reference's ``train/step.py`` on one device.

A train state is a dict: ``params`` (the model's own parameters by name,
``dict(model.named_parameters())``), ``opt`` (:func:`adamw_init`'s
moments and step), and optionally ``master`` and ``loss_scale``.
:func:`init_train_state` builds it; :func:`build_train_step` returns
``train_step(state, batch) -> (state, metrics)``, which updates the state
in place (AdamW writes parameters and moments in place) and returns it.

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

import torch

from repro_torch.models.lm import LM, lm_loss
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm, lr_at)


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
                     loss_scaling: LossScaleConfig | None = None) -> dict:
    """The train state of ``model``: its parameters, AdamW's state for the
    parameters the optimizer walks (the f32 master copy when
    ``master_weights``), and the loss-scale state when ``loss_scaling``."""
    params = dict(model.named_parameters())
    state = {"params": params}
    if master_weights:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in params.items()}
    state["opt"] = adamw_init(opt_cfg, state.get("master", params))
    if loss_scaling is not None:
        state["loss_scale"] = loss_scale_init(loss_scaling)
    return state


def build_train_step(model: LM, opt_cfg: AdamWConfig, *, grad_accum: int = 1,
                     master_weights: bool = False,
                     loss_scaling: LossScaleConfig | None = None,
                     grad_compression: str = "none"):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a state
    from :func:`init_train_state` over ``model``.

    ``grad_accum`` > 1 splits the batch into that many microbatches along
    its first axis and sums their gradients in f32 (in bf16 for bf16
    parameters, as the reference does to save memory), then takes the
    mean; the master path keeps the mean in f32.  Metrics carry the
    reference's names: ``loss``, ``ce``, ``aux``, ``lr``, ``grad_norm``,
    ``step``, and ``loss_scale`` (the scale the step ran at) and
    ``grads_finite`` under loss scaling.
    """
    if grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={grad_compression!r} needs the collectives, "
            f"which come with parallelism (ROADMAP.md §1 item 6)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be at least 1, got {grad_accum}")

    def loss_and_grads(params, batch, scale):
        """(unscaled loss, metrics, gradients of the scaled loss).  A
        parameter the loss does not read (an xattn block's ``xattn.wk``
        and ``xattn.wv``) gets an exact zero gradient, as in the
        reference."""
        loss, metrics = lm_loss(model, batch)
        grads = torch.autograd.grad(loss if scale is None else loss * scale,
                                    list(params.values()), allow_unused=True)
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
            # Overflow check on the raw, still-scaled gradients; the
            # unscale runs in f32.
            finite = bool(tree_all_finite(grads.values()))
            inv = 1.0 / scale
            grads = {n: (g.float() * inv).to(
                torch.float32 if master_weights else g.dtype)
                for n, g in grads.items()}
        elif master_weights:
            grads = {n: g.float() for n, g in grads.items()}

        if finite:
            stats = adamw_update(opt_cfg, grads, opt,
                                 state["master"] if master_weights
                                 else params)
            if master_weights:
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(state["master"][n])
        else:
            # Skipped: parameters, master, moments and step stay as they
            # were; the statistics are those the update would report.
            stats = {"lr": lr_at(opt_cfg, opt["step"] + 1),
                     "grad_norm": global_norm(grads.values()),
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
