"""AdamW with schedules, global-norm clipping and a configurable
optimizer-state dtype: the port of the reference's ``optim/adamw.py``.

Parameters, gradients and moments are dictionaries keyed by the port's
parameter names (``dict(model.named_parameters())``).  Where the
reference is pure and returns new pytrees, :func:`adamw_update` writes the
new parameters and moments in place under ``torch.no_grad()``, so a step
holds one copy of them; it returns only the step's statistics.

The reference decays a leaf when its pytree path passes ``_decay_mask``
and the leaf has two or more dimensions.  Its block parameters are
stacked along depth, one leaf per stage: a vision block's depthwise bias
``stages/S/blocks/lpu/b`` is (depth, C) there and decayed, while the
port's ``stages.S.blocks.K.lpu.b`` is (C,); an LM block's
``stages/s0_gspn/ln1/scale`` is (n, D) in a prelude stage and
(n_units, n, D) in a unit stage, where the port has
``stages.s0_gspn.I.ln1.scale`` or ``stages.s0_gspn.U.I.ln1.scale``, (D,).
:func:`decays` therefore asks the reference's question of the reference's
leaf, not of the port's tensor (:func:`reference_leaf`).
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"         # cosine|linear|constant
    min_lr_ratio: float = 0.1
    state_dtype: torch.dtype = torch.float32   # bf16 halves the moments


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at integer ``step``, computed in f32 as the
    reference computes it; a 0-dim f32 CPU tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * t
    else:
        decay = torch.tensor(1.0)
    return cfg.lr * warm * decay


def global_norm(tensors) -> torch.Tensor:
    """The f32 2-norm over all of ``tensors``: the square root of the sum
    of each tensor's sum of squares."""
    return torch.sqrt(torch.stack(
        [a.float().square().sum() for a in tensors]).sum())


def clip_by_global_norm(tensors, max_norm):
    """(tensors scaled so their global norm is at most ``max_norm``, the
    norm before scaling)."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [(a.float() * scale).to(a.dtype) for a in tensors], norm


def adamw_init(cfg: AdamWConfig, params) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, and step
    0."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=cfg.state_dtype,
                               device=p.device) for n, p in params.items()}
    return {"m": zeros(), "v": zeros(), "step": 0}


# Substrings of a reference path that exempt its leaf from weight decay
# (norms, biases and the LM mixers' 1-d parameters).
_NO_DECAY = ("scale", "bias", "b1", "b2", "dt_bias", "a_log", "d_skip")


# An LM stage key, ``s{i}_{kind}``: the block indices after it are
# stacking axes of the reference's leaf.
_STAGE_KEY = re.compile(r"s\d+_\w+")


def reference_leaf(name: str) -> tuple[str, int]:
    """(the reference's pytree path of the leaf a port parameter comes
    from, the number of stacking axes that leaf has in front of the port's
    tensor).  The block indices that follow ``blocks`` (vision) or a stage
    key (LM: one for a prelude stage, two for a unit stage) are stacking
    axes there: ``stages.2.blocks.1.lpu.b`` -> (``stages/2/blocks/lpu/b``,
    1), ``stages.s0_gspn.0.3.ln1.scale`` -> (``stages/s0_gspn/ln1/scale``,
    2)."""
    kept, axes, stacks = [], 0, False
    for part in name.split("."):
        if stacks and part.isdigit():
            axes += 1
            continue
        kept.append(part)
        stacks = part == "blocks" or bool(_STAGE_KEY.fullmatch(part))
    return "/".join(kept), axes


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays this parameter: its path passes the
    mask and its reference leaf (stacked along depth for a block
    parameter) has at least two dimensions."""
    path, axes = reference_leaf(name)
    return not any(t in path for t in _NO_DECAY) and p.dim() + axes >= 2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params) -> dict:
    """One AdamW step: clip ``grads`` by their global norm, then update
    ``params`` and the moments of ``state`` in place.  Returns
    {"lr", "grad_norm", "step"}."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    names = list(params)
    clipped, gnorm = clip_by_global_norm((grads[n] for n in names),
                                         cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    step_f = torch.tensor(step, dtype=torch.float32)
    bc1 = 1 - b1 ** step_f
    bc2 = 1 - b2 ** step_f
    for n, g in zip(names, clipped):
        p, m, v = params[n], state["m"][n], state["v"][n]
        decay = cfg.weight_decay if (cfg.weight_decay and decays(n, p)) \
            else 0.0
        # f32 leaves keep exact f32 math; fully-bf16 leaves update in bf16.
        cd = torch.float32 if torch.float32 in (p.dtype, m.dtype) \
            else p.dtype
        gf = g.to(cd)
        mf = m.to(cd) * b1 + gf * (1 - b1)
        vf = v.to(cd) * b2 + gf.square() * (1 - b2)
        upd_dir = (mf / bc1.to(cd)) / (torch.sqrt(vf / bc2.to(cd)) + cfg.eps)
        pf = p.to(cd)
        if decay:
            upd_dir = upd_dir + decay * pf
        p.copy_(pf - lr.to(cd) * upd_dir)
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return {"lr": lr, "grad_norm": gnorm, "step": step}
