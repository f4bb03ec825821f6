"""GSPN-2 vision backbone (the paper's own architecture, §5.2).

Hierarchical 4-stage design: conv stem → [GSPN-2 block × depth_i] with 2×
downsampling between stages → pooled classifier head.  Each block is LPU
(depthwise 3×3) → GSPN-2 attention (channel-shared taps + compressive
proxy, paper §4.2) → LPU → FFN, pre-norm with residuals.  The attention's
four directional scans run as two fused pair launches per block
(DESIGN.md §2); ``GSPNVisionConfig.impl`` selects the kernel path
(``auto``/``cuda``/``torch``, see :mod:`repro_torch.kernels.ops`).

Images are NHWC, as in the reference package.  :func:`apply_vision` is the
serving entry point (no autograd); :func:`vision_loss` is the training
loss, differentiable through the scan's hand-derived adjoint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import gspn as gspn_core
from repro_torch.device import resolve_device
from repro_torch.models.layers import (DWConv2d, GeluMLP, LayerNorm,
                                       conv2d_same, dense_init, new_param,
                                       trunc_normal, zeros)


@dataclasses.dataclass(frozen=True)
class GSPNVisionConfig:
    name: str = "gspn2-t"
    img_size: int = 224
    in_chans: int = 3
    n_classes: int = 1000
    dims: Sequence[int] = (64, 128, 320, 512)
    depths: Sequence[int] = (3, 4, 12, 5)
    proxy_dim: int = 2                 # paper ImageNet setting
    mlp_ratio: float = 4.0
    channel_shared: bool = True        # GSPN-2 compact channel propagation
    chunk: int | None = None           # GSPN-local
    impl: str = "auto"
    param_dtype: torch.dtype = torch.float32


def _gspn_attn_cfg(cfg: GSPNVisionConfig, dim: int):
    return gspn_core.GSPNAttentionConfig(
        dim=dim, proxy_dim=cfg.proxy_dim, channel_shared=cfg.channel_shared,
        chunk=cfg.chunk, impl=cfg.impl, param_dtype=cfg.param_dtype)


class Conv(nn.Module):
    """k×k "SAME" convolution with stride (stem and downsampling), NHWC in
    and out, OIHW weight ``w`` and bias ``b``."""

    def __init__(self, k: int, cin: int, cout: int, stride: int, *,
                 generator, device, dtype):
        super().__init__()
        self.stride = stride
        self.w = new_param((cout, cin, k, k),
                           trunc_normal(1.0 / math.sqrt(k * k * cin)),
                           generator, device, dtype)
        self.b = new_param((cout,), zeros, None, device, dtype)

    def forward(self, x):
        return conv2d_same(x, self.w, self.b, self.stride)


class Block(nn.Module):
    def __init__(self, cfg: GSPNVisionConfig, dim: int, *, generator,
                 device):
        super().__init__()
        dt = cfg.param_dtype
        kw = dict(generator=generator, device=device, dtype=dt)
        self.lpu = DWConv2d(dim, 3, **kw)
        self.ln1 = LayerNorm(dim, device=device, dtype=dt)
        self.gspn = gspn_core.GSPNAttention(_gspn_attn_cfg(cfg, dim),
                                            device=device,
                                            generator=generator)
        self.lpu2 = DWConv2d(dim, 3, **kw)
        self.ln2 = LayerNorm(dim, device=device, dtype=dt)
        self.mlp = GeluMLP(dim, int(dim * cfg.mlp_ratio), **kw)

    def forward(self, x):
        x = x + self.lpu(x)                                   # LPU
        x = x + self.gspn(self.ln1(x))
        x = x + self.lpu2(x)                                  # LPU before FFN
        return x + self.mlp(self.ln2(x))


class Stage(nn.Module):
    def __init__(self, cfg: GSPNVisionConfig, si: int, *, generator, device):
        super().__init__()
        dim = cfg.dims[si]
        self.blocks = nn.ModuleList(
            Block(cfg, dim, generator=generator, device=device)
            for _ in range(cfg.depths[si]))
        self.down = None
        if si + 1 < len(cfg.dims):
            self.down = Conv(2, dim, cfg.dims[si + 1], 2, generator=generator,
                             device=device, dtype=cfg.param_dtype)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x if self.down is None else self.down(x)


class GSPNVision(nn.Module):
    """The backbone: x (B, H, W, in_chans) -> logits (B, n_classes).

    ``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the plain path on the CPU or ``"meta"`` for
    shapes only.  Weights are drawn from ``generator`` (seed 0 when not
    given); parity with the reference goes through
    :func:`repro_torch.models.convert.vision_state_from_jax`, never seeds.
    """

    def __init__(self, cfg: GSPNVisionConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        dt = cfg.param_dtype
        self.stem = Conv(4, cfg.in_chans, cfg.dims[0], 4, generator=generator,
                         device=device, dtype=dt)
        self.stages = nn.ModuleList(
            Stage(cfg, si, generator=generator, device=device)
            for si in range(len(cfg.dims)))
        self.ln_f = LayerNorm(cfg.dims[-1], device=device, dtype=dt)
        self.head = dense_init(cfg.dims[-1], cfg.n_classes, generator, device,
                               dt)

    def forward(self, x):
        x = self.stem(x)
        for stage in self.stages:
            x = stage(x)
        x = self.ln_f(x).mean(dim=(1, 2))
        # The head runs in f32 after the spatial mean.
        return x.float() @ self.head.float()


def apply_vision(model: GSPNVision, x) -> torch.Tensor:
    """Serving: x (B, H, W, 3) -> logits (B, n_classes), under
    ``torch.inference_mode()``, so no autograd graph is built."""
    with torch.inference_mode():
        return model(x)


def vision_loss(model: GSPNVision, batch: dict):
    """Mean cross-entropy of ``batch`` ({"images", "labels"} tensors) under
    the caller's grad mode, so ``backward()`` reaches every parameter.
    Returns (nll, {"ce": nll})."""
    logits = model(batch["images"])
    nll = F.cross_entropy(logits, batch["labels"].long())
    return nll, {"ce": nll}


def vision_macs(cfg: GSPNVisionConfig) -> int:
    """Approximate multiply-accumulates for one image (Table 2 analogue)."""
    h = w = cfg.img_size // 4
    macs = (cfg.img_size // 4) ** 2 * 16 * cfg.in_chans * cfg.dims[0]
    for si, (dim, depth) in enumerate(zip(cfg.dims, cfg.depths)):
        n = h * w
        acfg = _gspn_attn_cfg(cfg, dim)
        nd = len(acfg.directions)
        cp = acfg.proxy_dim
        per_block = (
            n * dim * 9 * 2                                   # two LPUs
            + n * gspn_core.gspn_attention_param_count(acfg)  # projections
            + nd * n * cp * 4                                 # scan FMAs
            + 2 * n * dim * int(dim * cfg.mlp_ratio))         # MLP
        macs += depth * per_block
        if si + 1 < len(cfg.dims):
            macs += (h // 2) * (w // 2) * 4 * dim * cfg.dims[si + 1]
            h, w = h // 2, w // 2
    macs += cfg.dims[-1] * cfg.n_classes
    return macs
