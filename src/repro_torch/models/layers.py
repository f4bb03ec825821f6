"""Common layers: the vision backbone's, channels-last (NHWC) like the
reference package, and the language model's (``DTypePolicy``,
``RMSNorm`` with the reference's hand VJP, ``SwiGLU``,
``cross_entropy_loss``).

Parameters keep the reference's names and, for dense weights, its
``(d_in, d_out)`` layout, so converted parameters map 1:1; convolution
weights are OIHW.  Initial values are drawn from an explicit
``torch.Generator`` on the generator's device and then moved, so a CPU
generator's seed gives the same weights on every device (a CUDA
generator draws a large model on the card); on the ``meta`` device
nothing is drawn.  Layernorm, convolutions and the biases run in f32 and
cast back to the input dtype.  The LM layers follow the reference's
mixed-precision policy (DESIGN.md §10): parameters are stored in
``param_dtype`` and cast to ``compute_dtype`` at use.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


def new_param(shape, init, generator, device, dtype) -> nn.Parameter:
    """A parameter of ``shape`` filled by ``init(shape, generator)`` (a CPU
    f32 tensor), or left empty on the meta device."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, device="meta", dtype=dtype))
    return nn.Parameter(init(shape, generator).to(device=device, dtype=dtype))


def trunc_normal(scale: float):
    """Standard normal truncated to [-2, 2], times ``scale``."""
    def init(shape, generator):
        t = torch.empty(shape, device=generator.device)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t * scale
    return init


def zeros(shape, generator):
    return torch.zeros(shape)


def ones(shape, generator):
    return torch.ones(shape)


def dense_init(d_in: int, d_out: int, generator, device, dtype,
               scale: float | None = None) -> nn.Parameter:
    """Dense weight (d_in, d_out), truncated normal times 1/sqrt(d_in)."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return new_param((d_in, d_out), trunc_normal(s), generator, device, dtype)


def embed_init(vocab: int, dim: int, generator, device,
               dtype) -> nn.Parameter:
    """Embedding table (vocab, dim), truncated normal times 0.02."""
    return new_param((vocab, dim), trunc_normal(0.02), generator, device,
                     dtype)


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Parameters stored in ``param_dtype``, matrix products and streamed
    operands in ``compute_dtype``; scan carries and accumulators in
    ``carry_dtype`` (f32 under every preset, DESIGN.md §10)."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    carry_dtype: torch.dtype = torch.float32

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.compute_dtype)


def _rmsnorm(x, scale, eps):
    """(y, the f32 inverse root of each row's mean square)."""
    ms = x.float().square().sum(-1) / x.shape[-1]
    inv = torch.rsqrt(ms + eps)
    return x * inv[..., None].to(x.dtype) * scale.to(x.dtype), inv


class _RMSNormFn(torch.autograd.Function):
    """The reference's ``_rmsnorm_core`` with its hand VJP
    (``_rmsnorm_fwd``/``_rmsnorm_bwd``): the mean square and the row
    reductions of the backward in f32, every other product in ``x.dtype``.
    Under bf16 that order of roundings is the result, which plain
    autograd through the forward would not reproduce."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, inv = _rmsnorm(x, scale, eps)
        ctx.save_for_backward(x, scale, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        d = x.shape[-1]
        inv_c = inv[..., None].to(x.dtype)
        gs = g * scale.to(x.dtype)
        dot = (gs.float() * x.float()).sum(-1)
        coef = (dot * inv ** 3 / d)[..., None].to(x.dtype)
        dx = gs * inv_c - x * coef
        dscale = (g * x * inv_c).float().reshape(-1, d).sum(0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


class RMSNorm(nn.Module):
    """The reference's rmsnorm: the mean square in f32, its inverse root
    cast to ``x.dtype``, then ``x * inv * scale`` in ``x.dtype``; the
    gradient is the reference's hand VJP (:class:`_RMSNormFn`).  Without
    grad mode (serving) the forward runs bare: ``Function.apply`` costs
    ~28 µs of host time a call on the H100's host, 57 calls a decode step
    (``tools/ab_serve.py``)."""

    def __init__(self, dim: int, *, device, dtype=torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = new_param((dim,), ones, None, device, dtype)

    def forward(self, x):
        if torch.is_grad_enabled():
            return _RMSNormFn.apply(x, self.scale, self.eps)
        return _rmsnorm(x, self.scale, self.eps)[0]


class SwiGLU(nn.Module):
    """``(silu(x @ gate) * (x @ up)) @ down`` in the policy's compute
    dtype, cast back to ``x.dtype``."""

    def __init__(self, dim: int, hidden: int, policy: DTypePolicy, *,
                 generator, device):
        super().__init__()
        self.policy = policy
        dt = policy.param_dtype
        self.gate = dense_init(dim, hidden, generator, device, dt)
        self.up = dense_init(dim, hidden, generator, device, dt)
        self.down = dense_init(hidden, dim, generator, device, dt)

    def forward(self, x):
        cast = self.policy.cast
        xc = cast(x)
        h = F.silu(xc @ cast(self.gate)) * (xc @ cast(self.up))
        return (h @ cast(self.down)).to(x.dtype)


class LayerNorm(nn.Module):
    """Layernorm over the last axis in f32 (biased variance, eps 1e-5)."""

    def __init__(self, dim: int, *, device, dtype=torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = new_param((dim,), ones, None, device, dtype)
        self.bias = new_param((dim,), zeros, None, device, dtype)

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class GeluMLP(nn.Module):
    """fc1 -> GELU (tanh approximation, the reference's default) -> fc2."""

    def __init__(self, dim: int, hidden: int, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = dense_init(dim, hidden, generator, device, dtype)
        self.fc2 = dense_init(hidden, dim, generator, device, dtype)
        self.b1 = new_param((hidden,), zeros, None, device, dtype)
        self.b2 = new_param((dim,), zeros, None, device, dtype)

    def forward(self, x):
        h = F.gelu(x @ self.fc1 + self.b1, approximate="tanh")
        return (h @ self.fc2 + self.b2).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, *, device=None):
    """The rotary frequencies ``1 / theta ** (arange(0, d, 2) / d)`` in
    f32."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    return 1.0 / (theta ** e)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding of x (B, S, H, D) at positions (B, S) int:
    the two halves of the last axis rotate as one pair per frequency
    (split halves, not interleaved pairs), angles and rotation in f32,
    the result cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    ang = positions[..., None].float() * freqs                # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits, labels, mask=None):
    """Token-level cross entropy in f32: the reference's
    ``cross_entropy_loss`` (the log-sum-exp from the row maximum, taken in
    the logits' dtype), the mean over tokens, or over the tokens where
    ``mask`` is non-zero.

    The reference picks each label's logit with a one-hot einsum, which
    sums exactly one non-zero product, so ``gather`` gives the same f32
    value without building the (B, S, V) one-hot: at 8192 tokens of a
    151 936-word vocabulary that one-hot alone would take 5 GB.
    """
    lf = logits.float()
    m = logits.amax(-1, keepdim=True).float()
    lse = m[..., 0] + torch.log(torch.exp(lf - m).sum(-1))
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of one spatial axis under JAX's ``"SAME"``: the
    output has ceil(n / s) positions and an odd total puts the extra
    element at the high end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x, w, b, stride: int, groups: int = 1):
    """NHWC convolution with an OIHW weight and ``"SAME"`` padding, in f32,
    cast back to x.dtype."""
    k_h, k_w = w.shape[-2:]
    (lo_h, hi_h) = same_padding(x.shape[1], k_h, stride)
    (lo_w, hi_w) = same_padding(x.shape[2], k_w, stride)
    xc = x.float().permute(0, 3, 1, 2)           # NCHW view, channels last
    if lo_h == hi_h and lo_w == hi_w:
        pad = (lo_h, lo_w)
    else:
        xc, pad = F.pad(xc, (lo_w, hi_w, lo_h, hi_h)), 0
    y = F.conv2d(xc, w.float(), b.float(), stride=stride, padding=pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class DWConv2d(nn.Module):
    """Depthwise k x k "SAME" convolution (the LPU of the GSPN blocks)."""

    def __init__(self, dim: int, k: int = 3, *, generator, device,
                 dtype=torch.float32):
        super().__init__()

        def init(shape, gen):
            return torch.randn(shape, generator=gen,
                               device=gen.device) * (1.0 / k)

        self.w = new_param((dim, 1, k, k), init, generator, device, dtype)
        self.b = new_param((dim,), zeros, None, device, dtype)

    def forward(self, x):
        return conv2d_same(x, self.w, self.b, 1, groups=x.shape[-1])
