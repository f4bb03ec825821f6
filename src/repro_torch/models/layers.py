"""Common layers: the vision backbone's, channels-last (NHWC) like the
reference package, and the language model's (``DTypePolicy``,
``RMSNorm`` with the reference's hand VJP, ``SwiGLU``, ``LayerNorm`` and
``GeluMLP`` (the vision backbone's and whisper's), ``cross_entropy_loss``,
rope and Qwen2-VL's M-RoPE, and the Mamba-2 mixer's ``CausalConv1d``).

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
    dtype, cast back to ``x.dtype``.  Under a model axis (``tp``,
    ``parallel.tensor_parallel``) ``gate`` and ``up`` are column-parallel
    and ``down`` row-parallel: each rank computes its slice of the hidden
    width and the partial products are summed over the axis."""

    tp = None

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
        if self.tp is not None:
            xc = self.tp.copy(xc)
        h = F.silu(xc @ cast(self.gate)) * (xc @ cast(self.up))
        y = h @ cast(self.down)
        if self.tp is not None:
            y = self.tp.reduce(y)
        return y.to(x.dtype)


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
    """fc1 -> GELU (tanh approximation, the reference's default) -> fc2,
    with the biases ``b1`` and ``b2``: x and the parameters cast to the
    policy's compute dtype, the bias adds and the GELU in it, the output
    cast back to x's dtype (the reference's ``apply_gelu_mlp``).  Without a
    ``policy`` the parameters are stored in ``dtype`` and the products run
    in f32, the vision backbone's policy.  Under a model axis (``tp``)
    ``fc1`` and ``b1`` are column-parallel and ``fc2`` row-parallel, and
    ``b2`` is added once, after the partial products are summed."""

    tp = None

    def __init__(self, dim: int, hidden: int,
                 policy: DTypePolicy | None = None, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        self.policy = policy or DTypePolicy(dtype, torch.float32)
        pd = self.policy.param_dtype
        self.fc1 = dense_init(dim, hidden, generator, device, pd)
        self.fc2 = dense_init(hidden, dim, generator, device, pd)
        self.b1 = new_param((hidden,), zeros, None, device, pd)
        self.b2 = new_param((dim,), zeros, None, device, pd)

    def forward(self, x):
        cast = self.policy.cast
        xc = cast(x)
        if self.tp is not None:
            xc = self.tp.copy(xc)
        h = F.gelu(xc @ cast(self.fc1) + cast(self.b1), approximate="tanh")
        y = h @ cast(self.fc2)
        if self.tp is not None:
            y = self.tp.reduce(y)
        return (y + cast(self.b2)).to(x.dtype)


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


def apply_mrope(x, positions_3d, sections=(16, 24, 24),
                theta: float = 10000.0):
    """Qwen2-VL's multimodal rotary embedding of x (B, S, H, D) at
    positions_3d (3, B, S) int, the temporal, height and width ids:
    ``sections`` (summing to D/2) give each plane its run of frequency
    slots, slot i reading the plane that ``repeat(arange(3), sections)``
    names at i.  Angles and the rotation in f32, the result cast back to
    x's dtype, as :func:`apply_rope`; with three equal planes the angles,
    and so the result, are :func:`apply_rope`'s bit for bit."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {d // 2}")
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    plane = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=d // 2)                                   # (D/2,)
    pos = positions_3d.float().permute(1, 2, 0)[..., plane]   # (B,S,D/2)
    ang = pos * freqs
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


class CausalConv1d(nn.Module):
    """The reference's depthwise causal 1-d convolution over (B, S, C),
    in f32, cast back to the input dtype.  ``w`` is (C, 1, k), the
    reference's (k, 1, C) transposed with no flip: tap 0 multiplies the
    oldest input, as in a cross-correlation; ``b`` is (C,).

    The taps are summed one after another, oldest first, so a streamed
    token (``state`` (B, k-1, C), the last k-1 raw inputs) gives the bits
    of the same position in a full pass."""

    def __init__(self, dim: int, k: int = 4, *, generator, device,
                 dtype=torch.float32):
        super().__init__()

        def init(shape, gen):
            return torch.randn(shape, generator=gen,
                               device=gen.device) * (1.0 / math.sqrt(k))

        self.w = new_param((dim, 1, k), init, generator, device, dtype)
        self.b = new_param((dim,), zeros, None, device, dtype)

    def forward(self, x, state=None):
        """(y (B, S, C), the new state (B, k-1, C) when ``state`` is given,
        else None)."""
        return causal_conv1d(x, self.w, self.b, state)


def causal_conv1d(x, w, b, state=None):
    """:class:`CausalConv1d`'s arithmetic with the weight ``w`` (C, 1, k)
    and bias ``b`` (C,) given (a model-axis rank's channels of them)."""
    k = w.shape[-1]
    w = w.float()[:, 0]                                # (C, k)
    xf = x.float()
    if state is not None:
        xa = torch.cat([state.float(), xf], dim=1)
        new_state = xa[:, xa.shape[1] - (k - 1):]
    else:
        xa = F.pad(xf, (0, 0, k - 1, 0))
        new_state = None
    s = x.shape[1]
    y = xa[:, 0:s] * w[:, 0]
    for j in range(1, k):
        y = y + xa[:, j:j + s] * w[:, j]
    return (y + b.float()).to(x.dtype), new_state
