"""xLSTM token mixers, the port of ``repro.models.xlstm``: the mLSTM
(matrix memory, chunk-parallel) and the sLSTM (scalar memory, a strictly
sequential loop over tokens).

The mLSTM runs through :func:`repro_torch.models.ssm.chunked_gla`: a
matrix memory with a per-step scalar forget decay is a gated linear
recurrence, and the normaliser n_t rides along as a ones column appended
to the values, so the state is (B, H, hd, hd + 1).  As in the reference
(DESIGN.md §7), its input gate is a sigmoid, not the paper's stabilised
exponential, which is not chunk-local; the sLSTM keeps the exact
exponential gating with the stabiliser m_t, token by token.

Plain PyTorch throughout: the reference evaluates these outside any Pallas
kernel.  The sLSTM's loop launches a dozen or so small kernels a token and
layer on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (DTypePolicy, RMSNorm, dense_init,
                                       new_param, zeros)
from repro_torch.models.ssm import chunked_gla, gla_decode_step


# ---------------------------------------------------------------------------
# mLSTM.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    dim: int
    n_heads: int = 4
    expand: int = 2
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.dim

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


class MLSTM(nn.Module):
    """The reference's mLSTM: ``in_proj`` packs q, k, v and the o gate
    (d_inner each) and the forget and input gates (n_heads each); q is
    divided by sqrt(hd), k multiplied by sigmoid(input gate), the log decay
    is log_sigmoid(forget gate); the output is y / max(|n|, 1), then
    rmsnorm · sigmoid(o) through ``out_proj``.  The projections are cast
    to the compute dtype at use; the rest runs in f32."""

    def __init__(self, cfg: MLSTMConfig, policy: DTypePolicy, *,
                 generator, device):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        di, nh, pd = cfg.d_inner, cfg.n_heads, policy.param_dtype
        self.in_proj = dense_init(cfg.dim, 4 * di + 2 * nh, generator,
                                  device, pd)
        self.norm = RMSNorm(di, device=device, dtype=pd)
        self.out_proj = dense_init(di, cfg.dim, generator, device, pd)

    def _project(self, x):
        cfg, cast = self.cfg, self.policy.cast
        b, s, _ = x.shape
        di, nh, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
        proj = (cast(x) @ cast(self.in_proj)).float()
        q, k, v, o, fg, ig = proj.split([di, di, di, di, nh, nh], dim=-1)
        q = q.reshape(b, s, nh, hd) / math.sqrt(hd)
        k = k.reshape(b, s, nh, hd) * torch.sigmoid(ig)[..., None]
        v = v.reshape(b, s, nh, hd)
        v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        return q, k, v_aug, o, F.logsigmoid(fg)

    def _output(self, y_aug, o, x):
        cfg, cast = self.cfg, self.policy.cast
        b, s = x.shape[:2]
        hd = cfg.head_dim
        y = y_aug[..., :hd] / torch.clamp(y_aug[..., hd:].abs(), min=1.0)
        y = self.norm(y.reshape(b, s, cfg.d_inner)) * torch.sigmoid(o)
        return (cast(y) @ cast(self.out_proj)).to(x.dtype)

    def forward(self, x):
        return self.prefill(x)[0]

    def prefill(self, x):
        q, k, v_aug, o, log_decay = self._project(x)
        y_aug, state = chunked_gla(q, k, v_aug, log_decay,
                                   chunk=self.cfg.chunk)
        return self._output(y_aug, o, x), {"state": state}

    def decode(self, x, cache):
        """x (B, 1, D); cache {"state": (B, H, hd, hd + 1)}."""
        q, k, v_aug, o, log_decay = self._project(x)
        y, state = gla_decode_step(cache["state"], q[:, 0], k[:, 0],
                                   v_aug[:, 0], log_decay[:, 0])
        return self._output(y[:, None], o, x), {"state": state}


def init_mlstm_cache(batch: int, cfg: MLSTMConfig, *, device):
    return {"state": torch.zeros(
        (batch, cfg.n_heads, cfg.head_dim, cfg.head_dim + 1), device=device)}


# ---------------------------------------------------------------------------
# sLSTM (exact exponential gating with the stabiliser).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    dim: int
    n_heads: int = 4

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# The stabiliser's start: finite, as the reference's; with -inf the
# backward through exp(log_f + m_prev - m_t) is a NaN.
M_INIT = -1e30


class SLSTM(nn.Module):
    """The reference's sLSTM: ``w_in`` (cast to the compute dtype) gives the
    i, f, z, o pre-activations of every token at once; then token by token
    the block-diagonal recurrence ``r`` (4, H, hd, hd) over the previous h,
    gate g filling ``[g·D:(g+1)·D]`` with the heads inside, plus the bias
    ``b``, both in f32 under every policy; the stabilised exponential
    gates; and ``out_proj`` over the h sequence."""

    def __init__(self, cfg: SLSTMConfig, policy: DTypePolicy, *,
                 generator, device):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        d, nh, hd, pd = cfg.dim, cfg.n_heads, cfg.head_dim, policy.param_dtype
        self.w_in = dense_init(d, 4 * d, generator, device, pd)

        def r_init(shape, gen):
            return torch.randn(shape, generator=gen,
                               device=gen.device) * (1.0 / math.sqrt(hd))

        self.r = new_param((4, nh, hd, hd), r_init, generator, device, pd)
        self.b = new_param((4 * d,), zeros, None, device, torch.float32)
        self.out_proj = dense_init(d, d, generator, device, pd)

    def _recurrence(self):
        """``r`` in f32 as (H, hd, 4 hd): head h's block maps its hd inputs
        to the four gates' hd outputs, so a token's product is one bmm
        over the heads.  Laid out once a pass: the einsum's own layout
        copy of ``r`` at every token would be saved for the backward, 17
        MB a token at xlstm-1.3b's heads."""
        nh, hd = self.cfg.n_heads, self.cfg.head_dim
        return self.r.float().permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)

    def _step(self, r, wx_t, carry):
        """One token: wx_t (B, 4D) f32, r from :meth:`_recurrence`.  The
        recurrent term is the reference's einsum("bhd,ghde->bghe", h, r),
        gate g filling [g·D:(g+1)·D] with the heads inside."""
        h_prev, c_prev, n_prev, m_prev = carry
        b, d = h_prev.shape
        nh, hd = self.cfg.n_heads, self.cfg.head_dim
        rec = torch.bmm(h_prev.reshape(b, nh, hd).transpose(0, 1), r)
        rec = rec.reshape(nh, b, 4, hd).permute(1, 2, 0, 3).reshape(b, 4 * d)
        i_raw, f_raw, z_raw, o_raw = (wx_t + rec + self.b).reshape(
            b, 4, d).unbind(1)
        log_f = F.logsigmoid(f_raw)
        m_t = torch.maximum(log_f + m_prev, i_raw)
        i_p = torch.exp(i_raw - m_t)
        f_p = torch.exp(log_f + m_prev - m_t)
        c_t = f_p * c_prev + i_p * torch.tanh(z_raw)
        n_t = f_p * n_prev + i_p
        h_t = torch.sigmoid(o_raw) * c_t / torch.clamp(n_t, min=1.0)
        return h_t, c_t, n_t, m_t

    def _wx(self, x):
        cast = self.policy.cast
        return (cast(x) @ cast(self.w_in)).float()

    def _out(self, h, x):
        cast = self.policy.cast
        return (cast(h) @ cast(self.out_proj)).to(x.dtype)

    def prefill(self, x):
        """The forward over the prompt and the final (h, c, n, m)."""
        b, s, d = x.shape
        wx = self._wx(x)
        r = self._recurrence()
        zeros_ = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        carry = (zeros_, zeros_, zeros_, torch.full_like(zeros_, M_INIT))
        hs = []
        for t in range(s):
            carry = self._step(r, wx[:, t], carry)
            hs.append(carry[0])
        y = self._out(torch.stack(hs, 1), x)
        return y, dict(zip("hcnm", carry))

    def forward(self, x):
        return self.prefill(x)[0]

    def decode(self, x, cache):
        """x (B, 1, D); cache {"h", "c", "n", "m"}, each (B, D)."""
        carry = tuple(cache[k].float() for k in "hcnm")
        new = self._step(self._recurrence(), self._wx(x)[:, 0], carry)
        return self._out(new[0], x)[:, None], dict(zip("hcnm", new))


def init_slstm_cache(batch: int, cfg: SLSTMConfig, *, device):
    zeros_ = torch.zeros((batch, cfg.dim), device=device)
    return {"h": zeros_, "c": zeros_.clone(), "n": zeros_.clone(),
            "m": torch.full_like(zeros_, M_INIT)}
