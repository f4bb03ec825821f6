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

Under a model axis each mixer runs its own heads where the axis divides
them, else the whole mixer on every rank
(``parallel.tensor_parallel.HeadParallel``).

Plain PyTorch throughout: the reference evaluates these outside any Pallas
kernel.  The sLSTM's loop launches a dozen or so small kernels a token and
layer on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (DTypePolicy, RMSNorm, dense_init,
                                       new_param, zeros)
from repro_torch.models.ssm import chunked_gla, gla_decode_step
from repro_torch.parallel.tensor_parallel import HeadParallel


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


class MLSTM(HeadParallel):
    """The reference's mLSTM: ``in_proj`` packs q, k, v and the o gate
    (d_inner each) and the forget and input gates (n_heads each); q is
    divided by sqrt(hd), k multiplied by sigmoid(input gate), the log decay
    is log_sigmoid(forget gate); the output is y / max(|n|, 1), then
    rmsnorm · sigmoid(o) through ``out_proj``.  The projections are cast
    to the compute dtype at use; the rest runs in f32.  On a model
    axis's heads path ``in_proj``'s product is gathered whole, each rank
    reads its heads' q, k, v, o and gates, the norm's mean square is
    summed over the axis and ``out_proj``'s partial products too."""

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
        """q, k, v with the ones column, o and the log decay of this
        rank's heads (all heads off the heads path)."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, nh, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
        h0, h1 = self._heads()
        proj = self._column_product("in_proj", x).float()
        q, k, v, o, fg, ig = proj.split([di, di, di, di, nh, nh], dim=-1)
        cols = slice(h0 * hd, h1 * hd)
        q, k, v, o = q[..., cols], k[..., cols], v[..., cols], o[..., cols]
        fg, ig = fg[..., h0:h1], ig[..., h0:h1]
        n = h1 - h0
        q = q.reshape(b, s, n, hd) / math.sqrt(hd)
        k = k.reshape(b, s, n, hd) * torch.sigmoid(ig)[..., None]
        v = v.reshape(b, s, n, hd)
        v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        return q, k, v_aug, o, F.logsigmoid(fg)

    def _output(self, y_aug, o, x):
        cfg = self.cfg
        b, s = x.shape[:2]
        hd = cfg.head_dim

        def cols(a, e):
            return [(a * hd, e * hd)]

        y = y_aug[..., :hd] / torch.clamp(y_aug[..., hd:].abs(), min=1.0)
        y = self._norm(y.reshape(b, s, -1), cols, cfg.d_inner) \
            * torch.sigmoid(o)
        return self._row_product(y, cols).to(x.dtype)

    def forward(self, x):
        q, k, v_aug, o, log_decay = self._project(x)
        y_aug, _ = chunked_gla(q, k, v_aug, log_decay, chunk=self.cfg.chunk)
        return self._output(y_aug, o, x)

    def prefill(self, x):
        q, k, v_aug, o, log_decay = self._project(x)
        y_aug, state = chunked_gla(q, k, v_aug, log_decay,
                                   chunk=self.cfg.chunk)
        return self._output(y_aug, o, x), {"state": self._whole_state(state)}

    def decode(self, x, cache):
        """x (B, 1, D); cache {"state": (B, H, hd, hd + 1)}."""
        q, k, v_aug, o, log_decay = self._project(x)
        h0, h1 = self._heads()
        y, state = gla_decode_step(cache["state"][:, h0:h1], q[:, 0], k[:, 0],
                                   v_aug[:, 0], log_decay[:, 0])
        return self._output(y[:, None], o, x), {
            "state": self._whole_state(state)}


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


class SLSTM(HeadParallel):
    """The reference's sLSTM: ``w_in`` (cast to the compute dtype) gives the
    i, f, z, o pre-activations of every token at once; then token by token
    the block-diagonal recurrence ``r`` (4, H, hd, hd) over the previous h,
    gate g filling ``[g·D:(g+1)·D]`` with the heads inside, plus the bias
    ``b``, both in f32 under every policy; the stabilised exponential
    gates; and ``out_proj`` over the h sequence.  On a model axis's heads
    path ``w_in``'s product is gathered whole, each rank reads its heads'
    four gates and runs their loop with its stored heads of ``r`` (no
    collective a token), and ``out_proj``'s partial products are
    summed."""

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
        """``r`` in f32 as (H, hd, 4 hd) (this rank's heads on the heads
        path): head h's block maps its hd inputs to the four gates' hd
        outputs, so a token's product is one bmm over the heads.  Laid
        out once a pass: the einsum's own layout copy of ``r`` at every
        token would be saved for the backward, 17 MB a token at
        xlstm-1.3b's heads."""
        r = self._leaf("r", lambda a, e: [(a, e)], 1)
        _, nh, hd, _ = r.shape
        return r.float().permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)

    def _bias(self):
        """``b`` over the gates of this rank's heads (all on one rank or
        the whole path), gate-major as ``_wx``'s columns."""
        d, hd = self.cfg.dim, self.cfg.head_dim
        return self._leaf("b", lambda a, e: [(g * d + a * hd, g * d + e * hd)
                                             for g in range(4)])

    def _step(self, r, bias, wx_t, carry):
        """One token: wx_t (B, 4D) f32 (4 · this rank's width on the heads
        path), r from :meth:`_recurrence`, bias from :meth:`_bias`.  The
        recurrent term is the reference's einsum("bhd,ghde->bghe", h, r),
        gate g filling [g·D:(g+1)·D] with the heads inside."""
        h_prev, c_prev, n_prev, m_prev = carry
        b, d = h_prev.shape
        nh, hd = r.shape[0], r.shape[1]
        rec = torch.bmm(h_prev.reshape(b, nh, hd).transpose(0, 1), r)
        rec = rec.reshape(nh, b, 4, hd).permute(1, 2, 0, 3).reshape(b, 4 * d)
        i_raw, f_raw, z_raw, o_raw = (wx_t + rec + bias).reshape(
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
        """The gates' pre-activations (B, S, 4 D) in f32; on the heads path
        this rank's heads' columns of each gate (B, S, 4 D / M)."""
        b, s, _ = x.shape
        h0, h1 = self._heads()
        d, hd = self.cfg.dim, self.cfg.head_dim
        wx = self._column_product("w_in", x).float()
        return wx.reshape(b, s, 4, d)[..., h0 * hd:h1 * hd].reshape(b, s, -1)

    def _out(self, h, x):
        hd = self.cfg.head_dim
        return self._row_product(h, lambda a, e: [(a * hd, e * hd)]) \
            .to(x.dtype)

    def _mine(self, t):
        """This rank's columns of a whole (B, D) cache leaf."""
        h0, h1 = self._heads()
        hd = self.cfg.head_dim
        return t[:, h0 * hd:h1 * hd]

    def _whole(self, carry):
        """(h, c, n, m) over every head (this rank's gathered on the heads
        path) as the cache dict."""
        if self._own() is not None:
            carry = self._whole_state(torch.stack(carry), -1).unbind(0)
        return dict(zip("hcnm", carry))

    def _run(self, x):
        """(the output over the sequence, the final (h, c, n, m) of this
        rank's heads on the heads path)."""
        b, s, _ = x.shape
        wx = self._wx(x)
        r, bias = self._recurrence(), self._bias()
        zeros_ = torch.zeros((b, wx.shape[-1] // 4), dtype=torch.float32,
                             device=x.device)
        carry = (zeros_, zeros_, zeros_, torch.full_like(zeros_, M_INIT))
        hs = []
        for t in range(s):
            carry = self._step(r, bias, wx[:, t], carry)
            hs.append(carry[0])
        return self._out(torch.stack(hs, 1), x), carry

    def prefill(self, x):
        """The forward over the prompt and the final (h, c, n, m)."""
        y, carry = self._run(x)
        return y, self._whole(carry)

    def forward(self, x):
        return self._run(x)[0]

    def decode(self, x, cache):
        """x (B, 1, D); cache {"h", "c", "n", "m"}, each (B, D)."""
        carry = tuple(self._mine(cache[k]).float() for k in "hcnm")
        new = self._step(self._recurrence(), self._bias(), self._wx(x)[:, 0],
                         carry)
        return self._out(new[0], x)[:, None], self._whole(new)


def init_slstm_cache(batch: int, cfg: SLSTMConfig, *, device):
    zeros_ = torch.zeros((batch, cfg.dim), device=device)
    return {"h": zeros_, "c": zeros_.clone(), "n": zeros_.clone(),
            "m": torch.full_like(zeros_, M_INIT)}
