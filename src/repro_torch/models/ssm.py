"""State-space / gated-linear-attention token mixers, the port of
``repro.models.ssm``.

:func:`chunked_gla` is the shared core, a chunk-parallel evaluation of the
gated linear recurrence

    S_t = a_t * S_{t-1} + k_t v_t^T          (per head; a_t scalar decay)
    y_t = q_t^T S_t

used by Mamba-2 (SSD: a_t = exp(A·dt_t)) and by the mLSTM
(:mod:`repro_torch.models.xlstm`, a_t the sigmoid forget gate).  Within a
chunk of L tokens the contributions come from a masked (L×L) decay matrix;
the state crosses chunks in a loop over the S/L chunks.
:func:`gla_decode_step` advances the state by one token.

The math and the chunk length are the reference's; one rounding differs
on purpose: the reference forms each segment's log decay as a difference
of the chunk's running sums, cum_i - cum_j, which in f32 loses |cum|·eps,
so under Mamba-2's decays its result depends on the chunk length (at
chunks of 256, 3.0e-5 of the largest magnitude from the f64 recurrence
against 1.1e-7 here: tests/test_torch_ssm.py
``test_chunked_gla_sums_segments_without_cancellation``).  The port sums
each segment directly.

All of it is plain PyTorch: the reference computes these with einsums and
a ``lax.scan`` outside any Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (CausalConv1d, DTypePolicy, RMSNorm,
                                       causal_conv1d, dense_init, new_param,
                                       ones, zeros)
from repro_torch.parallel.tensor_parallel import HeadParallel


def gla_chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk length for a sequence of ``s`` tokens:
    ``min(chunk, s)``, halved until it divides ``s`` (1023 tokens run as
    1023 chunks of one)."""
    l = min(chunk, s)
    while s % l:
        l //= 2
    return l


def chunked_gla(q, k, v, log_decay, chunk: int = 256):
    """Gated linear attention, chunk-parallel, in f32.

    q, k: (B, S, H, Dk); v: (B, S, H, Dv); log_decay: (B, S, H) (<= 0).
    Returns y (B, S, H, Dv) f32 and the final state (B, H, Dk, Dv) f32.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    l = gla_chunk_len(s, chunk)
    nc = s // l

    qf = q.float().reshape(b, nc, l, h, dk)
    kf = k.float().reshape(b, nc, l, h, dk)
    vf = v.float().reshape(b, nc, l, h, dv)
    ld = log_decay.float().reshape(b, nc, l, h)
    cum = ld.cumsum(2)                                       # inclusive

    # Intra-chunk: att[i, j] = (q_i . k_j) exp(dec[i, j]), j <= i, with
    # dec[i, j] = cum_i - cum_j = the sum of ld over j < t <= i.  The sums
    # are taken directly (a masked cumsum), not as that difference: in f32
    # the difference loses |cum| * eps, and under Mamba-2's decays |cum|
    # reaches thousands within a chunk of 256.  Above the diagonal the
    # exponent is masked before the exponential (an inf there would make
    # the backward's inf * 0 a NaN), and the product after it.
    att = torch.einsum("bnihd,bnjhd->bnhij", qf, kf)
    strict = torch.ones((l, l), dtype=torch.bool, device=q.device).tril(-1)
    dec = torch.where(strict[:, :, None], ld[:, :, :, None, :],
                      0.0).cumsum(2).movedim(-1, 2)         # (b,nc,h,i,j)
    mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    att = torch.where(mask, att * torch.exp(torch.where(mask, dec, 0.0)),
                      0.0)
    y_intra = torch.einsum("bnhij,bnjhd->bnihd", att, vf)

    # Inter-chunk: each chunk's contribution to the state after it (k_j
    # decayed by cum_L - cum_j, the sum of ld over t > j, again summed
    # directly), and the read-out of the state before each chunk, taken
    # inside the loop: stacking those states would hold nc of them at
    # once, 17 GB for a prompt of 1023 tokens (1023 chunks of one) at
    # xlstm-1.3b's 4 x 1024 x 1025 heads.
    after = F.pad(ld.flip(2).cumsum(2).flip(2)[:, :, 1:], (0, 0, 0, 1))
    k_sc = kf * torch.exp(after)[..., None]
    chunk_kv = torch.einsum("bnjhd,bnjhe->bnhde", k_sc, vf)  # (b,nc,h,dk,dv)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b,nc,h)
    q_sc = qf * torch.exp(cum)[..., None]
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                        device=q.device)
    q_sc = q_sc.transpose(2, 3)                              # (b,nc,h,l,dk)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.matmul(q_sc[:, c], state))     # (b,h,l,dv)
        state = state * chunk_decay[:, c, :, None, None] + chunk_kv[:, c]
    y_inter = torch.stack(y_inter, 1).transpose(2, 3)        # (b,nc,l,h,dv)
    return (y_intra + y_inter).reshape(b, s, h, dv), state


def gla_decode_step(state, q, k, v, log_decay):
    """One-token GLA update in f32.  state (B, H, Dk, Dv); q, k (B, H, Dk);
    v (B, H, Dv); log_decay (B, H).  Returns (y (B, H, Dv), new_state)."""
    a = torch.exp(log_decay.float())[..., None, None]
    new_state = state.float() * a + torch.einsum(
        "bhd,bhe->bhde", k.float(), v.float())
    y = torch.einsum("bhd,bhde->bhe", q.float(), new_state)
    return y, new_state


# ---------------------------------------------------------------------------
# The Mamba-2 (SSD) mixer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    dim: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_k: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.dim

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def _linspace_log(n):
    def init(shape, generator):
        return torch.log(torch.linspace(1.0, 16.0, n))
    return init


class Mamba2(HeadParallel):
    """The Mamba-2 mixer of the reference (``init_mamba2``,
    ``_mamba2_inner``): ``in_proj`` splits into z (d_inner), xbc (d_inner +
    2 d_state) and dt (n_heads); xbc goes through the causal conv and SiLU
    and then splits into x, B and C; dt is folded into v = x · dt, and k
    and q are B and C broadcast over the heads; the skip adds d_skip · x;
    the output is rmsnorm(y) · silu(z) through ``out_proj``.

    ``in_proj`` and ``out_proj`` are cast to the compute dtype at use;
    ``a_log``, ``dt_bias`` and ``d_skip`` are f32 under every policy, and
    everything between the two projections runs in f32.

    Under a model axis (``tp``, ``parallel.tensor_parallel``) each rank
    runs its own heads where the axis divides them, else the whole mixer
    (:meth:`_inner`); the decode caches stay whole on every rank."""

    def __init__(self, cfg: Mamba2Config, policy: DTypePolicy, *,
                 generator, device):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        di, ns, nh = cfg.d_inner, cfg.d_state, cfg.n_heads
        pd = policy.param_dtype
        self.in_proj = dense_init(cfg.dim, 2 * di + 2 * ns + nh, generator,
                                  device, pd)
        self.conv = CausalConv1d(cfg.conv_dim, cfg.conv_k,
                                 generator=generator, device=device,
                                 dtype=pd)
        self.a_log = new_param((nh,), _linspace_log(nh), None, device,
                               torch.float32)
        self.dt_bias = new_param((nh,), zeros, None, device, torch.float32)
        self.d_skip = new_param((nh,), ones, None, device, torch.float32)
        self.norm = RMSNorm(di, device=device, dtype=pd)
        self.out_proj = dense_init(di, cfg.dim, generator, device, pd)

    def _inner(self, x, conv_state=None, ssm_state=None):
        """(out, conv tail, SSM state); streaming when the states are
        given.  Over this rank's heads [h0, h1) (all heads off the heads
        path, :class:`HeadParallel`): ``in_proj``'s product whole; the
        conv over the heads' x channels and all of B and C; the
        recurrence, the skip and the gate over the heads; the norm over
        ``d_inner``; ``out_proj`` over the heads' rows, the partial
        products summed over the axis.  The conv tail is whole, the SSM
        state the heads' (:meth:`_whole_state` gathers it)."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, ns, nh, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
        h0, h1 = self._heads()
        proj = self._column_product("in_proj", x).float()
        z, xbc_raw, dt_raw = proj.split([di, di + 2 * ns, nh], dim=-1)

        def chans(a, e):
            return [(a * hd, e * hd), (di, di + 2 * ns)]

        def heads(a, e):
            return [(a, e)]

        def cols(a, e):
            return [(a * hd, e * hd)]

        def mine(t):
            if (h0, h1) == (0, nh):
                return t
            return torch.cat([t[..., lo:hi] for lo, hi in chans(h0, h1)], -1)

        xbc, _ = causal_conv1d(
            mine(xbc_raw), self._leaf("w", chans, 0, self.conv),
            self._leaf("b", chans, module=self.conv),
            None if conv_state is None else mine(conv_state))
        xbc = F.silu(xbc.float())
        x_ssm, bmat, cmat = xbc.split([(h1 - h0) * hd, ns, ns], dim=-1)

        dt = F.softplus(dt_raw[..., h0:h1] + self._leaf("dt_bias", heads))
        log_decay = -torch.exp(self._leaf("a_log", heads)) * dt
        xh = x_ssm.reshape(b, s, h1 - h0, hd)
        y, state = self._scan(xh, bmat, cmat, dt, log_decay,
                              None if ssm_state is None
                              else ssm_state[:, h0:h1])
        y = (y + self._leaf("d_skip", heads)[:, None] * xh).reshape(
            b, s, (h1 - h0) * hd)
        y = self._norm(y, cols, di) * F.silu(z[..., h0 * hd:h1 * hd])
        out = self._row_product(y, cols).to(x.dtype)
        return out, self._conv_tail(xbc_raw, conv_state), state

    def _scan(self, xh, bmat, cmat, dt, log_decay, ssm_state):
        """The SSD recurrence over the heads of ``xh`` (B, S, n, hd): v =
        x · dt, k and q are B and C broadcast over the heads; chunked over
        the sequence, or one step from ``ssm_state``.  (y, final state)."""
        b, s, n, _ = xh.shape
        ns = self.cfg.d_state
        v = xh * dt[..., None]
        k = bmat[:, :, None, :].expand(b, s, n, ns)
        q = cmat[:, :, None, :].expand(b, s, n, ns)
        if ssm_state is None:
            return chunked_gla(q, k, v, log_decay, chunk=self.cfg.chunk)
        y, state = gla_decode_step(ssm_state, q[:, 0], k[:, 0], v[:, 0],
                                   log_decay[:, 0])
        return y[:, None], state

    def _conv_tail(self, xbc_raw, conv_state):
        """The last k-1 raw conv inputs after this call: the prefill's
        zero-padded on the left for a prompt shorter than that, the
        streamed state's shifted by the new token."""
        k = self.cfg.conv_k
        if conv_state is None:
            tail = F.pad(xbc_raw, (0, 0, max(k - 1 - xbc_raw.shape[1], 0), 0))
        else:
            tail = torch.cat([conv_state.float(), xbc_raw.float()], dim=1)
        return tail[:, tail.shape[1] - (k - 1):]

    def forward(self, x):
        return self._inner(x)[0]

    def prefill(self, x):
        """The forward over the prompt and the streaming cache: the conv
        tail in f32 and the final SSM state."""
        out, conv, state = self._inner(x)
        return out, {"conv": conv.float(), "ssm": self._whole_state(state)}

    def decode(self, x, cache):
        """x (B, 1, D); cache {"conv": (B, k-1, conv_dim), "ssm": (B, H,
        d_state, head_dim)}; the new conv state keeps the cache's dtype."""
        out, conv, state = self._inner(x, cache["conv"], cache["ssm"])
        return out, {"conv": conv.to(cache["conv"].dtype),
                     "ssm": self._whole_state(state)}


def init_mamba2_cache(batch: int, cfg: Mamba2Config, *, device):
    return {
        "conv": torch.zeros((batch, cfg.conv_k - 1, cfg.conv_dim),
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           device=device),
    }
