"""GSPN-2 core algorithm, vision half (paper §3.2, §4.2).

* :func:`normalize_taps` — row-stochastic normalisation of the 3-tap
  propagation logits (masked softmax in f32; boundary taps excluded).
* :func:`directional_scan` — the multi-direction dispatch (DESIGN.md §2):
  opposite directions (T→B/B→T, L→R/R→L) are fused into one
  ``gspn_scan_pair`` launch each, the reverse member being index
  arithmetic inside the kernel and the horizontal pair costing one
  transpose of the operands at this boundary, so a four-direction pass
  issues two launches.
* :class:`GSPNAttentionConfig` + :class:`GSPNAttention` — the GSPN-2
  attention module with compact channel propagation: channel-shared taps
  and a compressive proxy space ``C → C_proxy → C`` (paper §4.2).

Tensors keep the reference package's layout: images NHWC, scan operands
(G, H, W) with G = B·C_proxy in channel-major order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import gspn_scan, gspn_scan_pair
from repro_torch.kernels.spec import ScanSpec, dtype_name
from repro_torch.models.layers import new_param

DIRECTIONS = ("tb", "bt", "lr", "rl")

# Opposite-direction pairs fused into one kernel launch each: the first
# member is the canonical (forward) traversal, the second its mirror.
OPPOSITE_PAIRS = (("tb", "bt"), ("lr", "rl"))


# ---------------------------------------------------------------------------
# Tap normalisation (Stability–Context condition).
# ---------------------------------------------------------------------------

def normalize_taps(logits, mode: str = "softmax"):
    """Row-stochastic 3-tap weights from logits.

    logits: (..., W, 3), taps (left, center, right) referring to the
    previous row's neighbours (j-1, j, j+1).  Boundary taps are masked
    (j=0 has no left neighbour; j=W-1 no right) with float32's most
    negative value before the softmax, so each row of the implied
    tridiagonal matrix sums to 1.  Runs in f32 whatever the input dtype.

    Returns (wl, wc, wr), each (..., W), dtype f32.
    """
    w = logits.shape[-2]
    logits = logits.float()
    j = torch.arange(w, device=logits.device)
    neg = torch.finfo(torch.float32).min
    zero = torch.zeros(w, device=logits.device)
    mask = torch.stack([
        torch.where(j == 0, neg, zero),        # left tap invalid at j=0
        zero,                                  # center always valid
        torch.where(j == w - 1, neg, zero),    # right tap invalid at j=W-1
    ], dim=-1)                                 # (W, 3)
    if mode == "softmax":
        z = torch.softmax(logits + mask, dim=-1)
    elif mode == "abs":
        a = logits.abs() * (mask == 0.0)
        z = a / (a.sum(dim=-1, keepdim=True) + 1e-6)
    else:
        raise ValueError(mode)
    return z[..., 0], z[..., 1], z[..., 2]


# ---------------------------------------------------------------------------
# Directional dispatch.
# ---------------------------------------------------------------------------

def _to_canonical(a, direction: str):
    """Orient (..., H, W) so the canonical scan (top->bottom over axis -2)
    realises the requested direction."""
    if direction == "tb":
        return a
    if direction == "bt":
        return torch.flip(a, dims=(-2,))
    if direction == "lr":
        return a.transpose(-1, -2)
    if direction == "rl":
        return torch.flip(a.transpose(-1, -2), dims=(-2,))
    raise ValueError(direction)


def _from_canonical(a, direction: str):
    if direction == "tb":
        return a
    if direction == "bt":
        return torch.flip(a, dims=(-2,))
    if direction == "lr":
        return a.transpose(-1, -2)
    if direction == "rl":
        return torch.flip(a, dims=(-2,)).transpose(-1, -2)
    raise ValueError(direction)


def directional_scan(x, wl, wc, wr, lam, direction, **scan_kwargs):
    """Run one or several directional passes through the fused dispatch.

    Single direction (``direction`` a string): x, lam: (G, H, W); w*:
    (G_w, H, W) in the original orientation; returns (G, H, W).

    Multi-direction (``direction`` a sequence of distinct names): w*:
    (D, G_w, H, W) and lam: (D, G, H, W) stacked per direction, in the
    original orientation; ``x`` is shared by every direction.  Returns
    (D, G, H, W).  Opposite pairs in the sequence are fused into one
    ``gspn_scan_pair`` launch each (except under ``impl="per_step"``);
    unpaired directions run single scans.

    Tap logits must already be produced for the oriented geometry (see
    :func:`_normalize_taps_oriented`).  ``scan_kwargs`` (``spec``,
    ``chunk``, ``impl``) go to the ops.
    """
    if not isinstance(direction, str):
        return _multi_directional_scan(x, wl, wc, wr, lam,
                                       tuple(direction), **scan_kwargs)
    h = gspn_scan(*(_to_canonical(a, direction) for a in (x, wl, wc, wr, lam)),
                  **scan_kwargs)
    return _from_canonical(h, direction)


def _multi_directional_scan(x, wl, wc, wr, lam, directions, **scan_kwargs):
    idx = {d: i for i, d in enumerate(directions)}
    if len(idx) != len(directions):
        raise ValueError(f"duplicate directions {directions}")
    # per_step is the GSPN-1 emulation, by construction one dispatch per
    # row per direction, so pair fusion is skipped for it.  The impl leg
    # lives in the ScanSpec when one is passed.
    spec = scan_kwargs.get("spec")
    impl = spec.impl if spec is not None else scan_kwargs.get("impl", "auto")
    out = [None] * len(directions)
    fused = set()
    for fwd_d, rev_d in OPPOSITE_PAIRS:
        if impl == "per_step" or fwd_d not in idx or rev_d not in idx:
            continue
        i, j = idx[fwd_d], idx[rev_d]
        if fwd_d == "lr":      # horizontal: one transpose at dispatch
            def ori(a):
                return a.transpose(-1, -2)
        else:                  # vertical: already canonical
            def ori(a):
                return a
        h2 = gspn_scan_pair(
            ori(x),
            torch.stack([ori(wl[i]), ori(wl[j])]),
            torch.stack([ori(wc[i]), ori(wc[j])]),
            torch.stack([ori(wr[i]), ori(wr[j])]),
            torch.stack([ori(lam[i]), ori(lam[j])]),
            **scan_kwargs,
        )
        out[i], out[j] = ori(h2[0]), ori(h2[1])
        fused.update((fwd_d, rev_d))
    for d, i in idx.items():
        if d not in fused:
            out[i] = directional_scan(x, wl[i], wc[i], wr[i], lam[i], d,
                                      **scan_kwargs)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# GSPN-2 attention module (vision, channels-last).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GSPNAttentionConfig:
    dim: int                       # C
    proxy_dim: int = 8             # C_proxy (paper: 2..32; ImageNet uses 2)
    directions: Sequence[str] = DIRECTIONS
    channel_shared: bool = True    # GSPN-2 compact mode; False = GSPN-1 mode
    chunk: int | None = None       # GSPN-local segment length (rows)
    norm_mode: str = "softmax"
    impl: str = "auto"             # kernel selection, see kernels.ops
    param_dtype: torch.dtype = torch.float32
    # Mixed-precision policy (DESIGN.md §10): projections and streamed scan
    # operands run in compute_dtype; the tap softmax, the scan carry and
    # the directional merge stay f32.
    compute_dtype: torch.dtype = torch.float32
    carry_dtype: torch.dtype = torch.float32


def _normalize_taps_oriented(logits, direction: str, mode: str):
    """Row-stochastic taps for ``direction`` from logits (..., H, W, 3),
    returned in the original (H, W) orientation.

    Boundary masking refers to the scan geometry, so the horizontal
    directions normalise in transposed space; the flip of 'bt'/'rl' acts
    along the scan axis and commutes with the masking.
    """
    if direction in ("lr", "rl"):
        wl, wc, wr = normalize_taps(logits.transpose(-3, -2), mode)
        return tuple(a.transpose(-1, -2) for a in (wl, wc, wr))
    return normalize_taps(logits, mode)


def _uniform(scale: float):
    def init(shape, generator):
        return torch.empty(shape).uniform_(-scale, scale, generator=generator)
    return init


class GSPNAttention(nn.Module):
    """x: (B, H, W, C) -> (B, H, W, C).

    Parameters, named and laid out as the reference's
    ``init_gspn_attention``: ``down`` (C, Cp), ``w_taps`` (C, 3·D[·Cp]),
    ``w_lam`` and ``w_u`` (C, D·Cp), ``up`` (Cp, C).  All directional passes
    run through one ``directional_scan`` call, two fused launches for the
    default four directions.
    """

    def __init__(self, cfg: GSPNAttentionConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        nd, cp, c = len(cfg.directions), cfg.proxy_dim, cfg.dim
        tap_out = 3 * nd if cfg.channel_shared else 3 * nd * cp
        init = _uniform(1.0 / math.sqrt(c))
        pd = cfg.param_dtype
        self.down = new_param((c, cp), init, generator, device, pd)
        self.w_taps = new_param((c, tap_out), init, generator, device, pd)
        self.w_lam = new_param((c, nd * cp), init, generator, device, pd)
        self.w_u = new_param((c, nd * cp), init, generator, device, pd)
        self.up = new_param((cp, c), _uniform(1.0 / math.sqrt(cp)),
                            generator, device, pd)
        self.spec = ScanSpec(impl=cfg.impl,
                             stream_dtype=dtype_name(cfg.compute_dtype),
                             carry_dtype=dtype_name(cfg.carry_dtype))

    def forward(self, x):
        cfg = self.cfg
        b, h, w, _ = x.shape
        cp = cfg.proxy_dim
        cd = cfg.compute_dtype
        xf = x.to(cd)

        x_p = xf @ self.down.to(cd)                        # (B,H,W,Cp)
        taps = xf @ self.w_taps.to(cd)                     # (B,H,W,3·D[·Cp])
        lam = torch.sigmoid(xf @ self.w_lam.to(cd))
        u = xf @ self.w_u.to(cd)                           # (B,H,W,D·Cp)

        # (B, H, W, Cp) -> (B·Cp, H, W): channel-major grouping, so plane g
        # reads weight row g // Cp (channels_per_weight = Cp).
        def to_scan(a, ch):
            return a.movedim(-1, 1).reshape(b * ch, h, w)

        x_scan = to_scan(x_p, cp)
        wls, wcs, wrs, lams = [], [], [], []
        for d_idx, direction in enumerate(cfg.directions):
            if cfg.channel_shared:
                tap_d = taps[..., 3 * d_idx:3 * (d_idx + 1)]   # (B,H,W,3)
            else:
                tap_d = taps[..., 3 * cp * d_idx:3 * cp * (d_idx + 1)]
                tap_d = tap_d.reshape(b, h, w, cp, 3).movedim(3, 1)
                tap_d = tap_d.reshape(b * cp, h, w, 3)
            wl, wc, wr = _normalize_taps_oriented(tap_d, direction,
                                                  cfg.norm_mode)
            # The softmax ran in f32; the normalised taps stream in cd.
            wls.append(wl.to(cd))
            wcs.append(wc.to(cd))
            wrs.append(wr.to(cd))
            lams.append(to_scan(lam[..., cp * d_idx:cp * (d_idx + 1)], cp))

        h_all = directional_scan(
            x_scan, torch.stack(wls), torch.stack(wcs), torch.stack(wrs),
            torch.stack(lams), cfg.directions, chunk=cfg.chunk,
            spec=self.spec)                                # (D, B·Cp, H, W)

        # The directional merge accumulates in f32 whatever the stream dtype.
        out = torch.zeros((b, h, w, cp), dtype=torch.float32, device=x.device)
        for d_idx in range(len(cfg.directions)):
            h_d = h_all[d_idx].reshape(b, cp, h, w).movedim(1, -1)
            out = out + (u[..., cp * d_idx:cp * (d_idx + 1)] * h_d).float()

        y = out.to(cd) @ self.up.to(cd)
        return y.to(x.dtype)


def gspn_attention_param_count(cfg: GSPNAttentionConfig) -> int:
    nd = len(cfg.directions)
    cp = cfg.proxy_dim
    tap_out = 3 * nd if cfg.channel_shared else 3 * nd * cp
    return (cfg.dim * cp + cfg.dim * tap_out + 2 * cfg.dim * nd * cp
            + cp * cfg.dim)
