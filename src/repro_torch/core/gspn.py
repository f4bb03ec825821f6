"""GSPN-2 core algorithm (paper §3.2, §4.2).

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
* :class:`GSPNSeqConfig` + :class:`GSPNSeqMixer` — the 1D-sequence
  adaptation, a causal sub-quadratic token mixer for language models
  (DESIGN.md §4): fold L → (H, W), a causal T→B 2D scan plus a causal
  within-row scan, with :func:`gspn_seq_prefill_chunk` resuming both
  from the O(W) streaming cache (DESIGN.md §9).

Tensors keep the reference package's layout: images NHWC, sequences
(B, L, D), scan operands (G, H, W) with G = B·C_proxy in channel-major
order.
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
    ``chunk``, ``impl``, and for ``impl="sp"`` the routing legs ``mesh``,
    ``seq_axis``, ``sp_strategy``, ``sp_boundary_dtype``) go to the ops;
    under sp the pairs stay fused, sharing one boundary collective.
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
    seq_axis: str = "seq"          # mesh axis for impl="sp" (DESIGN.md §8)
    sp_strategy: str = "auto"      # boundary-exchange strategy for "sp"
    param_dtype: torch.dtype = torch.float32
    # Mixed-precision policy (DESIGN.md §10): projections and streamed scan
    # operands run in compute_dtype; the tap softmax, the scan carry and
    # the directional merge stay f32.  boundary_dtype is the sp exchange's
    # wire dtype (None: compute_dtype).
    compute_dtype: torch.dtype = torch.float32
    carry_dtype: torch.dtype = torch.float32
    boundary_dtype: torch.dtype | None = None


def _scan_kwargs(cfg, spec: ScanSpec, mesh) -> dict:
    """The ``scan_kwargs`` of the attention module, the sequence mixer and
    chunked prefill: the launch's spec, plus the sp routing legs (where
    the scan runs and the wire dtype), which only ``impl="sp"`` reads."""
    bd = cfg.boundary_dtype if cfg.boundary_dtype is not None \
        else cfg.compute_dtype
    return dict(spec=spec, mesh=mesh, seq_axis=cfg.seq_axis,
                sp_strategy=cfg.sp_strategy, sp_boundary_dtype=bd)


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
        return torch.empty(shape, device=generator.device).uniform_(
            -scale, scale, generator=generator)
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

    def forward(self, x, mesh=None):
        """``mesh`` is read by ``impl="sp"`` only, which shards each
        direction's scan dimension over ``cfg.seq_axis``."""
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
            **_scan_kwargs(cfg, self.spec, mesh))          # (D, B·Cp, H, W)

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


# ---------------------------------------------------------------------------
# 1D-sequence causal mixer (LM adaptation, DESIGN.md §4).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GSPNSeqConfig:
    """The sequence mixer's configuration.  ``impl`` defaults to
    ``"auto"``, which runs the CUDA kernel #1 on CUDA tensors and the
    plain scan on the CPU; the reference's ``LMConfig.gspn_impl`` defaults
    to ``"xla"``, its plain path."""
    dim: int
    proxy_dim: int = 8
    row_width: int = 0             # 0 => the fold derives from L per call
    norm_mode: str = "softmax"
    impl: str = "auto"
    seq_axis: str = "seq"          # mesh axis for impl="sp" (DESIGN.md §8)
    sp_strategy: str = "auto"
    param_dtype: torch.dtype = torch.float32
    # Mixed-precision policy (DESIGN.md §10): projections and streamed
    # scan operands in compute_dtype; tap softmax, carries and the decode
    # cache in f32; the sp exchange's wire in boundary_dtype (None:
    # compute_dtype).
    compute_dtype: torch.dtype = torch.float32
    carry_dtype: torch.dtype = torch.float32
    boundary_dtype: torch.dtype | None = None


class GSPNSeqMixer(nn.Module):
    """x: (B, L, D) -> (B, L, D), causal.

    Parameters, named and laid out as the reference's
    ``init_gspn_seq_mixer``: ``down`` (D, Cp), ``w_taps`` (D, 3), ``w_row``
    (D, 1), ``w_lam`` and ``w_u`` (D, 2·Cp), ``up`` (Cp, D).  Both folded
    passes are single scans (``kernels.ops.gspn_scan``) with
    channels_per_weight = Cp.

    Under a model axis (``tp``, ``parallel.tensor_parallel``) the mixer is
    replicated: every rank runs it whole on its data-local tokens.  The
    rules store ``down`` and ``up`` sliced over the axis (their FFN
    patterns catch them), so :meth:`whole` gathers them before use.
    """

    tp = None

    def __init__(self, cfg: GSPNSeqConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        cp, d = cfg.proxy_dim, cfg.dim
        init = _uniform(1.0 / math.sqrt(d))
        pd = cfg.param_dtype
        self.down = new_param((d, cp), init, generator, device, pd)
        self.w_taps = new_param((d, 3), init, generator, device, pd)
        self.w_row = new_param((d, 1), init, generator, device, pd)
        self.w_lam = new_param((d, 2 * cp), init, generator, device, pd)
        self.w_u = new_param((d, 2 * cp), init, generator, device, pd)
        self.up = new_param((cp, d), _uniform(1.0 / math.sqrt(cp)),
                            generator, device, pd)
        spec = ScanSpec(impl=cfg.impl,
                        stream_dtype=dtype_name(cfg.compute_dtype),
                        carry_dtype=dtype_name(cfg.carry_dtype))
        self.spec = spec
        self.resume_spec = spec.with_(boundary="chunk_resume")

    def forward(self, x, return_cache: bool = False, mesh=None):
        return apply_gspn_seq_mixer(self, x, return_cache, mesh=mesh)

    def whole(self, name: str):
        """Parameter ``name``, whole (gathered over the model axis where
        it is stored sliced)."""
        return getattr(self, name) if self.tp is None \
            else self.tp.whole(self, name)


def _fold_len(l: int, row_width: int) -> tuple[int, int]:
    w = row_width or 1 << max(1, math.ceil(math.log2(max(l, 4)) / 2))
    h = -(-l // w)
    return h, w


def _seq_mixer_projections(mixer: GSPNSeqMixer, xf):
    """Per-token projections shared by the one-shot and chunked paths.
    xf: (B, L, D) in the compute dtype.  Returns (x_p, taps, row_g, lam,
    u), all in xf.dtype."""
    cd = xf.dtype
    x_p = xf @ mixer.whole("down").to(cd)                    # (B,L,Cp)
    taps = xf @ mixer.w_taps.to(cd)                          # (B,L,3)
    row_g = torch.sigmoid(xf @ mixer.w_row.to(cd))
    lam = torch.sigmoid(xf @ mixer.w_lam.to(cd))
    u = xf @ mixer.w_u.to(cd)
    return x_p, taps, row_g, lam, u


def _fold_ops(b, h, w, l):
    """The row-major (B, L, K) <-> (B·K, H, W) fold/unfold pair for a
    sequence of l tokens on an (h, w) grid (zero-padded tail).  One
    definition serves the one-shot and chunked paths: the chunked ≡
    one-shot equivalence depends on an identical layout."""
    pad = h * w - l

    def fold(a):
        k = a.shape[-1]
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        return a.reshape(b, h, w, k).movedim(-1, 1).reshape(b * k, h, w)

    def unfold(a, k):
        a = a.reshape(b, k, h, w).movedim(1, -1)
        return a.reshape(b, h * w, k)[:, :l]

    return fold, unfold


def _tb_taps(taps, fold, b, h, w, mode, dtype):
    """Row-stochastic T→B tap weights from per-token logits (B, L, 3):
    fold to the grid, put the 3 taps innermost and normalise (the softmax
    in f32); returned in ``dtype``, the stream dtype."""
    wl, wc, wr = normalize_taps(
        fold(taps).reshape(b, 3, h, w).permute(0, 2, 3, 1), mode)
    return wl.to(dtype), wc.to(dtype), wr.to(dtype)


def _within_row_pass(x_p, row_g, lam_hi, fold, scan_kwargs):
    """Pass 2: the causal within-row recurrence h[j] = g·h[j-1] + λ·x[j],
    a centre-tap-only scan in the 'lr' orientation (wl = wr = 0), each
    grid row independent.  Every row resets its carry at column 0, so the
    pass is local to whatever fold it is given."""
    x_lr = _to_canonical(fold(x_p), "lr")
    gate = _to_canonical(fold(row_g), "lr")
    zeros = torch.zeros_like(gate)
    h_row = gspn_scan(x_lr, zeros, gate, zeros,
                      _to_canonical(fold(lam_hi), "lr"), **scan_kwargs)
    return _from_canonical(h_row, "lr")


def _slice_boundary_cache(grid_tb, grid_row, l, w, prev_fallback):
    """The outgoing O(W) decode cache at position l from the scanned grids
    (B, Cp, H, W): the previous and current grid rows of the T→B pass and
    the within-row state.  ``prev_fallback`` stands in for the row above
    when the last, partial row is the grid's first: zeros at the start of
    a sequence, the incoming boundary row when chunking.  One definition
    serves both paths, so the streaming convention cannot drift."""
    i_last, j_last = (l - 1) // w, (l - 1) % w
    row_i = grid_tb[:, :, i_last, :]
    if j_last == w - 1:
        prev_row = row_i
        cur_row = row_i
    else:
        prev_row = (grid_tb[:, :, i_last - 1, :] if i_last > 0
                    else prev_fallback)
        col_mask = (torch.arange(w, device=row_i.device) <= j_last).float()
        cur_row = row_i * col_mask
    return {
        "prev_row": prev_row.float(),
        "cur_row": cur_row.float(),
        "row_state": grid_row[:, :, i_last, j_last].float(),
    }


def apply_gspn_seq_mixer(mixer: GSPNSeqMixer, x, return_cache: bool = False,
                         *, mesh=None):
    """The causal mixer over x: (B, L, D) -> (B, L, D).

    The sequence folds row-major into (H, W); causality holds because the
    T→B pass reads only row i-1, all of whose tokens precede row i, and
    the within-row pass is a left-to-right recurrence.
    ``return_cache=True`` also returns the O(W) decode cache (previous
    grid row, current row, within-row state, position) for streaming.
    With ``impl="sp"`` and a mesh carrying ``cfg.seq_axis``, both folded
    passes shard their scan dimension (DESIGN.md §8): grid rows for the
    T→B pass, grid columns for the within-row pass.
    """
    cfg = mixer.cfg
    b, l, _ = x.shape
    cp = cfg.proxy_dim
    h, w = _fold_len(l, cfg.row_width)
    cd = cfg.compute_dtype
    xf = x.to(cd)

    x_p, taps, row_g, lam, u = _seq_mixer_projections(mixer, xf)
    fold, unfold = _fold_ops(b, h, w, l)
    scan_kwargs = _scan_kwargs(cfg, mixer.spec, mesh)

    # Pass 1: causal T->B 2D scan in proxy space, channel-shared taps.
    wl, wc, wr = _tb_taps(taps, fold, b, h, w, cfg.norm_mode, cd)
    h_tb = gspn_scan(fold(x_p), wl, wc, wr, fold(lam[..., :cp]),
                     **scan_kwargs)

    # Pass 2: causal within-row scan.
    h_row = _within_row_pass(x_p, row_g, lam[..., cp:], fold, scan_kwargs)

    y = unfold(h_tb, cp) * u[..., :cp] + unfold(h_row, cp) * u[..., cp:]
    y = (y @ mixer.whole("up").to(cd)).to(x.dtype)
    if not return_cache:
        return y
    cache = _slice_boundary_cache(
        h_tb.reshape(b, cp, h, w), h_row.reshape(b, cp, h, w), l, w,
        torch.zeros((b, cp, w), dtype=h_tb.dtype, device=x.device))
    cache["pos"] = torch.full((b,), l, dtype=torch.int32, device=x.device)
    return y, cache


def gspn_seq_prefill_chunk(mixer: GSPNSeqMixer, x, cache, *,
                           pos: int | None = None, mesh=None):
    """Resume the folded causal scans from a streaming cache (DESIGN.md §9).

    x: (B, T, D), the next T prompt tokens; ``cache``: the O(W) decode
    cache of a previous call (or a fresh all-zero cache at position 0).
    Returns (y (B, T, D), new_cache) such that a chain of chunks equals one
    one-shot prefill over the concatenated tokens.  A cache advanced
    mid-row by ``gspn_decode_step`` is not a valid input: this path resumes
    from ``prev_row`` only.

    The incoming ``prev_row`` becomes a synthetic row 0 of the chunk's
    folded grid with λ = 1 and zero taps (the scan's zero carry then
    reproduces it exactly), launched under the ``chunk_resume`` boundary
    label; the within-row pass is chunk-local because every grid row
    resets at column 0.

    Contract: the chunk starts on a grid-row boundary,
    ``cache['pos'] % row_width == 0``, and ``row_width`` is fixed; a
    ValueError otherwise.  ``pos`` is the chunk's offset when the caller
    knows it on the host (the LM passes it), which spares reading the
    cache's positions back from the device.  ``mesh`` shards both passes
    under ``impl="sp"``, as in :func:`apply_gspn_seq_mixer`.
    """
    cfg = mixer.cfg
    b, t, _ = x.shape
    cp = cfg.proxy_dim
    w = cfg.row_width
    if w <= 0:
        raise ValueError(
            "chunked GSPN prefill needs a fixed row_width (row_width=0 "
            "derives the fold from the total length, which a chunked "
            "caller does not know)")
    offsets = {pos} if pos is not None else set(cache["pos"].tolist())
    if any(o % w for o in offsets):
        raise ValueError(
            f"a prefill chunk must start on a grid-row boundary: position "
            f"{sorted(offsets)} is not a multiple of row_width={w}")
    hc = -(-t // w)
    cd = cfg.compute_dtype
    xf = x.to(cd)

    x_p, taps, row_g, lam, u = _seq_mixer_projections(mixer, xf)
    fold, unfold = _fold_ops(b, hc, w, t)
    scan_kwargs = _scan_kwargs(cfg, mixer.resume_spec, mesh)

    # Pass 1: T->B scan seeded with the incoming boundary row (λ = 1,
    # taps 0 at row 0).  The f32 cached row is rounded to the stream dtype
    # here, the one cross-chunk rounding of the §10 error budget.
    wl, wc, wr = _tb_taps(taps, fold, b, hc, w, cfg.norm_mode, cd)
    ztap = torch.zeros((b, 1, w), dtype=cd, device=x.device)
    x_tb = torch.cat(
        [cache["prev_row"].to(cd).reshape(b * cp, 1, w), fold(x_p)], dim=1)
    lam_tb = torch.cat(
        [torch.ones((b * cp, 1, w), dtype=cd, device=x.device),
         fold(lam[..., :cp])], dim=1)
    h_tb = gspn_scan(x_tb, torch.cat([ztap, wl], dim=1),
                     torch.cat([ztap, wc], dim=1),
                     torch.cat([ztap, wr], dim=1), lam_tb,
                     **scan_kwargs)[:, 1:]

    # Pass 2: within-row scan, chunk-local.
    h_row = _within_row_pass(x_p, row_g, lam[..., cp:], fold, scan_kwargs)

    y = unfold(h_tb, cp) * u[..., :cp] + unfold(h_row, cp) * u[..., cp:]
    y = (y @ mixer.up.to(cd)).to(x.dtype)
    new_cache = _slice_boundary_cache(
        h_tb.reshape(b, cp, hc, w), h_row.reshape(b, cp, hc, w), t, w,
        cache["prev_row"].float())
    new_cache["pos"] = cache["pos"] + t
    return y, new_cache

