"""Plain PyTorch oracle for the GSPN line scan.

Canonical semantics (top-to-bottom scan over axis -2, vectorised over the
last axis W):

    h[i, j] = wl[i,j] * h[i-1, j-1]
            + wc[i,j] * h[i-1, j]
            + wr[i,j] * h[i-1, j+1]
            + lam[i,j] * x[i,j]

with h[-1] = 0 and out-of-range neighbours contributing 0.  All arrays are
laid out ``(G, H, W)``; channel-shared weights carry
``G_w = G // channels_per_weight`` leading entries and plane ``g`` reads
weight plane ``g // channels_per_weight``.  Arithmetic runs in the dtype of
the operands.

The adjoint (g = dL/dh) runs the transposed recurrence the other way:

    g[i] = dy[i] + shift_left(wl[p]*g[p]) + wc[p]*g[p] + shift_right(wr[p]*g[p])

with p the row walked just before i (i+1 for the adjoint of the
top-to-bottom scan), so a walk carries the three products of the last
row.  :func:`gspn_scan_adjoint_ref` is that walk; :func:`gspn_scan_ref_vjp`
is the hand-derived backward pass of the whole scan built on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_right(v: torch.Tensor) -> torch.Tensor:
    """v[..., j] -> v[..., j-1]; position 0 becomes 0."""
    return F.pad(v, (1, 0))[..., :-1]


def _shift_left(v: torch.Tensor) -> torch.Tensor:
    """v[..., j] -> v[..., j+1]; last position becomes 0."""
    return F.pad(v, (0, 1))[..., 1:]


def _broadcast_w(w: torch.Tensor, g: int) -> torch.Tensor:
    """Broadcast channel-shared weights (G_w, H, W) to (G, H, W)."""
    gw = w.shape[0]
    if gw == g:
        return w
    if g % gw:
        raise ValueError(f"G={g} not a multiple of G_w={gw}")
    return w.repeat_interleave(g // gw, dim=0)


def step_row(h_prev, x_row, wl_row, wc_row, wr_row, lam_row):
    """One scan step: all inputs (..., W) for the current row."""
    return (wl_row * _shift_right(h_prev)
            + wc_row * h_prev
            + wr_row * _shift_left(h_prev)
            + lam_row * x_row)


def gspn_scan_ref(x, wl, wc, wr, lam, h0=None, reverse: bool = False):
    """Fused-scan oracle.  x, lam: (G, H, W); wl/wc/wr: (G_w, H, W).

    Returns h: (G, H, W).  ``reverse=True`` scans bottom-to-top, in the
    unflipped layout (equivalent to flipping H before and after).
    """
    g, h = x.shape[0], x.shape[1]
    wl, wc, wr = (_broadcast_w(a, g) for a in (wl, wc, wr))
    h_prev = torch.zeros_like(x[:, 0]) if h0 is None else h0
    rows = [None] * h
    order = range(h - 1, -1, -1) if reverse else range(h)
    for i in order:
        h_prev = step_row(h_prev, x[:, i], wl[:, i], wc[:, i], wr[:, i],
                          lam[:, i])
        rows[i] = h_prev
    return torch.stack(rows, dim=1)


def gspn_scan_chunked_ref(x, wl, wc, wr, lam, chunk: int,
                          reverse: bool = False):
    """GSPN-local: propagation confined to segments of ``chunk`` rows.

    Equivalent to resetting the carry every ``chunk`` rows.  Shared weights
    are broadcast to full G before the fold, which interleaves the chunk
    index into the leading dim.
    """
    g, h, w = x.shape
    if h % chunk:
        raise ValueError(f"H={h} not divisible by chunk={chunk}")
    n = h // chunk

    def fold(a):
        return _broadcast_w(a, g).reshape(g * n, chunk, w)

    out = gspn_scan_ref(fold(x), fold(wl), fold(wc), fold(wr), fold(lam),
                        reverse=reverse)
    return out.reshape(g, h, w)


def gspn_scan_adjoint_ref(dy, wl, wc, wr, reverse: bool = True,
                         chunk: int | None = None):
    """Adjoint walk.  dy: (G, H, W); wl/wc/wr: (G_w, H, W).  Returns
    g: (G, H, W).

    ``reverse=True`` is the adjoint of the top-to-bottom scan (walks rows
    last to first), ``reverse=False`` that of the bottom-to-top scan.  The
    three product rows reset to 0 every ``chunk`` rows of the walk, which
    is the adjoint of a forward scan whose carry resets every ``chunk``
    rows (H divisible by ``chunk``).
    """
    g_dim, h = dy.shape[0], dy.shape[1]
    wl, wc, wr = (_broadcast_w(a, g_dim) for a in (wl, wc, wr))
    zeros = torch.zeros_like(dy[:, 0])
    p_l = p_c = p_r = zeros
    rows = [None] * h
    order = range(h - 1, -1, -1) if reverse else range(h)
    for r, i in enumerate(order):
        if chunk and r % chunk == 0:
            p_l = p_c = p_r = zeros
        g_i = dy[:, i] + _shift_left(p_l) + p_c + _shift_right(p_r)
        p_l, p_c, p_r = wl[:, i] * g_i, wc[:, i] * g_i, wr[:, i] * g_i
        rows[i] = g_i
    return torch.stack(rows, dim=1)


def gspn_scan_ref_vjp(x, wl, wc, wr, lam, dy, reverse: bool = False):
    """Hand-derived backward pass of :func:`gspn_scan_ref`.  Returns
    (dx, dwl, dwc, dwr, dlam) with the operands' shapes.

    The forward's previous row is h[i-1] (h[i+1] when ``reverse``), so the
    tap gradients are g times that row at j-1, j and j+1, summed over each
    weight group of ``G // G_w`` planes.
    """
    g_dim, gw_dim = x.shape[0], wl.shape[0]
    h = gspn_scan_ref(x, wl, wc, wr, lam, reverse=reverse)
    g = gspn_scan_adjoint_ref(dy, wl, wc, wr, reverse=not reverse)
    zero = torch.zeros_like(h[:, :1])
    if reverse:
        h_prev = torch.cat([h[:, 1:], zero], dim=1)
    else:
        h_prev = torch.cat([zero, h[:, :-1]], dim=1)
    dws = (g * _shift_right(h_prev), g * h_prev, g * _shift_left(h_prev))
    if gw_dim != g_dim:
        dws = tuple(d.reshape((gw_dim, g_dim // gw_dim) + d.shape[1:]).sum(1)
                    for d in dws)
    return (lam * g, *dws, x * g)


def gspn_scan_quad_ref(x, wl4, wc4, wr4, lam4):
    """Quad-launch semantics on a square grid.  x: (G, N, N); wl4/wc4/wr4:
    (4, G_w, N, N); lam4: (4, G, N, N), directions (tb, bt, lr, rl).
    Entries 0 and 1 scan x, entries 2 and 3 its transpose with taps and lam
    already in transposed geometry; odd entries scan reversed.  Returns
    (4, G, N, N), entries 2 and 3 transposed."""
    xt = x.transpose(-1, -2)
    return torch.stack([
        gspn_scan_ref(x if d < 2 else xt, wl4[d], wc4[d], wr4[d], lam4[d],
                      reverse=d % 2 == 1)
        for d in range(4)])


# ---------------------------------------------------------------------------
# GSPN-1 emulation: per-step dispatches.
# ---------------------------------------------------------------------------

def gspn_scan_per_step(x, wl, wc, wr, lam, block: bool = True):
    """GSPN-1 structural emulation: one dispatch per row.

    Each row step is its own round of eager launches whose result is
    materialised before the next row is dispatched (with ``block`` on a
    CUDA tensor, ``torch.cuda.synchronize()`` after each row, as the
    reference's ``block_until_ready``), mirroring GSPN-1's per-step kernel
    launches and round trips through device memory.  The same values as
    :func:`gspn_scan_ref`.
    """
    g = x.shape[0]
    wl, wc, wr = (_broadcast_w(a, g) for a in (wl, wc, wr))
    sync = block and x.is_cuda
    h_prev = torch.zeros_like(x[:, 0])
    rows = []
    for i in range(x.shape[1]):
        h_prev = step_row(h_prev, x[:, i], wl[:, i], wc[:, i], wr[:, i],
                          lam[:, i])
        if sync:
            torch.cuda.synchronize(x.device)
        rows.append(h_prev)
    return torch.stack(rows, dim=1)


# ---------------------------------------------------------------------------
# Dense affinity-matrix oracle (Eq. 4 of the paper): O(H^2 W^2), tiny shapes
# only.  Validates that the scan equals y = G @ x with the block
# lower-triangular G built from tridiagonal w products.
# ---------------------------------------------------------------------------

def _tridiag(wl_row, wc_row, wr_row):
    """Materialise the (W, W) tridiagonal matrix for one row."""
    return (torch.diag(wc_row)
            + torch.diag(wl_row[1:], -1)    # h_new[k] += wl[k] * h_prev[k-1]
            + torch.diag(wr_row[:-1], 1))   # h_new[k] += wr[k] * h_prev[k+1]


def gspn_dense_oracle(x, wl, wc, wr, lam):
    """Materialised Eq.-4 oracle for a single (H, W) slice per G entry."""
    g_dim, h_dim, _ = x.shape
    wl, wc, wr = (_broadcast_w(a, g_dim) for a in (wl, wc, wr))
    outs = []
    for g in range(g_dim):
        hs = []
        h_prev = torch.zeros_like(x[g, 0])
        for i in range(h_dim):
            m = _tridiag(wl[g, i], wc[g, i], wr[g, i])
            h_prev = m @ h_prev + lam[g, i] * x[g, i]
            hs.append(h_prev)
        outs.append(torch.stack(hs))
    return torch.stack(outs)
