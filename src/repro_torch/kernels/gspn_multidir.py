"""Fused opposite-direction pair scan and its adjoint on the card (CUDA,
``sm_90a``), and the single-launch quad.

:func:`gspn_scan_bidir` replaces the Pallas kernel
``src/repro/kernels/gspn_multidir.py:gspn_scan_bidir_pallas``, the scan of
the vision main path (two launches per GSPN-2 block): direction 0 scans
top to bottom, direction 1 bottom to top, over one shared ``x`` and in
the unflipped layout; the reverse member walks rows H-1..0 by index
arithmetic, no operand is flipped.  Its kernel is the D = 2 instance of
``gspn_fwd_kernel`` in ``csrc/gspn_pair.cu``, the forward template of
:mod:`~repro_torch.kernels.gspn_scan` (the single scan is its D = 1
instance); :func:`gspn_scan_bidir_torch` is its plain version.

:func:`gspn_scan_bidir_bwd` replaces ``gspn_scan_bidir_bwd_pallas`` (same
file), the adjoint of the pair on the training path: direction 0 walks
rows H-1..0 and direction 1 rows 0..H-1 (the forward's walks with the
roles swapped), three f32 product rows per column, g written in f32.  Its
kernel is the D = 2 instance of ``gspn_bwd_kernel``, the adjoint template
in the same source (the single adjoint is its D = 1 instance);
:func:`gspn_scan_bidir_bwd_torch` is its plain version.

:func:`gspn_scan_quad` replaces ``gspn_scan_quad_pallas`` (same file), the
paper's single-launch design point: all four directions of a square grid
in one launch, forward only, on no model path (the four-direction launch
ladder runs it).  It is the D = 4 instance of the template, 4·G_w·splits
CTAs: direction d walks reversed when d is odd, and directions 2 and 3
read x in place, transposed, each batch of their walk from a column slab
of the ring (the reference stacks x with its transpose first; no copy of
x is made here).  :func:`gspn_scan_quad_torch` is its plain version.

Bound.  Each input is read once and the output written once.  Per
(g,h,w) element the pair moves x once, lam and out twice each and the six
tap planes ``6 / cpw`` times, 32 bytes in f32 at cpw = 2 (x 4, lam 8, out
8, taps 12): at batch 64 that is 12.8 / 3.2 / 0.80 / 0.20 MB per launch
at W = 56 / 28 / 14 / 7, about 3.8 / 0.96 / 0.24 / 0.06 us at the H100's
3.35 TB/s.  The adjoint moves dy, the taps at ``1 / cpw`` per direction
and an f32 g: 14 bytes in f32 at cpw = 2, 11.2 / 2.8 / 0.70 / 0.18 MB,
about 3.4 / 0.84 / 0.21 / 0.05 us.  The quad moves x once, lam and out 4
times each and the taps ``12 / cpw``: 60 bytes in f32 at cpw = 2, 24.1 /
6.02 / 1.51 / 0.38 MB, 7.19 / 1.80 / 0.45 / 0.11 us.  The operations (7
and 9 per element) are far below the card's f32 rate; the chain of H row
steps of each CTA sets the time at the main widths.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, ref
from repro_torch.kernels.gspn_scan import (chunk_arg, compute_dtype, launch,
                                           launch_bwd)

KERNEL = "gspn_pair_fwd"
KERNEL_BWD = "gspn_pair_bwd"
KERNEL_QUAD = "gspn_quad_fwd"


def gspn_scan_bidir(x, wl2, wc2, wr2, lam2, *, chunk: int | None = None):
    """Fused pair scan.  x: (G, H, W), shared by both directions;
    wl2/wc2/wr2: (2, G_w, H, W); lam2: (2, G, H, W).  Returns
    (2, G, H, W) in x.dtype: entry 0 top to bottom, entry 1 bottom to top,
    both unflipped.  ``chunk`` resets each direction's carry every
    ``chunk`` rows of its walk.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`gspn_scan_bidir_torch`."""
    if not x.is_cuda:
        return gspn_scan_bidir_torch(x, wl2, wc2, wr2, lam2, chunk=chunk)
    return launch(2, KERNEL, x, wl2, wc2, wr2, lam2, chunk)


def gspn_scan_bidir_torch(x, wl2, wc2, wr2, lam2, *,
                          chunk: int | None = None):
    """Plain PyTorch version of :func:`gspn_scan_bidir`, on any device:
    f32 arithmetic and carry (f64 for f64 operands), output in x.dtype."""
    cuda_lib.plain_calls[KERNEL] += 1
    cd = compute_dtype(x.dtype)
    xf = x.to(cd)
    chunked = chunk_arg(x.shape[1], chunk)
    outs = []
    for d in (0, 1):
        args = (xf,) + tuple(a[d].to(cd) for a in (wl2, wc2, wr2, lam2))
        if chunked:
            outs.append(ref.gspn_scan_chunked_ref(*args, chunk,
                                                  reverse=d == 1))
        else:
            outs.append(ref.gspn_scan_ref(*args, reverse=d == 1))
    return torch.stack(outs).to(x.dtype)


def gspn_scan_bidir_bwd(dy2, wl2, wc2, wr2, *, chunk: int | None = None):
    """Fused adjoint of :func:`gspn_scan_bidir`: g2 = dL/dh from dy2
    (2, G, H, W) and the forward's taps (2, G_w, H, W), all unflipped.
    Entry 0 walks rows H-1..0, entry 1 rows 0..H-1, each with its carry
    reset every ``chunk`` rows of its walk.  Returns (2, G, H, W) in
    float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`gspn_scan_bidir_bwd_torch`."""
    if not dy2.is_cuda:
        return gspn_scan_bidir_bwd_torch(dy2, wl2, wc2, wr2, chunk=chunk)
    return launch_bwd(2, KERNEL_BWD, dy2, wl2, wc2, wr2, chunk)


def gspn_scan_bidir_bwd_torch(dy2, wl2, wc2, wr2, *,
                              chunk: int | None = None):
    """Plain PyTorch version of :func:`gspn_scan_bidir_bwd`, on any device:
    f32 arithmetic, carry and output (f64 for f64 operands)."""
    cuda_lib.plain_calls[KERNEL_BWD] += 1
    cd = compute_dtype(dy2.dtype)
    chunked = chunk_arg(dy2.shape[2], chunk)
    return torch.stack([
        ref.gspn_scan_adjoint_ref(*(a[d].to(cd) for a in (dy2, wl2, wc2, wr2)),
                                  reverse=d == 0, chunk=chunked)
        for d in (0, 1)])


def gspn_scan_quad(x, wl4, wc4, wr4, lam4):
    """All four directions in one launch, square grids only, forward only.
    x: (G, N, N); wl4/wc4/wr4: (4, G_w, N, N); lam4: (4, G, N, N), in the
    order (tb, bt, lr, rl), entries 2 and 3 already in transposed geometry
    (rows of entry 2 are the original columns).  Returns (4, G, N, N) in
    x.dtype, entries 2 and 3 transposed (the caller undoes it).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`gspn_scan_quad_torch`.  Operands that require grad are refused:
    training uses the pair dispatch (``ops.gspn_scan_pair``)."""
    if x.dim() != 3 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"the quad scan needs a square grid (G, N, N), got "
                         f"{tuple(x.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wl4, wc4, wr4, lam4)):
        raise ValueError("the quad scan is forward-only; differentiate "
                         "through ops.gspn_scan_pair")
    if not x.is_cuda:
        return gspn_scan_quad_torch(x, wl4, wc4, wr4, lam4)
    return launch(4, KERNEL_QUAD, x, wl4, wc4, wr4, lam4, None)


def gspn_scan_quad_torch(x, wl4, wc4, wr4, lam4):
    """Plain PyTorch version of :func:`gspn_scan_quad`, on any device: f32
    arithmetic and carry (f64 for f64 operands), output in x.dtype."""
    cuda_lib.plain_calls[KERNEL_QUAD] += 1
    cd = compute_dtype(x.dtype)
    return ref.gspn_scan_quad_ref(
        *(a.to(cd) for a in (x, wl4, wc4, wr4, lam4))).to(x.dtype)
