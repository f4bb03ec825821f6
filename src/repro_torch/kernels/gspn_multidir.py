"""Fused opposite-direction pair scan and its adjoint on the card (CUDA,
``sm_90a``), and the single-launch quad.

:func:`gspn_scan_bidir` replaces the Pallas kernel
``src/repro/kernels/gspn_multidir.py:gspn_scan_bidir_pallas``, the scan of
the vision main path (two launches per GSPN-2 block): direction 0 scans
top to bottom, direction 1 bottom to top, over one shared ``x`` and in
the unflipped layout; the reverse member walks rows H-1..0 by index
arithmetic, no operand is flipped.  Its kernel is ``gspn_pair_fwd_kernel``
in ``csrc/gspn_pair.cu``; :func:`gspn_scan_bidir_torch` is its plain
version.

:func:`gspn_scan_bidir_bwd` replaces ``gspn_scan_bidir_bwd_pallas`` (same
file), the adjoint of the pair on the training path: direction 0 walks
rows H-1..0 and direction 1 rows 0..H-1 (the forward's walks with the
roles swapped), three f32 product rows per column, g written in f32.  Its
kernel is ``gspn_pair_bwd_kernel`` in the same source;
:func:`gspn_scan_bidir_bwd_torch` is its plain version.

Bound.  Each input is read once and the output written once: per (g,h,w)
element the forward moves x once, lam and out twice each and the six tap
planes ``6 / cpw`` times, 32 bytes in f32 at cpw = 2 (x 4, lam 8, out 8,
taps 12): at batch 64 that is 12.8 / 3.2 / 0.80 / 0.20 MB per launch at
W = 56 / 28 / 14 / 7, about 3.8 / 0.96 / 0.24 / 0.06 us at the H100's
3.35 TB/s.  The adjoint moves dy, the taps at ``1 / cpw`` per direction
and an f32 g: 14 bytes in f32 at cpw = 2, 11.2 / 2.8 / 0.70 / 0.18 MB,
about 3.4 / 0.84 / 0.21 / 0.05 us.  The operations (7 and 9 per element)
are far below the card's f32 rate.

Design of the pair kernels (the source's note says why each choice): one
CTA per (weight group, direction) with one warp per plane of the group
and at least eight warps that issue copies; each lane keeps the carry of
columns ``l, l+32, ...`` in registers and takes its neighbours by warp
shuffle, with no barrier per row; the group's tap rows are staged once
for all its planes, with each plane's streamed rows, by ``cp.async`` into
a shared-memory ring that holds the whole plane at the main widths (one
batch, one barrier) and streams taller planes in four batches.
:func:`pair_launch_shape` chooses the launch shape from the operands'
shape alone.  The single scan, its adjoint and the quad still run the
first design (a CTA per plane and direction, a thread per column, the
next row prefetched into registers, a barrier per row,
``csrc/gspn_scan.cu``).

:func:`gspn_scan_quad` replaces ``gspn_scan_quad_pallas`` (same file), the
paper's single-launch design point: all four directions of a square grid
in one launch, forward only, on no model path (the four-direction launch
ladder runs it).  It stacks x with its transpose once, then the D = 4
instance of the first design's forward template runs one CTA per (plane,
direction), 4·G CTAs: direction d reads orientation ``d >> 1`` and walks
reversed when ``d & 1``.  :func:`gspn_scan_quad_torch` is its plain
version.  Per (g,h,w) element the function needs x once, lam and out 4
each and the taps ``12 / cpw``: 60 bytes in f32 at cpw = 2, 24.1 / 6.02 /
1.51 / 0.38 MB per call at batch 64 and N = 56 / 28 / 14 / 7, 7.19 / 1.80
/ 0.45 / 0.11 us at 3.35 TB/s (the kernel reads x twice, as the stacked xx
the wrapper builds first, as the reference does); the chain of N row
latencies sets its time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib, ref
from repro_torch.kernels.gspn_scan import (_DTYPE_CODES, _check, _count,
                                           _span, chunk_arg, compute_dtype,
                                           launch)

KERNEL = "gspn_pair_fwd"
KERNEL_BWD = "gspn_pair_bwd"
KERNEL_QUAD = "gspn_quad_fwd"

SMEM_MAX = 232_448   # shared memory one CTA may use on the H100, bytes
RING_ROWS = 64       # ring depth cap: enough rows ahead to cover HBM latency
BATCHES = 4          # batches a ring is cut into when the plane does not fit
COPY_WARPS = 8       # warps that issue the ring's copies, at the least
# Warps per CTA that the register budget allows at K columns per lane (the
# kernels' __launch_bounds__, two rows of operands in registers): 64
# registers a thread at 1024 threads, 128 at 512, 255 at 256 and 128.
_MAX_WARPS = {1: 32, 2: 16, 4: 16, 8: 8, 16: 4, 32: 4}


class PairLaunch(NamedTuple):
    """Launch shape of a pair kernel (``csrc/gspn_pair.cu``).

    ``planes``: planes per CTA, one warp each; ``warps``: warps per CTA
    (``planes`` or more: every warp issues ring copies); ``k``: columns
    per lane (a power of two, ``32·k >= W``); ``splits``: CTAs per weight
    group; ``stages``: ring depth S in rows, ``nbuf`` batches of
    ``batch`` rows; ``grid``: (G_w, splits, 2), the weight group, the
    part of the group and the direction; ``smem_bytes``: the ring's
    dynamic shared memory."""
    planes: int
    warps: int
    k: int
    splits: int
    stages: int
    batch: int
    nbuf: int
    grid: tuple[int, int, int]
    smem_bytes: int


def _region_bytes(rows: int, w: int, item: int) -> int:
    """Bytes of one (array, batch) region of the ring, as ``region_bytes``
    in the source: ``rows`` rows of W items placed at their source's offset
    within its 16-byte block and widened to whole words, in 16-byte units."""
    return (rows * w * item + 18 + 15) // 16 * 16


def pair_launch_shape(g: int, h: int, w: int, cpw: int, dtype: torch.dtype,
                      direction: str) -> PairLaunch:
    """The launch shape of the pair forward (``direction="fwd"``) or
    adjoint (``"bwd"``) on (g, h, w) planes with ``cpw`` planes per
    weight group, derived from the shape alone.

    A warp per plane of the group, as many as the registers at ``k``
    columns per lane allow and as leave two ring rows in shared memory (a
    larger group splits evenly over CTAs), and at least ``COPY_WARPS``
    warps, which all issue copies.  The ring holds the whole plane (S = H,
    one batch, one barrier) when it fits in ``RING_ROWS`` rows and the
    shared memory; otherwise S = min(H, 64) rows or as many as fit, cut
    into ``BATCHES`` batches of ``ceil(S / BATCHES)`` rows (S rounded down
    to whole batches), refilled as the walk goes."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', not "
                         f"{direction!r}")
    item = torch.empty((), dtype=dtype).element_size()
    per_plane = 2 if direction == "fwd" else 1
    k = 1 << max(0, math.ceil(w / 32) - 1).bit_length()

    def ring_bytes(planes, batch, nbuf):
        return nbuf * (3 + per_plane * planes) * _region_bytes(batch, w, item)

    planes = min(cpw, _MAX_WARPS[k])
    while planes > 1 and ring_bytes(planes, 1, min(h, 2)) > SMEM_MAX:
        planes -= 1
    splits = -(-cpw // planes)
    planes = -(-cpw // splits)
    if h <= RING_ROWS and ring_bytes(planes, h, 1) <= SMEM_MAX:
        batch, nbuf = h, 1
    else:
        rows = min(h, RING_ROWS)
        while True:
            batch = -(-rows // BATCHES)
            nbuf = rows // batch
            if ring_bytes(planes, batch, nbuf) <= SMEM_MAX:
                break
            rows -= 1
    return PairLaunch(planes=planes,
                      warps=max(planes, min(COPY_WARPS, _MAX_WARPS[k])),
                      k=k, splits=splits, stages=nbuf * batch, batch=batch,
                      nbuf=nbuf, grid=(g // cpw, splits, 2),
                      smem_bytes=ring_bytes(planes, batch, nbuf))


def _launch_pair(name, kind, planes, taps, chunk):
    """Check a pair launch's operands (``planes``: (name, tensor, leading
    axes) as :func:`~repro_torch.kernels.gspn_scan._check` takes them, the
    first x or dy) and launch the kernel of ``kind`` on the current
    stream.  Returns the output, (2, G, H, W)."""
    cpw, chunk = _check(2, planes, taps, chunk)
    first = planes[0][1]
    g, h, w = first.shape[-3:]
    out_dtype = first.dtype if kind == "fwd" else torch.float32
    out = torch.empty((2, g, h, w), dtype=out_dtype, device=first.device)
    if out.numel() == 0:
        return out
    shape = pair_launch_shape(g, h, w, cpw, first.dtype, kind)
    lib = cuda_lib.library("gspn_pair")
    entry = lib.gspn_pair_launch if kind == "fwd" else lib.gspn_pair_bwd_launch
    ptrs = [t.data_ptr() for _, t, _ in planes[:1]] + \
        [t.data_ptr() for t in taps] + \
        [t.data_ptr() for _, t, _ in planes[1:]] + [out.data_ptr()]
    with _span(name, g, h, w, first.dtype), torch.cuda.device(first.device):
        err = entry(_DTYPE_CODES[first.dtype], *ptrs, g, h, w, cpw, chunk,
                    shape.planes, shape.warps, shape.k, shape.splits,
                    shape.batch,
                    shape.nbuf, shape.smem_bytes,
                    torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, err, name)
    _count(name, g, h, w, first.dtype)
    return out


def launch_pair(x, wl2, wc2, wr2, lam2, chunk) -> torch.Tensor:
    """The pair forward kernel on checked operands (the shapes of
    :func:`gspn_scan_bidir`)."""
    return _launch_pair(KERNEL, "fwd", [("x", x, ()), ("lam", lam2, (2,))],
                        (wl2, wc2, wr2), chunk)


def launch_pair_bwd(dy2, wl2, wc2, wr2, chunk) -> torch.Tensor:
    """The pair adjoint kernel on checked operands (the shapes of
    :func:`gspn_scan_bidir_bwd`)."""
    return _launch_pair(KERNEL_BWD, "bwd", [("dy", dy2, (2,))],
                        (wl2, wc2, wr2), chunk)


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
    return launch_pair(x, wl2, wc2, wr2, lam2, chunk)


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
    return launch_pair_bwd(dy2, wl2, wc2, wr2, chunk)


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
    return launch_quad(torch.stack([x, x.transpose(-1, -2)]), wl4, wc4, wr4,
                       lam4)


def launch_quad(xx, wl4, wc4, wr4, lam4):
    """The quad kernel alone on x already stacked with its transpose,
    xx: (2, G, N, N), contiguous; the other operands as
    :func:`gspn_scan_quad` takes them."""
    return launch(4, KERNEL_QUAD, xx, wl4, wc4, wr4, lam4, None)


def gspn_scan_quad_torch(x, wl4, wc4, wr4, lam4):
    """Plain PyTorch version of :func:`gspn_scan_quad`, on any device: f32
    arithmetic and carry (f64 for f64 operands), output in x.dtype."""
    cuda_lib.plain_calls[KERNEL_QUAD] += 1
    cd = compute_dtype(x.dtype)
    return ref.gspn_scan_quad_ref(
        *(a.to(cd) for a in (x, wl4, wc4, wr4, lam4))).to(x.dtype)
