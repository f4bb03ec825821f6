"""Single-direction line scan and its adjoint on the card (CUDA,
``sm_90a``), and the launch of the forward scan template.

:func:`gspn_scan_fwd` replaces the Pallas kernel
``src/repro/kernels/gspn_scan.py:gspn_scan_fwd_pallas``: the top-to-bottom
scan over (G, H, W) with compact weights indexed ``g // cpw``, the
GSPN-local carry reset every ``chunk`` rows, an f32 carry and the output
in the stream dtype.  It is the D = 1 instance of ``gspn_fwd_kernel`` in
``csrc/gspn_pair.cu``, the forward template whose D = 2 and D = 4
instances are the pair and the quad (:mod:`~repro_torch.kernels.
gspn_multidir`); :func:`gspn_scan_fwd_torch` is its plain version.

:func:`gspn_scan_bwd` replaces ``gspn_scan_bwd_pallas`` (same file): the
adjoint walk from the last row to the first with three f32 product rows,
the same chunk reset, an f32 output, and no flipped copies of its
operands.  Its kernel is the last one of the port's first design (a CTA
per plane, a thread per column, the next row prefetched into registers, a
barrier per row, ``csrc/gspn_scan.cu``); moving it onto the template's
design is the next step.  :func:`gspn_scan_bwd_torch` is its plain
version.

Bound.  Each input is read once and the output written once: per (g,h,w)
element the forward moves x, lam and out (one stream item each) and the
three taps (``3 / cpw`` items), 18 bytes in f32 at cpw = 2, 7.2 / 1.8 /
0.45 / 0.11 MB per launch at batch 64 and W = 56 / 28 / 14 / 7, about 2.16
/ 0.54 / 0.135 / 0.034 us at the H100's 3.35 TB/s; the adjoint moves dy,
the taps and an f32 g, 14 bytes.  The operations (7 per element forward,
9 adjoint) are far below the card's rate, so bytes set the floor; but
every row depends on the previous one, so each kernel runs a chain of H
dependent row steps.

The forward template (the source's note says why each choice): one CTA
per (weight group, direction) with one warp per plane of the group and at
least eight warps that issue copies; each lane keeps the carry of columns
``l, l+32, ...`` in registers and takes its neighbours by warp shuffle,
with no barrier per row; the group's tap rows are staged once for all its
planes, with each plane's streamed rows, by ``cp.async`` into a
shared-memory ring that holds the whole plane at the main widths (one
batch, one barrier) and streams taller planes in four batches.
:func:`pair_launch_shape` chooses the launch shape from the operands'
shape and the direction count alone, and :func:`launch` launches the
template for 1, 2 or 4 directions.

Every launch (:func:`launch`, :func:`launch_bwd`, and the pair adjoint's
launch in :mod:`~repro_torch.kernels.gspn_multidir`) enters the
``kernel.launch`` span of DESIGN.md §13 with the reference's attributes
``kernel``, ``dtype``, ``g``, ``h`` and ``w``; the reference's
``row_tile`` and ``pipeline_depth`` are left out, since the port's launch
shapes are not the Pallas launch plan.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import cuda_lib, ref

KERNEL = "gspn_scan_fwd"
KERNEL_BWD = "gspn_scan_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Widest row the kernels take: one thread per column in the single
# adjoint, at most 1024 threads per CTA; the template's lanes hold up to 32
# columns each.
_MAX_W = 1024

SMEM_MAX = 232_448   # shared memory one CTA may use on the H100, bytes
RING_ROWS = 64       # ring depth cap: enough rows ahead to cover HBM latency
BATCHES = 4          # batches a ring is cut into when the plane does not fit
COPY_WARPS = 8       # warps that issue the ring's copies, at the least
SMS = 132            # streaming multiprocessors of the H100 SXM
# Warps per CTA that the register budget allows at K columns per lane (the
# kernels' __launch_bounds__, two rows of operands in registers): 64
# registers a thread at 1024 threads, 128 at 512, 255 at 256 and 128.
_MAX_WARPS = {1: 32, 2: 16, 4: 16, 8: 8, 16: 4, 32: 4}


def chunk_arg(h: int, chunk: int | None) -> int:
    """The kernel's ``chunk`` argument: 0 for one segment of H rows."""
    if chunk is None or chunk == h:
        return 0
    if not isinstance(chunk, int) or chunk < 1 or h % chunk:
        raise ValueError(f"chunk={chunk!r} must be a positive divisor of "
                         f"H={h}")
    return chunk


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Arithmetic dtype of the plain versions: float32, or float64 for
    float64 operands (``torch.autograd.gradcheck``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class PairLaunch(NamedTuple):
    """Launch shape of a kernel of ``csrc/gspn_pair.cu``.

    ``planes``: planes per CTA, one warp each; ``warps``: warps per CTA
    (``planes`` or more: every warp issues ring copies); ``k``: columns
    per lane (a power of two, ``32·k >= W``); ``splits``: CTAs per weight
    group; ``stages``: ring depth S in rows, ``nbuf`` batches of
    ``batch`` rows; ``grid``: (G_w, splits, D), the weight group, the
    part of the group and the direction; ``smem_bytes``: the ring's
    dynamic shared memory; ``xpitch``: for the quad (D = 4), the pitch in
    4-byte words of the column slab from which its transposed directions
    read x, else 0."""
    planes: int
    warps: int
    k: int
    splits: int
    stages: int
    batch: int
    nbuf: int
    grid: tuple[int, int, int]
    smem_bytes: int
    xpitch: int = 0


def _region_bytes(rows: int, w: int, item: int) -> int:
    """Bytes of one (array, batch) region of the ring, as ``region_bytes``
    in the source: ``rows`` rows of W items placed at their source's offset
    within its 16-byte block and widened to whole words, in 16-byte units."""
    return (rows * w * item + 18 + 15) // 16 * 16


def _slab_words(rows: int, item: int) -> int:
    """4-byte words one column-slab run of ``rows`` items may cover, as
    ``slab_words`` in the source (a bf16 run may start mid-word)."""
    return (rows * item + (2 if item < 4 else 0) + 3) // 4


def ring_bytes(direction: str, ndir: int, w: int, item: int, planes: int,
               batch: int, nbuf: int, xpitch: int = 0) -> int:
    """Shared bytes of a ring of ``nbuf`` stages of ``batch`` rows, as the
    source lays a stage out: the three tap regions and per plane its dy
    region (``"bwd"``) or its x and lam regions (``"fwd"``), every region
    of the quad sized for the larger of its rows and a column slab of W
    runs at ``xpitch`` words (``fwd_region_bytes`` in the source)."""
    rb = _region_bytes(batch, w, item)
    if direction == "bwd":
        return nbuf * (3 + planes) * rb
    if ndir == 4:
        rb = max(rb, (w * xpitch * 4 + 15) // 16 * 16)
    return nbuf * (3 + 2 * planes) * rb


def pair_launch_shape(g: int, h: int, w: int, cpw: int, dtype: torch.dtype,
                      direction: str, ndir: int = 2) -> PairLaunch:
    """The launch shape of the forward over ``ndir`` directions (1, 2 or
    4; ``direction="fwd"``) or of the pair adjoint (``"bwd"``, ndir 2) on
    (g, h, w) planes with ``cpw`` planes per weight group, derived from
    the shape alone.

    A warp per plane of the group, as many as the registers at ``k``
    columns per lane allow and as leave two ring rows in shared memory (a
    larger group splits evenly over CTAs), and at least ``COPY_WARPS``
    warps, which all issue copies.  The ring holds the whole plane (S = H,
    one batch, one barrier) when it fits in ``RING_ROWS`` rows and the
    shared memory; otherwise S = min(H, 64) rows or as many as fit, cut
    into ``BATCHES`` batches of ``ceil(S / BATCHES)`` rows (S rounded down
    to whole batches), refilled as the walk goes.  The quad takes fewer
    planes per CTA while its grid would hold fewer CTAs than the card has
    SMs, and its slab pitch is the words a run of a batch may cover, made
    odd so that the 32 lanes of a step read 32 banks."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', not "
                         f"{direction!r}")
    if ndir not in (1, 2, 4) or (direction == "bwd" and ndir != 2):
        raise ValueError(f"ndir={ndir}: the forward runs 1, 2 or 4 "
                         f"directions, the adjoint 2")
    item = torch.empty((), dtype=dtype).element_size()
    k = 1 << max(0, math.ceil(w / 32) - 1).bit_length()

    def pitch(batch):
        return _slab_words(batch, item) | 1 if ndir == 4 else 0

    def fits(planes, batch, nbuf):
        return ring_bytes(direction, ndir, w, item, planes, batch, nbuf,
                          pitch(batch)) <= SMEM_MAX

    planes = min(cpw, _MAX_WARPS[k])
    while planes > 1 and not fits(planes, 1, min(h, 2)):
        planes -= 1
    # The quad spreads a group's planes over CTAs while whole groups would
    # leave SMs without a CTA (1024², G = 32: 128 CTAs of one plane took
    # 118 us on the H100, 64 of two 182; tools/pair_launch_sweep.py).
    while ndir == 4 and planes > 1 and \
            g // cpw * -(-cpw // planes) * ndir < SMS:
        planes -= 1
    splits = -(-cpw // planes)
    planes = -(-cpw // splits)
    if h <= RING_ROWS and fits(planes, h, 1):
        batch, nbuf = h, 1
    else:
        rows = min(h, RING_ROWS)
        while True:
            batch = -(-rows // BATCHES)
            nbuf = rows // batch
            if fits(planes, batch, nbuf):
                break
            rows -= 1
    return PairLaunch(
        planes=planes, warps=max(planes, min(COPY_WARPS, _MAX_WARPS[k])),
        k=k, splits=splits, stages=nbuf * batch, batch=batch, nbuf=nbuf,
        grid=(g // cpw, splits, ndir),
        smem_bytes=ring_bytes(direction, ndir, w, item, planes, batch, nbuf,
                              pitch(batch)),
        xpitch=pitch(batch))


def _lead(ndir: int) -> tuple[int, ...]:
    """Leading direction axes of the per-direction operands."""
    return () if ndir == 1 else (ndir,)


def _check(ndir: int, planes, taps, chunk) -> tuple[int, int]:
    """Check one ``ndir``-direction launch's operands and return (cpw, the
    kernel's chunk argument).  ``planes``: (name, tensor, leading axes)
    triples of tensors shaped leading axes + (G, H, W), G, H and W read
    from the first; ``taps``: wl, wc, wr, each (G_w, H, W), or
    (ndir, G_w, H, W) for the pair and the quad."""
    lead = _lead(ndir)
    name0, first, lead0 = planes[0]
    if first.dim() != len(lead0) + 3:
        raise ValueError(f"{name0} must be {lead0 + ('G', 'H', 'W')}, got "
                         f"{tuple(first.shape)}")
    g, h, w = first.shape[len(lead0):]
    wl = taps[0]
    if wl.dim() != len(lead) + 3:
        raise ValueError(f"taps must be {lead + ('G_w', 'H', 'W')}, got "
                         f"{tuple(wl.shape)}")
    gw = wl.shape[len(lead)]
    named = [(nm, t, pl + (g, h, w)) for nm, t, pl in planes]
    named += [(nm, t, lead + (gw, h, w)) for nm, t in zip(("wl", "wc", "wr"),
                                                          taps)]
    for nm, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{nm} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if gw < 1 or g % gw:
        raise ValueError(f"G={g} is not a multiple of G_w={gw}")
    if first.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA scan streams float32 or bfloat16, not "
                         f"{first.dtype}")
    for _, t, _ in named:
        if t.device != first.device:
            raise ValueError(f"operands on {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise ValueError(f"operands of dtype {t.dtype} and "
                             f"{first.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA scan needs contiguous operands")
    if w > _MAX_W:
        raise ValueError(f"W={w} exceeds {_MAX_W} columns per CTA")
    return g // gw, chunk_arg(h, chunk)


def _count(name: str, g: int, h: int, w: int, dtype: torch.dtype) -> None:
    cuda_lib.launch_counts[name] += 1
    cuda_lib.launch_shapes[(name, g, h, w,
                            str(dtype).removeprefix("torch."))] += 1


def _span(name: str, g: int, h: int, w: int, dtype: torch.dtype):
    if not obs.enabled():  # no attributes to format on the eager path
        return obs.NOOP_SPAN
    return obs.trace("kernel.launch", kernel=name,
                     dtype=str(dtype).removeprefix("torch."), g=g, h=h, w=w)


def launch(ndir: int, name: str, x, wl, wc, wr, lam, chunk) -> torch.Tensor:
    """Check the operands of one forward scan over ``ndir`` directions (1,
    2 or 4) and launch that instance of the template on the current
    stream, counted and traced as ``name``.  Shapes: x (G,H,W); taps
    (G_w,H,W), or (ndir,G_w,H,W); lam (G,H,W), or (ndir,G,H,W).  The quad
    (4) needs a square grid and no chunk."""
    if ndir not in (1, 2, 4):
        raise ValueError(f"ndir={ndir}: the forward template runs 1, 2 or 4 "
                         f"directions")
    lead = _lead(ndir)
    cpw, chunk = _check(ndir, [("x", x, ()), ("lam", lam, lead)],
                        (wl, wc, wr), chunk)
    g, h, w = x.shape
    if ndir == 4 and (h != w or chunk):
        raise ValueError(f"the quad scan is one-shot on a square grid, got "
                         f"H={h}, W={w}, chunk={chunk}")
    out = torch.empty(lead + (g, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    s = pair_launch_shape(g, h, w, cpw, x.dtype, "fwd", ndir)
    lib = cuda_lib.library("gspn_pair")
    with _span(name, g, h, w, x.dtype), torch.cuda.device(x.device):
        err = lib.gspn_fwd_launch(
            ndir, _DTYPE_CODES[x.dtype], x.data_ptr(), wl.data_ptr(),
            wc.data_ptr(), wr.data_ptr(), lam.data_ptr(), out.data_ptr(),
            g, h, w, cpw, chunk, s.planes, s.warps, s.k, s.splits, s.batch,
            s.nbuf, s.xpitch, s.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, err, name)
    _count(name, g, h, w, x.dtype)
    return out


def launch_bwd(name: str, dy, wl, wc, wr, chunk) -> torch.Tensor:
    """Check the operands of one single-direction adjoint walk and launch
    the kernel on the current stream.  Shapes: dy (G,H,W); taps
    (G_w,H,W).  Returns g in float32, dy's shape."""
    cpw, chunk = _check(1, [("dy", dy, ())], (wl, wc, wr), chunk)
    g, h, w = dy.shape
    out = torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library("gspn_scan")
    with _span(name, g, h, w, dy.dtype), torch.cuda.device(dy.device):
        err = lib.gspn_scan_bwd_launch(
            _DTYPE_CODES[dy.dtype], dy.data_ptr(), wl.data_ptr(),
            wc.data_ptr(), wr.data_ptr(), out.data_ptr(), g, h, w, cpw,
            chunk, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, err, name)
    _count(name, g, h, w, dy.dtype)
    return out


def gspn_scan_fwd(x, wl, wc, wr, lam, *, chunk: int | None = None):
    """Forward line scan.  x, lam: (G, H, W); wl/wc/wr: (G_w, H, W) with
    G_w dividing G.  Returns h: (G, H, W) in x.dtype.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`gspn_scan_fwd_torch`."""
    if not x.is_cuda:
        return gspn_scan_fwd_torch(x, wl, wc, wr, lam, chunk=chunk)
    return launch(1, KERNEL, x, wl, wc, wr, lam, chunk)


def gspn_scan_fwd_torch(x, wl, wc, wr, lam, *, chunk: int | None = None):
    """Plain PyTorch version of :func:`gspn_scan_fwd`, on any device: f32
    arithmetic and carry (f64 for f64 operands), output in x.dtype."""
    cuda_lib.plain_calls[KERNEL] += 1
    cd = compute_dtype(x.dtype)
    args = tuple(a.to(cd) for a in (x, wl, wc, wr, lam))
    if chunk_arg(x.shape[1], chunk):
        out = ref.gspn_scan_chunked_ref(*args, chunk)
    else:
        out = ref.gspn_scan_ref(*args)
    return out.to(x.dtype)


def gspn_scan_bwd(dy, wl, wc, wr, *, chunk: int | None = None):
    """Adjoint of :func:`gspn_scan_fwd`: g = dL/dh from dy (G, H, W) and
    the forward's taps (G_w, H, W), walking rows H-1..0 with the carry
    reset every ``chunk`` rows.  Returns g: (G, H, W) in float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`gspn_scan_bwd_torch`."""
    if not dy.is_cuda:
        return gspn_scan_bwd_torch(dy, wl, wc, wr, chunk=chunk)
    return launch_bwd(KERNEL_BWD, dy, wl, wc, wr, chunk)


def gspn_scan_bwd_torch(dy, wl, wc, wr, *, chunk: int | None = None):
    """Plain PyTorch version of :func:`gspn_scan_bwd`, on any device: f32
    arithmetic, carry and output (f64 for f64 operands)."""
    cuda_lib.plain_calls[KERNEL_BWD] += 1
    cd = compute_dtype(dy.dtype)
    return ref.gspn_scan_adjoint_ref(
        *(a.to(cd) for a in (dy, wl, wc, wr)), reverse=True,
        chunk=chunk_arg(dy.shape[1], chunk))
