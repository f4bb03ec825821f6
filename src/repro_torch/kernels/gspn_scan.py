"""Single-direction line scan and its adjoint on the card (CUDA,
``sm_90a``), and the launch of the forward and adjoint templates.

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
operands.  It is the D = 1 instance of ``gspn_bwd_kernel``, the adjoint
template in the same source, whose D = 2 instance is the pair's adjoint;
a row of more than 128 columns is spread over several warps of the CTA:
on a plane of at most 16 rows each warp walks a window of 64 or 128
columns straight from device memory, four rows ahead, and stores its
middle (a product travels at most H columns in H rows); on a taller plane
the warps share the row from the ring in bands, their edge products
crossing through shared memory under a named barrier each row.
:func:`gspn_scan_bwd_torch` is its plain version.

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
shape and the direction count alone, the static heuristic of the tuner
(:mod:`~repro_torch.kernels.autotune`), which may hold a shape measured
faster on this card; :func:`plan` asks it.  :func:`launch` launches the
forward template for 1, 2 or 4 directions and :func:`launch_bwd` the
adjoint template for 1 or 2.

Every launch (:func:`launch`, :func:`launch_bwd`) enters the
``kernel.launch`` span of DESIGN.md §13 with the reference's attributes
``kernel``, ``dtype``, ``g``, ``h`` and ``w``; the reference's
``row_tile`` and ``pipeline_depth`` are left out, since the port's launch
shapes are not the Pallas launch plan.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import cuda_lib, ref
from repro_torch.kernels.spec import ScanSpec

KERNEL = "gspn_scan_fwd"
KERNEL_BWD = "gspn_scan_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Widest row the kernels take: 32 columns a lane (K = 32, the templates'
# largest instance) on one warp.
_MAX_W = 1024

SMEM_MAX = 232_448   # shared memory one CTA may use on the H100, bytes
RING_ROWS = 64       # ring depth cap: enough rows ahead to cover HBM latency
BATCHES = 4          # batches a ring is cut into when the plane does not fit
COPY_WARPS = 8       # warps that issue the ring's copies, at the least
# The single adjoint's rows wider than 128 columns:
BANDS = 8            # warps that share a row from the ring
DIRECT_ROWS = 16     # planes of at most this many rows: windows, no ring
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
    read x, else 0; ``bands``: warps that share a plane, each a band of
    ``32·k`` columns (the single adjoint at wide rows), else 1;
    ``direct``: the ``bands`` warps of a plane each walk a window of
    ``32·k`` columns from device memory and store its middle ``32·k −
    2H``, no ring (``batch`` = H, ``nbuf`` = 1, no shared memory); the
    grid's y axis is then (group of windows, split)."""
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
    bands: int = 1
    direct: bool = False


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


def edge_bytes(warps: int) -> int:
    """Shared bytes after the ring of the banded adjoint: Pl and Pr of each
    warp's band edge for two row parities (``edge_bytes`` in the source)."""
    return 2 * 2 * 4 * warps


def pair_launch_shape(g: int, h: int, w: int, cpw: int, dtype: torch.dtype,
                      direction: str, ndir: int = 2, *,
                      bands: int | None = None,
                      direct: bool | None = None,
                      window_k: int | None = None) -> PairLaunch:
    """The launch shape of the forward over ``ndir`` directions (1, 2 or
    4; ``direction="fwd"``) or of the adjoint over 1 or 2 (``"bwd"``) on
    (g, h, w) planes with ``cpw`` planes per weight group, derived from
    the shape alone.

    A warp per plane of the group, as many as the registers at ``k``
    columns per lane allow and as leave two ring rows in shared memory (a
    larger group splits evenly over CTAs), and at least ``COPY_WARPS``
    warps, which all issue copies.  The ring holds the whole plane (S = H,
    one batch, one barrier) when it fits in ``RING_ROWS`` rows and the
    shared memory; otherwise S = min(H, 64) rows or as many as fit, cut
    into ``BATCHES`` batches of ``ceil(S / BATCHES)`` rows (S rounded down
    to whole batches), refilled as the walk goes.  The quad and the single
    adjoint take fewer planes per CTA while their grid would hold fewer
    CTAs than the card has SMs; the quad's slab pitch is the words a run
    of a batch may cover, made odd so that the 32 lanes of a step read 32
    banks.

    The single adjoint spreads a row that would take 8 or more columns per
    lane (W > 128) over warps.  On a plane of at most ``DIRECT_ROWS`` rows
    (``direct``) warps walk windows straight from device memory, with no
    ring, each storing its middle (the window less a halo of H columns at
    each end); a window is 64 columns, or 128 where the two halos would
    take more than a quarter of 64.  A CTA takes ``bands`` windows of a
    row, as many as the registers allow, the row's windows split evenly
    over CTAs.  On a taller plane ``BANDS`` warps share the row from the
    ring, each a band of it.  ``bands``, ``direct`` and ``window_k`` (the
    windows' columns per lane) ask for a layout instead (the sweep)."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', not "
                         f"{direction!r}")
    if ndir not in ((1, 2, 4) if direction == "fwd" else (1, 2)):
        raise ValueError(f"ndir={ndir}: the forward runs 1, 2 or 4 "
                         f"directions, the adjoint 1 or 2")
    single_bwd = direction == "bwd" and ndir == 1
    item = torch.empty((), dtype=dtype).element_size()
    k = 1 << max(0, math.ceil(w / 32) - 1).bit_length()
    if direct is None:
        direct = bands is None and window_k is None and single_bwd and \
            k >= 8 and h <= DIRECT_ROWS
    groups = 1  # CTAs that share a row's windows
    if direct:
        k = window_k or (2 if 8 * h <= 64 else 4)
        tile = 32 * k - 2 * h
        if not (single_bwd and k in (1, 2, 4) and tile >= 1
                and (bands or 1) <= _MAX_WARPS[k]):
            raise ValueError(f"direct: only the single adjoint walks "
                             f"windows of 32, 64 or 128 columns from device "
                             f"memory, wider than 2H = {2 * h}, at most "
                             f"{_MAX_WARPS.get(k)} to a CTA")
        windows = -(-w // tile)
        groups = -(-windows // (bands or min(windows, _MAX_WARPS[k])))
        bands = bands or -(-windows // groups)
    else:
        if window_k is not None:
            raise ValueError("window_k: only direct windows have it")
        if bands is None:
            bands = BANDS if single_bwd and k >= 8 else 1
        if bands != 1 and not (single_bwd and bands in _MAX_WARPS
                               and 1 <= k // bands <= 4):
            raise ValueError(f"bands={bands}: only the single adjoint "
                             f"spreads a row over warps, at 1 to 4 columns "
                             f"per lane")
        k //= bands

    def pitch(batch):
        return _slab_words(batch, item) | 1 if ndir == 4 else 0

    def warps(planes):
        if direct:
            return planes * bands
        return max(planes * bands, min(COPY_WARPS, _MAX_WARPS[k]))

    def size(planes, batch, nbuf):
        if direct:
            return 0
        edges = edge_bytes(warps(planes)) if bands > 1 else 0
        return ring_bytes(direction, ndir, w, item, planes, batch, nbuf,
                          pitch(batch)) + edges

    def fits(planes, batch, nbuf):
        return size(planes, batch, nbuf) <= SMEM_MAX

    # A banded plane waits at a named barrier of its own, 1..15.
    planes = min(cpw, _MAX_WARPS[k] // bands,
                 15 if bands > 1 and not direct else 32)
    while planes > 1 and not fits(planes, 1, min(h, 2)):
        planes -= 1
    # The quad and the single adjoint spread a group's planes over CTAs
    # while whole groups would leave SMs without a CTA (the quad at 1024²,
    # G = 32: 128 CTAs of one plane took 118 us on an H100 80GB HBM3 at
    # 700 W, 64 of two 182; tools/pair_launch_sweep.py).
    while (ndir == 4 or single_bwd) and planes > 1 and \
            g // cpw * -(-cpw // planes) * groups * ndir < SMS:
        planes -= 1
    splits = -(-cpw // planes)
    planes = -(-cpw // splits)
    if direct or (h <= RING_ROWS and fits(planes, h, 1)):
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
        planes=planes, warps=warps(planes), k=k, splits=splits,
        stages=nbuf * batch, batch=batch, nbuf=nbuf,
        grid=(g // cpw, splits * groups, ndir),
        smem_bytes=size(planes, batch, nbuf), xpitch=pitch(batch),
        bands=bands, direct=direct)


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


def _count(name: str, g: int, h: int, w: int, dtype: torch.dtype,
           boundary: str = "one_shot") -> None:
    with cuda_lib._COUNT_LOCK:
        cuda_lib.launch_counts[name] += 1
        cuda_lib.launch_shapes[(name, g, h, w,
                                str(dtype).removeprefix("torch."))] += 1
        cuda_lib.launch_boundaries[(name, boundary)] += 1


# Operations per output element: the scan does 4 multiplies and 3 adds,
# the adjoint 6 multiplies and 3 adds.
OPS_PER_ELEMENT = {"fwd": 7, "bwd": 9}


def launch_cost(kind: str, ndir: int, g: int, h: int, w: int, cpw: int,
                dtype: torch.dtype) -> tuple[int, int]:
    """(bytes, operations) of one launch of the ``kind`` template ("fwd"
    or "bwd") over ``ndir`` directions on (G, H, W) planes with G // cpw
    weight planes, streaming ``dtype``: each input read once and each
    output written once.  The forward reads x (G, H, W) once, the taps
    (ndir, G_w, H, W) and lam (ndir, G, H, W), and writes out (ndir, G,
    H, W) in ``dtype``; the adjoint reads dy (ndir, G, H, W) and the taps
    and writes g (ndir, G, H, W) in float32.  The one count of a launch's
    work: ``chip_smoke.py``'s kernel bounds and the roofline's kernel
    records (``roofline.cost``) both read it."""
    item = dtype.itemsize
    plane = g * h * w
    taps = 3 * ndir * (g // cpw) * h * w * item
    if kind == "fwd":
        nbytes = plane * item + taps + 2 * ndir * plane * item
    else:
        nbytes = ndir * plane * item + taps + ndir * plane * 4
    return nbytes, OPS_PER_ELEMENT[kind] * ndir * plane


def _record_meta(name, kind, ndir, g, h, w, cpw, dtype, boundary, out):
    """The launch a ``meta`` operand stands for: recorded, not run
    (``cuda_lib.meta_launches``); ``out`` is returned empty."""
    nbytes, ops = launch_cost(kind, ndir, g, h, w, cpw, dtype)
    cuda_lib.record_meta(kernel=name, kind=kind, ndir=ndir, g=g, h=h, w=w,
                         cpw=cpw, dtype=str(dtype).removeprefix("torch."),
                         boundary=boundary, bytes=nbytes, ops=ops)
    return out


def _span(name: str, g: int, h: int, w: int, dtype: torch.dtype):
    if not obs.enabled():  # no attributes to format on the eager path
        return obs.NOOP_SPAN
    return obs.trace("kernel.launch", kernel=name,
                     dtype=str(dtype).removeprefix("torch."), g=g, h=h, w=w)


# The spec direction of each template instance: (kind, D) -> direction.
DIRECTION = {("fwd", 1): "fwd", ("fwd", 2): "pair_fwd", ("fwd", 4): "quad",
             ("bwd", 1): "bwd", ("bwd", 2): "pair_bwd"}


@functools.lru_cache(maxsize=256)
def _spec(kind: str, ndir: int, cpw: int, dtype: torch.dtype,
          boundary: str) -> ScanSpec:
    return ScanSpec(direction=DIRECTION[kind, ndir], impl="cuda",
                    channels_per_weight=cpw, stream_dtype=dtype,
                    boundary=boundary)


def plan(kind: str, ndir: int, g: int, h: int, w: int, cpw: int,
         dtype: torch.dtype, device, *, boundary: str = "one_shot",
         shape: PairLaunch | None = None) -> PairLaunch:
    """The launch shape of one launch, from the tuner
    (``autotune.plan_for_spec``): ``shape`` if given, else a valid entry of
    the tuning cache for this card, else :func:`pair_launch_shape`."""
    from repro_torch.kernels import autotune
    return autotune.plan_for_spec(_spec(kind, ndir, cpw, dtype, boundary),
                                  g, h, w, device=autotune.device_kind(device),
                                  launch=shape)


def launch(ndir: int, name: str, x, wl, wc, wr, lam, chunk, *,
           boundary: str = "one_shot",
           shape: PairLaunch | None = None) -> torch.Tensor:
    """Check the operands of one forward scan over ``ndir`` directions (1,
    2 or 4) and launch that instance of the template on the current
    stream, counted and traced as ``name``.  Shapes: x (G,H,W); taps
    (G_w,H,W), or (ndir,G_w,H,W); lam (G,H,W), or (ndir,G,H,W).  The quad
    (4) needs a square grid and no chunk.  The launch shape is
    :func:`plan`'s (``boundary`` names the scan for the tuning cache;
    ``shape`` asks for one)."""
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
    if x.is_meta:
        return _record_meta(name, "fwd", ndir, g, h, w, cpw, x.dtype,
                            boundary, out)
    s = plan("fwd", ndir, g, h, w, cpw, x.dtype, x.device,
             boundary=boundary, shape=shape)
    lib = cuda_lib.library("gspn_pair")
    with _span(name, g, h, w, x.dtype), torch.cuda.device(x.device):
        err = lib.gspn_fwd_launch(
            ndir, _DTYPE_CODES[x.dtype], x.data_ptr(), wl.data_ptr(),
            wc.data_ptr(), wr.data_ptr(), lam.data_ptr(), out.data_ptr(),
            g, h, w, cpw, chunk, s.planes, s.warps, s.k, s.splits, s.batch,
            s.nbuf, s.xpitch, s.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, err, name)
    _count(name, g, h, w, x.dtype, boundary)
    return out


def launch_bwd(ndir: int, name: str, dy, wl, wc, wr, chunk, *,
               boundary: str = "one_shot",
               shape: PairLaunch | None = None) -> torch.Tensor:
    """Check the operands of one adjoint walk over ``ndir`` directions (1
    or 2) and launch that instance of the adjoint template on the current
    stream, counted and traced as ``name``.  Shapes: dy (G,H,W), or
    (2,G,H,W); taps (G_w,H,W), or (2,G_w,H,W).  Returns g in float32,
    dy's shape.  The launch shape is :func:`plan`'s."""
    if ndir not in (1, 2):
        raise ValueError(f"ndir={ndir}: the adjoint template runs 1 or 2 "
                         f"directions")
    cpw, chunk = _check(ndir, [("dy", dy, _lead(ndir))], (wl, wc, wr), chunk)
    g, h, w = dy.shape[-3:]
    out = torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
    if out.numel() == 0:
        return out
    if dy.is_meta:
        return _record_meta(name, "bwd", ndir, g, h, w, cpw, dy.dtype,
                            boundary, out)
    s = plan("bwd", ndir, g, h, w, cpw, dy.dtype, dy.device,
             boundary=boundary, shape=shape)
    lib = cuda_lib.library("gspn_pair")
    with _span(name, g, h, w, dy.dtype), torch.cuda.device(dy.device):
        err = lib.gspn_bwd_launch(
            ndir, _DTYPE_CODES[dy.dtype], dy.data_ptr(), wl.data_ptr(),
            wc.data_ptr(), wr.data_ptr(), out.data_ptr(), g, h, w, cpw,
            chunk, s.planes, s.warps, s.k, s.splits, s.batch, s.nbuf,
            s.bands, int(s.direct), s.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, err, name)
    _count(name, g, h, w, dy.dtype, boundary)
    return out


def gspn_scan_fwd(x, wl, wc, wr, lam, *, chunk: int | None = None,
                  boundary: str = "one_shot"):
    """Forward line scan.  x, lam: (G, H, W); wl/wc/wr: (G_w, H, W) with
    G_w dividing G.  Returns h: (G, H, W) in x.dtype.  ``boundary`` names
    the scan's segment for the tuning cache (:func:`plan`).

    CUDA tensors launch the kernel (or raise); ``meta`` tensors record
    the launch (:func:`launch_cost`); CPU tensors take
    :func:`gspn_scan_fwd_torch`."""
    if not (x.is_cuda or x.is_meta):
        return gspn_scan_fwd_torch(x, wl, wc, wr, lam, chunk=chunk)
    return launch(1, KERNEL, x, wl, wc, wr, lam, chunk, boundary=boundary)


def gspn_scan_fwd_torch(x, wl, wc, wr, lam, *, chunk: int | None = None):
    """Plain PyTorch version of :func:`gspn_scan_fwd`, on any device: f32
    arithmetic and carry (f64 for f64 operands), output in x.dtype."""
    cuda_lib.count(cuda_lib.plain_calls, KERNEL)
    cd = compute_dtype(x.dtype)
    args = tuple(a.to(cd) for a in (x, wl, wc, wr, lam))
    if chunk_arg(x.shape[1], chunk):
        out = ref.gspn_scan_chunked_ref(*args, chunk)
    else:
        out = ref.gspn_scan_ref(*args)
    return out.to(x.dtype)


def gspn_scan_bwd(dy, wl, wc, wr, *, chunk: int | None = None,
                  boundary: str = "one_shot"):
    """Adjoint of :func:`gspn_scan_fwd`: g = dL/dh from dy (G, H, W) and
    the forward's taps (G_w, H, W), walking rows H-1..0 with the carry
    reset every ``chunk`` rows.  Returns g: (G, H, W) in float32.

    CUDA tensors launch the kernel (or raise); ``meta`` tensors record
    the launch; CPU tensors take :func:`gspn_scan_bwd_torch`."""
    if not (dy.is_cuda or dy.is_meta):
        return gspn_scan_bwd_torch(dy, wl, wc, wr, chunk=chunk)
    return launch_bwd(1, KERNEL_BWD, dy, wl, wc, wr, chunk,
                      boundary=boundary)


def gspn_scan_bwd_torch(dy, wl, wc, wr, *, chunk: int | None = None):
    """Plain PyTorch version of :func:`gspn_scan_bwd`, on any device: f32
    arithmetic, carry and output (f64 for f64 operands)."""
    cuda_lib.count(cuda_lib.plain_calls, KERNEL_BWD)
    cd = compute_dtype(dy.dtype)
    return ref.gspn_scan_adjoint_ref(
        *(a.to(cd) for a in (dy, wl, wc, wr)), reverse=True,
        chunk=chunk_arg(dy.shape[1], chunk))
