"""Single-direction line scan and its adjoint on the card (CUDA,
``sm_90a``).

:func:`gspn_scan_fwd` replaces the Pallas kernel
``src/repro/kernels/gspn_scan.py:gspn_scan_fwd_pallas``: the top-to-bottom
scan over (G, H, W) with compact weights indexed ``g // cpw``, the
GSPN-local carry reset every ``chunk`` rows, an f32 carry and the output
in the stream dtype.  It is the D = 1 instance of the forward template in
``csrc/gspn_scan.cu``; :func:`gspn_scan_fwd_torch` is its plain version.

:func:`gspn_scan_bwd` replaces ``gspn_scan_bwd_pallas`` (same file): the
adjoint walk from the last row to the first with three f32 product rows,
the same chunk reset, an f32 output, and no flipped copies of its
operands.  It is the D = 1 instance of the adjoint template;
:func:`gspn_scan_bwd_torch` is its plain version.

Bound.  Each input is read once and the output written once: per (g,h,w)
element the forward moves x, lam and out (one stream item each) and the
three taps (``3 / cpw`` items), 18 bytes in f32 at cpw = 2; the adjoint
moves dy, the taps and an f32 g, 14 bytes.  The operations (7 per element
forward, 9 adjoint) are far below the card's rate, so bytes set the floor;
but every row depends on the previous one, so each kernel really runs a
chain of H row steps, each one barrier plus the latency of that row's
loads.

Design.  One CTA per plane, a thread per column, the previous row (the
adjoint: its two shifted product rows) staged in shared memory and the
next row's inputs loaded into registers while the current row computes
(see the source): the first design of the port, which these two kernels
and the quad (:func:`launch`, D = 4) still use.  The pair kernels of the
main path have moved to the redesign in ``csrc/gspn_pair.cu`` (a warp per
plane, neighbours by shuffle, a shared-memory prefetch ring, taps loaded
once per weight group; :mod:`repro_torch.kernels.gspn_multidir`); moving
these three kernels onto it is the next step.

Every launch (:func:`launch`, :func:`launch_bwd`, and the pair's launches
in :mod:`~repro_torch.kernels.gspn_multidir`) enters the ``kernel.launch``
span of DESIGN.md §13 with the reference's attributes ``kernel``,
``dtype``, ``g``, ``h`` and ``w``; the reference's ``row_tile`` and
``pipeline_depth`` are left out, since the port's launch shapes are not
the Pallas launch plan.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import cuda_lib, ref

KERNEL = "gspn_scan_fwd"
KERNEL_BWD = "gspn_scan_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Widest row the kernels take: one thread per column here, at most 1024
# threads per CTA; the pair's lanes hold up to 32 columns each.
_MAX_W = 1024


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
    """Check the operands of one ``ndir``-direction forward scan, 1 or 4,
    and launch the kernel on the current stream.  Shapes: x (G,H,W), or
    for the quad x stacked with its transpose (2,G,N,N); taps (G_w,H,W),
    or (4,G_w,N,N); lam (G,H,W), or (4,G,N,N)."""
    if ndir not in (1, 4):
        raise ValueError(f"ndir={ndir}: this template runs 1 or 4 "
                         f"directions; the pair launches through "
                         f"gspn_multidir")
    lead = _lead(ndir)
    x_lead = (2,) if ndir == 4 else ()
    cpw, chunk = _check(ndir, [("x", x, x_lead), ("lam", lam, lead)],
                        (wl, wc, wr), chunk)
    g, h, w = x.shape[len(x_lead):]
    if ndir == 4 and (h != w or chunk):
        raise ValueError(f"the quad scan is one-shot on a square grid, got "
                         f"H={h}, W={w}, chunk={chunk}")
    out = torch.empty(lead + (g, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library("gspn_scan")
    with _span(name, g, h, w, x.dtype), torch.cuda.device(x.device):
        err = lib.gspn_scan_launch(
            ndir, _DTYPE_CODES[x.dtype], x.data_ptr(), wl.data_ptr(),
            wc.data_ptr(), wr.data_ptr(), lam.data_ptr(), out.data_ptr(),
            g, h, w, cpw, chunk, torch.cuda.current_stream().cuda_stream)
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
