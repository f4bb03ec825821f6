"""Single-direction forward line scan on the card (CUDA, ``sm_90a``).

:func:`gspn_scan_fwd` replaces the Pallas kernel
``src/repro/kernels/gspn_scan.py:gspn_scan_fwd_pallas``: the top-to-bottom
scan over (G, H, W) with compact weights indexed ``g // cpw``, the
GSPN-local carry reset every ``chunk`` rows, an f32 carry and the output
in the stream dtype.  It is the D = 1 instance of the template in
``csrc/gspn_scan.cu``; :func:`gspn_scan_fwd_torch` is its plain version.

Bound.  Each input is read once and the output written once: per (g,h,w)
element x, lam and out take one stream item each and the three taps
``3 / cpw`` items, 18 bytes in f32 at cpw = 2.  The operations (4
multiplies and 3 adds per element) are far below the card's rate, so bytes
set the floor; but every row depends on the previous one, so the kernel
really runs a chain of H row steps, each one barrier plus the latency of
that row's loads.

Design.  One CTA per plane, a thread per column, the previous row staged
in shared memory and the next row's five inputs loaded into registers
while the current row computes (see the source).  Several planes per CTA,
a deeper prefetch ring and warp shuffles for the neighbours are later work.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, ref

KERNEL = "gspn_scan_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_W = 1024  # one thread per column, at most 1024 threads per CTA


def chunk_arg(h: int, chunk: int | None) -> int:
    """The kernel's ``chunk`` argument: 0 for one segment of H rows."""
    if chunk is None or chunk == h:
        return 0
    if not isinstance(chunk, int) or chunk < 1 or h % chunk:
        raise ValueError(f"chunk={chunk!r} must be a positive divisor of "
                         f"H={h}")
    return chunk


def _check_forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA scan kernels are forward only; their backward kernels "
            "and autograd come with the vision training slice (slice 2 of "
            "the port). Run under torch.no_grad() or use impl='torch'.")


def launch(ndir: int, name: str, x, wl, wc, wr, lam, chunk) -> torch.Tensor:
    """Check the operands of one ``ndir``-direction scan and launch the
    kernel on the current stream.  Shapes: x (G,H,W); taps (G_w,H,W), or
    (2,G_w,H,W) for the pair; lam (G,H,W), or (2,G,H,W)."""
    tensors = (x, wl, wc, wr, lam)
    if x.dim() != 3:
        raise ValueError(f"x must be (G, H, W), got {tuple(x.shape)}")
    g, h, w = x.shape
    lead = () if ndir == 1 else (2,)
    if wl.dim() != len(lead) + 3:
        raise ValueError(f"taps must be {lead + ('G_w', 'H', 'W')}, got "
                         f"{tuple(wl.shape)}")
    gw = wl.shape[len(lead)]
    for nm, t, shape in (("wl", wl, lead + (gw, h, w)),
                         ("wc", wc, lead + (gw, h, w)),
                         ("wr", wr, lead + (gw, h, w)),
                         ("lam", lam, lead + (g, h, w))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{nm} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if gw < 1 or g % gw:
        raise ValueError(f"G={g} is not a multiple of G_w={gw}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA scan streams float32 or bfloat16, not "
                         f"{x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"operands of dtype {t.dtype} and {x.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA scan needs contiguous operands")
    if w > _MAX_W:
        raise ValueError(f"W={w} exceeds {_MAX_W} columns per CTA")
    chunk = chunk_arg(h, chunk)
    _check_forward_only(*tensors)
    out = torch.empty(lead + (g, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library("gspn_scan")
    with torch.cuda.device(x.device):
        err = lib.gspn_scan_launch(
            ndir, _DTYPE_CODES[x.dtype], x.data_ptr(), wl.data_ptr(),
            wc.data_ptr(), wr.data_ptr(), lam.data_ptr(), out.data_ptr(),
            g, h, w, g // gw, chunk, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, err, name)
    cuda_lib.launch_counts[name] += 1
    cuda_lib.launch_shapes[(name, g, h, w, str(x.dtype).removeprefix(
        "torch."))] += 1
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
    arithmetic and carry, output in x.dtype."""
    cuda_lib.plain_calls[KERNEL] += 1
    args = tuple(a.float() for a in (x, wl, wc, wr, lam))
    if chunk_arg(x.shape[1], chunk):
        out = ref.gspn_scan_chunked_ref(*args, chunk)
    else:
        out = ref.gspn_scan_ref(*args)
    return out.to(x.dtype)
