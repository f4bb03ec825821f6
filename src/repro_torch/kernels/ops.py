"""Public forward ops for the GSPN-2 line scan.

Two entry points, used by :mod:`repro_torch.core.gspn`:

* ``gspn_scan``      — one directional line scan (G, H, W) -> (G, H, W);
* ``gspn_scan_pair`` — one opposite-direction pair in a single fused
  launch: the top-to-bottom scan and its bottom-to-top mirror share every
  ``x`` row, so a four-direction pass costs two launches.

Each call takes one :class:`~repro_torch.kernels.spec.ScanSpec` (or builds
one from ``impl``) and resolves its implementation: ``cuda`` (the hand
kernels) for CUDA tensors under ``auto``, ``torch`` (the plain versions)
for CPU tensors or on request.

GSPN-local chunking (``chunk`` rows per propagation segment) is the fold
of the reference ops, ``(G, H, W) -> (G·H/chunk, chunk, W)`` with the
weights broadcast first: the plain versions fold, the kernels reset their
carry every ``chunk`` rows of their walk instead, which is the same
function without the broadcast copies.

Layout: ``x, lam: (G, H, W)``; ``wl, wc, wr: (G_w, H, W)`` with G_w
dividing G (channel-shared compact mode, ``cpw = G // G_w``).  Pair
operands carry a leading direction axis of size 2, except the shared x.

This slice is forward only: the CUDA path refuses tensors that require
grad (the backward kernels come with the training slice).
"""

from __future__ import annotations

from repro_torch.kernels import gspn_multidir as _mk
from repro_torch.kernels import gspn_scan as _pk
from repro_torch.kernels.spec import ScanSpec, resolve_impl


def _resolve(spec: ScanSpec | None, impl: str, x) -> str:
    """The implementation the caller's spec (or one built from ``impl``)
    resolves to for ``x``; raises if the CUDA kernel cannot run it."""
    spec = spec if spec is not None else ScanSpec(impl=impl)
    resolved = resolve_impl(spec.impl, x)
    if resolved == "cuda":
        spec.check_cuda()
    return resolved


def gspn_scan(x, wl, wc, wr, lam, *, spec: ScanSpec | None = None,
              chunk: int | None = None, impl: str = "auto"):
    """GSPN line scan with optional GSPN-local chunking.

    x, lam: (G, H, W); wl/wc/wr: (G_w, H, W), G_w divides G.  Returns
    h: (G, H, W) in x.dtype.  ``impl`` builds the spec when ``spec`` is
    not given and is ignored when it is.
    """
    if _resolve(spec, impl, x) == "cuda":
        return _pk.gspn_scan_fwd(*(a.contiguous() for a in
                                   (x, wl, wc, wr, lam)), chunk=chunk)
    return _pk.gspn_scan_fwd_torch(x, wl, wc, wr, lam, chunk=chunk)


def gspn_scan_pair(x, wl2, wc2, wr2, lam2, *, spec: ScanSpec | None = None,
                   chunk: int | None = None, impl: str = "auto"):
    """Fused opposite-direction pair scan with optional GSPN-local chunking.

    x: (G, H, W), shared by both directions; wl2/wc2/wr2: (2, G_w, H, W)
    with G_w dividing G; lam2: (2, G, H, W).  Entry 0 scans top to bottom
    over axis -2, entry 1 bottom to top; operands and outputs stay in the
    unflipped layout of x.  Returns (2, G, H, W) in x.dtype.
    """
    if _resolve(spec, impl, x) == "cuda":
        return _mk.gspn_scan_bidir(*(a.contiguous() for a in
                                     (x, wl2, wc2, wr2, lam2)), chunk=chunk)
    return _mk.gspn_scan_bidir_torch(x, wl2, wc2, wr2, lam2, chunk=chunk)
