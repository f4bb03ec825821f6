"""Public ops for the GSPN-2 line scan, differentiable in every tensor.

Two entry points, used by :mod:`repro_torch.core.gspn`:

* ``gspn_scan``      — one directional line scan (G, H, W) -> (G, H, W);
* ``gspn_scan_pair`` — one opposite-direction pair in a single fused
  launch: the top-to-bottom scan and its bottom-to-top mirror share every
  ``x`` row, so a four-direction pass costs two launches.

Each call takes one :class:`~repro_torch.kernels.spec.ScanSpec` (or builds
one from ``impl``) and resolves its implementation: ``cuda`` (the hand
kernels) for CUDA tensors under ``auto``, ``torch`` (the plain versions)
for CPU tensors or on request, and for ``gspn_scan`` only ``per_step``, the
GSPN-1 emulation of one dispatch per row (``ref.gspn_scan_per_step``, on
any device; its backward is the plain walk).  Every forward and backward
dispatch enters the ``kernel.dispatch`` span of DESIGN.md §13 with the
reference's ``op`` names and the resolved ``impl``, ``dtype`` and
``shape``.

Each entry is a ``torch.autograd.Function`` with the reference's
hand-derived adjoint (DESIGN.md §2, ``src/repro/kernels/ops.py``
``_gspn_core_bwd`` and ``_gspn_pair_bwd``).  Its backward runs the adjoint
walk of the resolved implementation (the adjoint kernel for ``cuda``, the
plain walk for ``torch``) and then, on every device, the same
parameter-gradient epilogue in plain elementwise PyTorch, as the reference
runs it in XLA outside its Pallas kernel: ``dx = lam·g`` (summed over both
directions of a pair), ``dlam = x·g``, ``dw* = g·shift(h_prev)`` summed
over each cpw group, each cast back to its operand's dtype.

GSPN-local chunking (``chunk`` rows per propagation segment) is the fold
of the reference ops, ``(G, H, W) -> (G·H/chunk, chunk, W)`` with the
weights broadcast first: the plain versions fold, the kernels reset their
carry every ``chunk`` rows of their walk instead, which is the same
function without the broadcast copies.  The adjoint walks reset the same
way, and the epilogue's previous row is 0 at the first row of every
segment in the forward walk's order.

Layout: ``x, lam: (G, H, W)``; ``wl, wc, wr: (G_w, H, W)`` with G_w
dividing G (channel-shared compact mode, ``cpw = G // G_w``).  Pair
operands carry a leading direction axis of size 2, except the shared x.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import gspn_multidir as _mk
from repro_torch.kernels import gspn_scan as _pk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import _shift_left, _shift_right
from repro_torch.kernels.spec import ScanSpec, resolve_impl


def _resolve(spec: ScanSpec | None, impl: str, x) -> str:
    """The implementation the caller's spec (or one built from ``impl``)
    resolves to for ``x``; raises if the CUDA kernel cannot run it."""
    spec = spec if spec is not None else ScanSpec(impl=impl)
    resolved = resolve_impl(spec.impl, x)
    if resolved == "cuda":
        spec.check_cuda()
    return resolved


def _dispatch_span(op: str, impl: str, t: torch.Tensor):
    if not obs.enabled():  # no attributes to format on the eager path
        return obs.NOOP_SPAN
    return obs.trace("kernel.dispatch", op=op, impl=impl,
                     dtype=str(t.dtype).removeprefix("torch."),
                     shape=str(tuple(t.shape)))


def _per_step(x, wl, wc, wr, lam, chunk):
    """The per-step emulation in the plain versions' arithmetic: f32 (f64
    for f64 operands), output in x.dtype; one-shot only.  Counts the call
    and its H row steps in ``plain_calls``."""
    if chunk:
        raise ValueError("impl='per_step' runs one-shot scans; chunk=None")
    cuda_lib.plain_calls["per_step"] += 1
    cuda_lib.plain_calls["per_step_row"] += x.shape[1]
    cd = _pk.compute_dtype(x.dtype)
    return _ref.gspn_scan_per_step(
        *(a.to(cd) for a in (x, wl, wc, wr, lam))).to(x.dtype)


def _h_prev(h, reverse: bool, chunk: int | None):
    """The forward's previous row at every row of h (..., H, W): row i-1
    (row i+1 when ``reverse``), 0 at the first row of each ``chunk``-row
    segment in the walk's order."""
    zero = torch.zeros_like(h[..., :1, :])
    if reverse:
        hp = torch.cat([h[..., 1:, :], zero], dim=-2)
    else:
        hp = torch.cat([zero, h[..., :-1, :]], dim=-2)
    if chunk:
        first = chunk - 1 if reverse else 0
        hp[..., first::chunk, :] = 0
    return hp


def _tap_grads(g, h_prev, taps):
    """(dwl, dwc, dwr) from g and the previous rows (..., G, H, W), summed
    over each group of G // G_w planes and cast to each tap's dtype."""
    dws = (g * _shift_right(h_prev), g * h_prev, g * _shift_left(h_prev))
    gw = taps[0].shape[-3]
    if gw != g.shape[-3]:
        dws = tuple(d.unflatten(-3, (gw, -1)).sum(-3) for d in dws)
    return tuple(d.to(t.dtype) for d, t in zip(dws, taps))


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wl, wc, wr, lam, chunk, impl):
        with _dispatch_span("gspn_scan", impl, x):
            if impl == "cuda":
                x, wl, wc, wr, lam = (a.contiguous()
                                      for a in (x, wl, wc, wr, lam))
                h = _pk.gspn_scan_fwd(x, wl, wc, wr, lam, chunk=chunk)
            elif impl == "per_step":
                h = _per_step(x, wl, wc, wr, lam, chunk)
            else:
                h = _pk.gspn_scan_fwd_torch(x, wl, wc, wr, lam, chunk=chunk)
        ctx.save_for_backward(x, wl, wc, wr, lam, h)
        ctx.chunk, ctx.impl = chunk, impl
        return h

    @staticmethod
    def backward(ctx, dy):
        x, wl, wc, wr, lam, h = ctx.saved_tensors
        with _dispatch_span("gspn_scan_bwd", ctx.impl, dy):
            if ctx.impl == "cuda":
                g = _pk.gspn_scan_bwd(dy.contiguous(), wl, wc, wr,
                                      chunk=ctx.chunk)
            else:
                g = _pk.gspn_scan_bwd_torch(dy, wl, wc, wr, chunk=ctx.chunk)
        h_prev = _h_prev(h.to(g.dtype), False, ctx.chunk)
        dx = (lam.to(g.dtype) * g).to(x.dtype)
        dlam = (x.to(g.dtype) * g).to(lam.dtype)
        return (dx, *_tap_grads(g, h_prev, (wl, wc, wr)), dlam, None, None)


class _ScanPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wl2, wc2, wr2, lam2, chunk, impl):
        with _dispatch_span("gspn_scan_pair", impl, x):
            if impl == "cuda":
                x, wl2, wc2, wr2, lam2 = (a.contiguous()
                                          for a in (x, wl2, wc2, wr2, lam2))
                h2 = _mk.gspn_scan_bidir(x, wl2, wc2, wr2, lam2, chunk=chunk)
            else:
                h2 = _mk.gspn_scan_bidir_torch(x, wl2, wc2, wr2, lam2,
                                               chunk=chunk)
        ctx.save_for_backward(x, wl2, wc2, wr2, lam2, h2)
        ctx.chunk, ctx.impl = chunk, impl
        return h2

    @staticmethod
    def backward(ctx, dy2):
        x, wl2, wc2, wr2, lam2, h2 = ctx.saved_tensors
        # dy2 arrives as autograd builds it, e.g. strided after the L->R
        # transposes of core.gspn, or expanded from a sum.
        with _dispatch_span("gspn_scan_pair_bwd", ctx.impl, dy2):
            if ctx.impl == "cuda":
                g2 = _mk.gspn_scan_bidir_bwd(dy2.contiguous(), wl2, wc2, wr2,
                                             chunk=ctx.chunk)
            else:
                g2 = _mk.gspn_scan_bidir_bwd_torch(dy2, wl2, wc2, wr2,
                                                   chunk=ctx.chunk)
        h32 = h2.to(g2.dtype)
        h_prev = torch.stack([_h_prev(h32[0], False, ctx.chunk),
                              _h_prev(h32[1], True, ctx.chunk)])
        lam32 = lam2.to(g2.dtype)
        dx = (lam32[0] * g2[0] + lam32[1] * g2[1]).to(x.dtype)
        dlam2 = (x.to(g2.dtype)[None] * g2).to(lam2.dtype)
        return (dx, *_tap_grads(g2, h_prev, (wl2, wc2, wr2)), dlam2, None,
                None)


def gspn_scan(x, wl, wc, wr, lam, *, spec: ScanSpec | None = None,
              chunk: int | None = None, impl: str = "auto"):
    """GSPN line scan with optional GSPN-local chunking.

    x, lam: (G, H, W); wl/wc/wr: (G_w, H, W), G_w divides G.  Returns
    h: (G, H, W) in x.dtype, differentiable in every tensor.  ``impl``
    builds the spec when ``spec`` is not given and is ignored when it is;
    ``per_step`` takes no ``chunk``.
    """
    resolved = _resolve(spec, impl, x)
    chunk = _pk.chunk_arg(x.shape[1], chunk) or None
    return _Scan.apply(x, wl, wc, wr, lam, chunk, resolved)


def gspn_scan_pair(x, wl2, wc2, wr2, lam2, *, spec: ScanSpec | None = None,
                   chunk: int | None = None, impl: str = "auto"):
    """Fused opposite-direction pair scan with optional GSPN-local chunking.

    x: (G, H, W), shared by both directions; wl2/wc2/wr2: (2, G_w, H, W)
    with G_w dividing G; lam2: (2, G, H, W).  Entry 0 scans top to bottom
    over axis -2, entry 1 bottom to top; operands and outputs stay in the
    unflipped layout of x.  Returns (2, G, H, W) in x.dtype,
    differentiable in every tensor.
    """
    resolved = _resolve(spec, impl, x)
    if resolved == "per_step":
        raise ValueError("impl='per_step' is not supported for the fused "
                         "pair scan")
    chunk = _pk.chunk_arg(x.shape[1], chunk) or None
    return _ScanPair.apply(x, wl2, wc2, wr2, lam2, chunk, resolved)
