"""Spatial sequence parallelism of the GSPN line scan (DESIGN.md §8) over
``torch.distributed``, the port's twin of ``repro.parallel.gspn_sp``.

The scan dimension H is cut into K contiguous blocks, one per rank of the
mesh's ``seq`` axis.  The recurrence

    h[i] = M[i] h[i-1] + lam[i]·x[i],   M[i] tridiagonal from (wl, wc, wr)

is linear in the carry, so for block k with incoming boundary
``b_k = h[first_row_k - 1]``

    h[i] = h_loc[i] + (∏_{r=first_k..i} M[r]) · b_k

where ``h_loc`` is the block-local scan from a zero carry: the kernels #1
and #3 (``kernels.gspn_scan.gspn_scan_fwd``, ``kernels.gspn_multidir.
gspn_scan_bidir``) on the block's rows, launched under the
``sp_block_local`` boundary label.  Each rank also forms the block's
transfer operator ``T_k = ∏ M[r]`` (G_w, W, W) and its uncorrected outgoing
boundary; the pairs ``(T, b)`` compose associatively, so the incoming
boundaries come out of ONE logical exchange of compact states, never of
activations:

* ``"ppermute"``  — a chain of K-1 point-to-point hops (one
  ``batch_isend_irecv`` each), every hop forwarding one boundary column;
* ``"allgather"`` — one ``all_gather`` of the (T, b) pairs, each rank
  folding its own prefix;
* ``"pair_allgather"`` — the fused opposite-direction pair shares ONE
  ``all_gather`` of both directions' stacked states plus the adjoint's edge
  weight rows (LASP-2), computed by :func:`block_boundary_states` before
  the block-local pair scan so the gather can run under it;
* ``"auto"`` — ppermute for K ≤ 4, allgather beyond; pair calls:
  pair_allgather.

A correction pass (:func:`propagate_boundary`) carries ``b_k`` through the
block and adds it to ``h_loc``.  The adjoint is the same engine in reverse:
its block-local walks run on the adjoint kernels #2 and #4 from the block's
forward taps (the walk from zero beyond the block's last row needs no tap
outside the block), and the neighbour's edge weight row enters only
through the adjoint's operators and boundary correction: one
point-to-point fetch per direction, or nothing extra for the pair, whose
edge rows rode the forward's gather.  The per-row operators
(:func:`block_transfer_operator`, :func:`block_boundary_states`,
:func:`propagate_boundary`, ``lax.scan`` loops in the reference) are plain
PyTorch.

Whole tensors in, whole tensors out, as ``kernels.ops.gspn_scan``: every
rank holds the full operands, slices its block of rows (and, on a
``("data", "seq")`` mesh, its share of G when both G and G_w divide), and
returns the whole output, assembled by an ``all_gather`` of rows that
stands for ``shard_map``'s ``out_specs``; the gradients are assembled the
same way.  :func:`collectives` records every collective the path issues,
the assembling gathers apart under the name ``"assemble"``.  A gloo group
gathers CPU tensors only, so on one that joins ranks sharing a card the
payloads (and the assembled rows) cross through host memory; NCCL takes
them on the card.  Lengths K does not divide are padded with zero rows at
the scan end (zero taps and lam keep them exactly zero both ways).

Spans: ``sp.local_scan``, ``sp.transfer_operator``, ``sp.exchange`` and
``sp.correction`` per direction; ``sp.boundary_states``, ``sp.fold`` and
the ``sp.bwd.*`` phases for the pair.  Counters: ``sp_exchanges_total``,
``sp_collective_ops_total``, ``sp_boundary_bytes_total``,
``sp_activation_bytes_total`` and ``sp_pair_fused_exchanges_total``, with
one ``sp.exchange`` event per call (the reference records them once per
trace; the port, once per call).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import gspn_multidir as _mk
from repro_torch.kernels import gspn_scan as _pk
from repro_torch.kernels.ops import _tap_grads
from repro_torch.kernels.ref import _shift_left, _shift_right
from repro_torch.kernels.spec import ScanSpec, dtype_name, resolve_impl
from repro_torch.launch.mesh import dp_axes_for, seq_axis_size

STRATEGIES = ("auto", "ppermute", "allgather", "pair_allgather")

# How the fused-pair exchange is scheduled against the local scan.
EXCHANGE_MODES = ("overlap", "serial", "skip")

# auto strategy: neighbour chain while the latency term (K-1 hops) stays
# small, one all-gather of (T, b) pairs beyond.
PPERMUTE_MAX_BLOCKS = 4

BOUNDARY = "sp_block_local"


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """The cross-device legs of one sharded scan call: axis, block count,
    exchange strategy, wire dtype and the fused pair's schedule.  The
    block-local launch is described by the embedded :class:`ScanSpec`
    (impl resolved, ``boundary="sp_block_local"``), the spec the tuner
    keys the launch by.

    ``boundary_dtype`` is the wire dtype of the exchange: every payload is
    cast to it before it crosses, the composition runs in f32.
    ``exchange_mode`` (EXCHANGE_MODES): ``"overlap"`` issues the pair's
    gather before the local scan and waits after it; ``"serial"`` waits
    before it; ``"skip"`` exchanges nothing (a timing floor whose
    cross-block values are wrong by construction)."""
    axis_name: str = "seq"
    n_blocks: int = 1
    strategy: str = "auto"
    boundary_dtype: str = "float32"
    exchange_mode: str = "overlap"
    spec: ScanSpec = ScanSpec(impl="torch", boundary=BOUNDARY)

    def resolved_strategy(self, *, pair: bool = False) -> str:
        """The concrete strategy: ``auto`` is pair_allgather for a pair,
        else ppermute up to PPERMUTE_MAX_BLOCKS blocks and allgather
        beyond; a single direction degrades pair_allgather to
        allgather."""
        if self.strategy != "auto":
            if not pair and self.strategy == "pair_allgather":
                return "allgather"
            return self.strategy
        if pair:
            return "pair_allgather"
        return ("ppermute" if self.n_blocks <= PPERMUTE_MAX_BLOCKS
                else "allgather")

    @property
    def channels_per_weight(self) -> int:
        return self.spec.channels_per_weight


# ---------------------------------------------------------------------------
# The mesh's layout as one call sees it.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """This rank's block: ``idx`` of ``k`` along the seq axis (``group``,
    global ``ranks`` in block order) and, when G is sharded, ``didx`` of
    ``nd`` along the data axis (``dgroup``)."""
    k: int
    idx: int
    group: Any
    ranks: tuple
    nd: int = 1
    didx: int = 0
    dgroup: Any = None


def _layout(mesh, axis_name, batch_axes, g, gw) -> _Layout:
    """This rank's layout.  G is sharded over the data axes (``batch_axes``,
    default the mesh's own) only when both G and G_w divide, which keeps
    every weight group whole in its shard."""
    group = mesh.get_group(axis_name)
    lay = dict(k=seq_axis_size(mesh, axis_name), idx=dist.get_rank(group),
               group=group, ranks=tuple(dist.get_process_group_ranks(group)))
    axes = [a for a in (batch_axes if batch_axes is not None
                        else dp_axes_for(mesh))
            if a != axis_name and seq_axis_size(mesh, a) > 1]
    bsize = math.prod(seq_axis_size(mesh, a) for a in axes)
    if bsize > 1 and g % bsize == 0 and gw % bsize == 0:
        if len(axes) > 1:
            raise NotImplementedError(
                f"G sharded over {axes}: the port shards it over one data "
                f"axis; ROADMAP.md §1 item 6.2 brings the rest")
        dgroup = mesh.get_group(axes[0])
        lay.update(nd=bsize, didx=dist.get_rank(dgroup), dgroup=dgroup)
    return _Layout(**lay)


def _block(lay: _Layout, a: torch.Tensor, lead: int) -> torch.Tensor:
    """This rank's block of ``a`` (lead axes, G, H, W): its rows and, when
    G is sharded, its share of G."""
    hb = a.shape[lead + 1] // lay.k
    a = a.narrow(lead + 1, lay.idx * hb, hb)
    if lay.nd > 1:
        gd = a.shape[lead] // lay.nd
        a = a.narrow(lead, lay.didx * gd, gd)
    return a.contiguous()


# ---------------------------------------------------------------------------
# Collectives, recorded.
# ---------------------------------------------------------------------------

_TAPE: list | None = None


def _note(kind: str, t: torch.Tensor) -> None:
    if _TAPE is not None:
        _TAPE.append((kind, tuple(t.shape), dtype_name(t.dtype)))


def collectives(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return ``(its result, [(kind,
    payload shape, dtype)])`` for every collective the sp path issued on
    this rank meanwhile, the twin of the reference's
    ``collectives_in_jaxpr``: ``"ppermute"`` per hop of a chain (and the
    adjoint's edge-row fetch), ``"all_gather"`` per exchange gather, each
    with the local payload's shape; ``"assemble"`` per gather that
    assembles an output or gradient from the blocks, which ``shard_map``
    does outside its body and which is no exchange."""
    global _TAPE
    prev, _TAPE = _TAPE, []
    try:
        out = fn(*args, **kwargs)
        return out, _TAPE
    finally:
        _TAPE = prev


def _via_host(t: torch.Tensor, group) -> bool:
    """gloo moves CPU tensors only: a CUDA payload crosses through host
    memory on a gloo group (ranks that share a card)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _Gather:
    """One ``all_gather`` of ``t`` over ``group``, issued now (async when
    asked); :meth:`wait` returns the (n, *t.shape) stack on t's device,
    or the parts concatenated along ``cat``."""

    def __init__(self, t, group, *, kind: str, async_op: bool = False):
        _note(kind, t)
        self.device = t.device
        staged = t.cpu() if _via_host(t, group) else t.contiguous()
        self.parts = [torch.empty_like(staged)
                      for _ in range(dist.get_world_size(group))]
        self.work = dist.all_gather(self.parts, staged, group=group,
                                    async_op=async_op)

    def wait(self, cat: int | None = None) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        whole = (torch.stack(self.parts) if cat is None
                 else torch.cat(self.parts, dim=cat))
        return whole.to(self.device)


def _ppermute(lay: _Layout, send: torch.Tensor, *,
              reverse: bool) -> torch.Tensor:
    """One hop: send to the next block in scan order (device order, or
    reversed), receive from the previous; the first block receives
    zeros."""
    _note("ppermute", send)
    nxt, prv = ((lay.idx - 1, lay.idx + 1) if reverse
                else (lay.idx + 1, lay.idx - 1))
    buf = send.cpu() if _via_host(send, lay.group) else send.contiguous()
    recv = torch.zeros_like(buf)
    ops = []
    if 0 <= nxt < lay.k:
        ops.append(dist.P2POp(dist.isend, buf, lay.ranks[nxt], lay.group))
    if 0 <= prv < lay.k:
        ops.append(dist.P2POp(dist.irecv, recv, lay.ranks[prv], lay.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(send.device)


def _assemble(lay: _Layout, t: torch.Tensor, lead: int) -> torch.Tensor:
    """The whole tensor from every rank's block of ``t`` (lead axes, G,
    H_blk, W): rows over the seq axis, then G over the data axis."""
    t = _Gather(t, lay.group, kind="assemble").wait(cat=lead + 1)
    if lay.nd > 1:
        t = _Gather(t, lay.dgroup, kind="assemble").wait(cat=lead)
    return t


# ---------------------------------------------------------------------------
# Block-local operators (plain PyTorch, per-row loops).
# ---------------------------------------------------------------------------

def _shift_rows_down(t):
    """t[..., j, :] -> t[..., j-1, :]; row 0 becomes 0."""
    return F.pad(t, (0, 0, 1, 0))[..., :-1, :]


def _shift_rows_up(t):
    """t[..., j, :] -> t[..., j+1, :]; the last row becomes 0."""
    return F.pad(t, (0, 0, 0, 1))[..., 1:, :]


def _rows(h: int, reverse: bool):
    return range(h - 1, -1, -1) if reverse else range(h)


def _eye(gw: int, w: int, device) -> torch.Tensor:
    return torch.eye(w, dtype=torch.float32, device=device).expand(gw, w, w)


def _step_operator(t, wl_r, wc_r, wr_r):
    """M[r] t for t (G_w, W, W) and row taps (G_w, W)."""
    return (wl_r[..., None] * _shift_rows_down(t) + wc_r[..., None] * t
            + wr_r[..., None] * _shift_rows_up(t))


def _step_grouped(b, wl_r, wc_r, wr_r):
    """M[r] b for b (G_w, cpw, W) and row taps (G_w, W)."""
    return (wl_r[:, None] * _shift_right(b) + wc_r[:, None] * b
            + wr_r[:, None] * _shift_left(b))


def block_transfer_operator(wl, wc, wr, *, reverse: bool = False):
    """T_k = ∏ M[r] over the block's rows in scan order.  Taps (G_w,
    H_blk, W); returns (G_w, W, W) f32 mapping the incoming boundary
    column to the outgoing one.  ``reverse=True`` composes bottom to
    top."""
    gw, h, w = wl.shape
    wl, wc, wr = (a.float() for a in (wl, wc, wr))
    t = _eye(gw, w, wl.device)
    for r in _rows(h, reverse):
        t = _step_operator(t, wl[:, r], wc[:, r], wr[:, r])
    return t


def block_boundary_states(x, wl, wc, wr, lam, *, reverse: bool = False):
    """The block's exchange payload ``(T_k, bl_k)`` in one affine walk,
    without the local scan: row by row ``T ← M[r] T`` and ``b ← M[r] b +
    lam[r]·x[r]``, so T is :func:`block_transfer_operator` and b the
    zero-carry local scan's outgoing boundary row.  x, lam: (G, H_blk, W);
    taps (G_w, H_blk, W).  Returns (t (G_w, W, W), b (G, W)), both f32."""
    gw, h, w = wl.shape
    g = x.shape[0]
    wl, wc, wr = (a.float() for a in (wl, wc, wr))
    u = lam.float() * x.float()
    t = _eye(gw, w, wl.device)
    b = torch.zeros((gw, g // gw, w), dtype=torch.float32, device=x.device)
    for r in _rows(h, reverse):
        t = _step_operator(t, wl[:, r], wc[:, r], wr[:, r])
        b = _step_grouped(b, wl[:, r], wc[:, r], wr[:, r]) \
            + u[:, r].view(gw, -1, w)
    return t, b.reshape(g, w)


def _apply_transfer(t, b, cpw: int):
    """t: (G_w, W, W) acting on boundary columns b: (G, W), G = G_w·cpw."""
    gw = t.shape[0]
    bg = b.reshape(gw, cpw, b.shape[-1])
    return torch.einsum("gjk,gck->gcj", t, bg).reshape(b.shape)


def propagate_boundary(b, wl, wc, wr, *, reverse: bool = False):
    """Carry a boundary column homogeneously through the block.  b: (G,
    W); taps (G_w, H_blk, W).  Returns (G, H_blk, W) f32 whose row i is
    (∏_{entry..i} M[r]) b, the correction each local row needs once the
    true incoming boundary is known."""
    gw, h, w = wl.shape
    g = b.shape[0]
    wl, wc, wr = (a.float() for a in (wl, wc, wr))
    cur = b.float().reshape(gw, g // gw, w)
    out = torch.empty((gw, g // gw, h, w), dtype=torch.float32,
                      device=b.device)
    for r in _rows(h, reverse):
        cur = _step_grouped(cur, wl[:, r], wc[:, r], wr[:, r])
        out[:, :, r] = cur
    return out.reshape(g, h, w)


# ---------------------------------------------------------------------------
# The per-direction exchange.
# ---------------------------------------------------------------------------

def _exchange(cfg: SPConfig, lay: _Layout, t, b_last, *, reverse: bool):
    """The corrected INCOMING boundary of this block (zeros for the first
    in scan order) from the local operator t (G_w, W, W) and the
    uncorrected outgoing boundary b_last (G, W): the only cross-device
    traffic of the scan.  Payloads cross in ``cfg.boundary_dtype``; the
    fold runs in f32."""
    k, cpw = cfg.n_blocks, cfg.channels_per_weight
    zero = torch.zeros(b_last.shape, dtype=torch.float32,
                       device=b_last.device)
    wire = getattr(torch, cfg.boundary_dtype)
    b_last = b_last.float()
    # Position in scan order: the reverse pass visits blocks last to first.
    pos = (k - 1 - lay.idx) if reverse else lay.idx

    if cfg.resolved_strategy() == "ppermute":
        # Hop s: scan position s-1, whose incoming boundary was final at hop
        # s-1, forwards T·b_in + b_last; every other rank ships zeros, so a
        # narrow wire rounds only the chain that is consumed.
        b_in = zero
        for s in range(1, k):
            send = (_apply_transfer(t, b_in, cpw) + b_last if pos == s - 1
                    else zero)
            recv = _ppermute(lay, send.to(wire), reverse=reverse).float()
            if pos == s:
                b_in = recv
        return b_in

    # allgather: the (T, b) pairs of every block, then this block's prefix
    # (T_b, b_b)∘(T_a, b_a) = (T_b T_a, T_b b_a + b_b), folded as matvecs.
    tg = _Gather(t.to(wire), lay.group, kind="all_gather")
    bg = _Gather(b_last.to(wire), lay.group, kind="all_gather")
    tg, bg = tg.wait().float(), bg.wait().float()
    if reverse:
        tg, bg = tg.flip(0), bg.flip(0)
    b_in = zero
    for j in range(pos):
        b_in = _apply_transfer(tg[j], b_in, cpw) + bg[j]
    return b_in


def _correct(cfg: SPConfig, lay: _Layout, h_loc, wl, wc, wr, *,
             reverse: bool):
    """The exchange and correction after a block-local scan ``h_loc``
    (f32) with taps (G_w, H_blk, W): returns (globally corrected rows,
    the incoming boundary)."""
    b_last = h_loc[:, 0] if reverse else h_loc[:, -1]
    with obs.trace("sp.transfer_operator"):
        t = block_transfer_operator(wl, wc, wr, reverse=reverse)
    with obs.trace("sp.exchange"):
        b_in = _exchange(cfg, lay, t, b_last, reverse=reverse)
    with obs.trace("sp.correction"):
        h = h_loc + propagate_boundary(b_in, wl, wc, wr, reverse=reverse)
    return h, b_in


def _rows_next(a, nxt):
    """Row i+1 of a (G_w, H_blk, W) at every row i, ``nxt`` (G_w, W) past
    the last."""
    return torch.cat([a[:, 1:], nxt[:, None]], dim=1)


def _rows_prev(a, prv):
    """Row i-1 at every row i, ``prv`` before the first."""
    return torch.cat([prv[:, None], a[:, :-1]], dim=1)


def _adjoint_taps(wl, wc, wr):
    """The transposed tridiagonal of the rows given (f32)."""
    return _shift_right(wr), wc, _shift_left(wl)


class _SPScan(torch.autograd.Function):
    """One direction (top to bottom) over the seq axis; whole tensors in
    and out."""

    @staticmethod
    def forward(ctx, cfg, lay, x, wl, wc, wr, lam):
        xl, wl, wc, wr, lam = (_block(lay, a, 0)
                               for a in (x, wl, wc, wr, lam))
        with obs.trace("sp.local_scan"):
            h_loc = _pk.gspn_scan_fwd(xl, wl, wc, wr, lam,
                                      boundary=BOUNDARY).float()
        h, b_in = _correct(cfg, lay, h_loc, wl, wc, wr, reverse=False)
        ctx.save_for_backward(xl, wl, wc, wr, lam, h, b_in)
        ctx.cfg, ctx.lay = cfg, lay
        return _assemble(lay, h.to(x.dtype), 0)

    @staticmethod
    def backward(ctx, dy):
        xl, wl, wc, wr, lam, h, b_in = ctx.saved_tensors
        cfg, lay = ctx.cfg, ctx.lay
        dy = _block(lay, dy, 0)
        # The adjoint taps of the block's last row are the right
        # neighbour's first weight row: one hop against scan order (the
        # last block receives zeros, g[H-1] = dy[H-1]).
        w_first = _ppermute(
            lay, torch.stack([wl[:, 0], wc[:, 0], wr[:, 0]]).float(),
            reverse=True)
        adj = _adjoint_taps(*(_rows_next(a.float(), f)
                              for a, f in zip((wl, wc, wr), w_first)))
        # The local walk from zero needs only the block's own taps: #2.
        with obs.trace("sp.local_scan"):
            g_loc = _pk.gspn_scan_bwd(dy, wl, wc, wr, boundary=BOUNDARY)
        g, _ = _correct(cfg, lay, g_loc, *adj, reverse=True)
        # The first row's previous state is the forward incoming boundary.
        h_prev = torch.cat([b_in[:, None], h[:, :-1]], dim=1)
        dx = (lam.float() * g).to(xl.dtype)
        dlam = (xl.float() * g).to(lam.dtype)
        grads = (dx, *_tap_grads(g, h_prev, (wl, wc, wr)), dlam)
        return (None, None) + tuple(_assemble(lay, t, 0) for t in grads)


# ---------------------------------------------------------------------------
# The fused opposite-direction pair: one collective each way.
# ---------------------------------------------------------------------------

def _pair_payload_parts(gw: int, g: int, w: int, *, with_edges: bool):
    """Row extents of the packed per-direction payload (P axis)."""
    return gw * w, g, (3 * gw if with_edges else 0)


def _issue_pair_exchange(cfg: SPConfig, lay: _Layout, t2, b2, edge2):
    """Pack both directions' states — t2 (2, G_w, W, W), b2 (2, G, W) and
    the adjoint's edge rows edge2 (2, 3, G_w, W) or None — into one (2, P,
    W) payload in the wire dtype and issue its ``all_gather``
    (asynchronously under ``overlap``); None under ``skip``."""
    if cfg.exchange_mode == "skip":
        return None
    _, gw, w, _ = t2.shape
    parts = [t2.reshape(2, gw * w, w), b2]
    if edge2 is not None:
        parts.append(edge2.reshape(2, 3 * gw, w))
    payload = torch.cat(parts, dim=1).to(getattr(torch, cfg.boundary_dtype))
    with obs.trace("sp.exchange"):
        return _Gather(payload, lay.group, kind="all_gather",
                       async_op=cfg.exchange_mode == "overlap")


def _prefix(ts, bs, pos: int, cpw: int, zero):
    """The incoming boundary of scan position ``pos`` from the (T, b)
    pairs in scan order."""
    acc = zero
    for j in range(pos):
        acc = _apply_transfer(ts[j], acc, cpw) + bs[j]
    return acc


def _fold_pair_exchange(cfg: SPConfig, lay: _Layout, pending, gw, g, w,
                        device, *, with_edges: bool):
    """Wait for the pair's gather and fold each direction's prefix: slot 0
    scans in device order, slot 1 in reverse.  Returns ``b_in2`` (2, G, W)
    f32 and, ``with_edges``, ``w_next0`` (3, G_w, W), the right
    neighbour's first slot-0 tap rows, and ``w_prev1``, the left
    neighbour's last slot-1 rows (zeros at the grid's edges and under
    ``skip``)."""
    k, idx, cpw = cfg.n_blocks, lay.idx, cfg.channels_per_weight
    zero = torch.zeros((g, w), dtype=torch.float32, device=device)
    ez = torch.zeros((3, gw, w), dtype=torch.float32, device=device)
    if pending is None:
        b_in2 = torch.stack([zero, zero])
        return (b_in2, ez, ez) if with_edges else b_in2
    gathered = pending.wait().float()              # (K, 2, P, W)
    tg = gathered[:, :, :gw * w].reshape(k, 2, gw, w, w)
    bg = gathered[:, :, gw * w:gw * w + g]
    b_in2 = torch.stack([
        _prefix(tg[:, 0], bg[:, 0], idx, cpw, zero),
        _prefix(tg[:, 1].flip(0), bg[:, 1].flip(0), k - 1 - idx, cpw,
                zero)])
    if not with_edges:
        return b_in2
    eg = gathered[:, :, gw * w + g:].reshape(k, 2, 3, gw, w)
    w_next0 = eg[idx + 1, 0] if idx < k - 1 else ez
    w_prev1 = eg[idx - 1, 1] if idx > 0 else ez
    return b_in2, w_next0, w_prev1


def _pair_forward(cfg: SPConfig, lay: _Layout, x, wl2, wc2, wr2, lam2):
    """The fused pair on this rank's block, in the order that lets the
    gather run under the local scan: (1) ``sp.boundary_states``, both
    directions' (T, b) and the adjoint's edge rows; (2) ``sp.exchange``,
    the one gather, issued; (3) ``sp.local_scan``, #3 on the block, which
    reads nothing of the gather; (4) ``sp.fold`` and ``sp.correction``.
    Returns (h2 (2, G, H_blk, W) f32, b_in2, w_next0, w_prev1)."""
    gw = wl2.shape[1]
    g, _, w = x.shape
    with obs.trace("sp.boundary_states"):
        t0, b0 = block_boundary_states(x, wl2[0], wc2[0], wr2[0], lam2[0])
        t1, b1 = block_boundary_states(x, wl2[1], wc2[1], wr2[1], lam2[1],
                                       reverse=True)
        edge2 = torch.stack([
            torch.stack([wl2[0][:, 0], wc2[0][:, 0], wr2[0][:, 0]]),
            torch.stack([wl2[1][:, -1], wc2[1][:, -1], wr2[1][:, -1]]),
        ]).float()
    pending = _issue_pair_exchange(cfg, lay, torch.stack([t0, t1]),
                                   torch.stack([b0, b1]), edge2)
    if cfg.exchange_mode == "serial" and pending is not None:
        # The exposed-exchange baseline: the gather lands first.
        pending.wait()
    with obs.trace("sp.local_scan"):
        h_loc2 = _mk.gspn_scan_bidir(x, wl2, wc2, wr2, lam2,
                                     boundary=BOUNDARY).float()
    with obs.trace("sp.fold"):
        b_in2, w_next0, w_prev1 = _fold_pair_exchange(
            cfg, lay, pending, gw, g, w, x.device, with_edges=True)
    with obs.trace("sp.correction"):
        h2 = torch.stack([
            h_loc2[0] + propagate_boundary(b_in2[0], wl2[0], wc2[0], wr2[0]),
            h_loc2[1] + propagate_boundary(b_in2[1], wl2[1], wc2[1], wr2[1],
                                           reverse=True)])
    return h2, b_in2, w_next0, w_prev1


class _SPPair(torch.autograd.Function):
    """The fused pair (slot 0 top to bottom, slot 1 bottom to top) over the
    seq axis; whole tensors in and out."""

    @staticmethod
    def forward(ctx, cfg, lay, x, wl2, wc2, wr2, lam2):
        xl = _block(lay, x, 0)
        wl2, wc2, wr2, lam2 = (_block(lay, a, 1)
                               for a in (wl2, wc2, wr2, lam2))
        h2, b_in2, w_next0, w_prev1 = _pair_forward(cfg, lay, xl, wl2, wc2,
                                                    wr2, lam2)
        ctx.save_for_backward(xl, wl2, wc2, wr2, lam2, h2, b_in2, w_next0,
                              w_prev1)
        ctx.cfg, ctx.lay = cfg, lay
        return _assemble(lay, h2.to(x.dtype), 1)

    @staticmethod
    def backward(ctx, dy2):
        """The mirrored pair, itself one fused exchange: slot 1's adjoint
        walks top to bottom (slot 0 of the exchange), slot 0's bottom to
        top.  The neighbours' edge rows came with the forward's gather,
        so nothing travels point to point."""
        xl, wl2, wc2, wr2, lam2, h2, b_in2, w_next0, w_prev1 = \
            ctx.saved_tensors
        cfg, lay = ctx.cfg, ctx.lay
        gw = wl2.shape[1]
        g, _, w = xl.shape
        dy2 = _block(lay, dy2, 1)
        dy32 = dy2.float()
        ones = torch.ones_like(dy32[0])
        # Each direction's adjoint taps: the next row in its scan order.
        a0 = _adjoint_taps(*(_rows_next(a.float(), e) for a, e in
                             zip((wl2[0], wc2[0], wr2[0]), w_next0)))
        a1 = _adjoint_taps(*(_rows_prev(a.float(), e) for a, e in
                             zip((wl2[1], wc2[1], wr2[1]), w_prev1)))
        with obs.trace("sp.bwd.boundary_states"):
            t1a, b1a = block_boundary_states(dy32[1], *a1, ones)
            t0a, b0a = block_boundary_states(dy32[0], *a0, ones,
                                             reverse=True)
        pending = _issue_pair_exchange(cfg, lay, torch.stack([t1a, t0a]),
                                       torch.stack([b1a, b0a]), None)
        if cfg.exchange_mode == "serial" and pending is not None:
            pending.wait()
        # The local walks from zero need only the block's own taps: #4.
        with obs.trace("sp.bwd.local_scan"):
            g2 = _mk.gspn_scan_bidir_bwd(dy2, wl2, wc2, wr2,
                                         boundary=BOUNDARY)
        with obs.trace("sp.bwd.fold"):
            g_in2 = _fold_pair_exchange(cfg, lay, pending, gw, g, w,
                                        dy2.device, with_edges=False)
        with obs.trace("sp.bwd.correction"):
            g2 = torch.stack([
                g2[0] + propagate_boundary(g_in2[1], *a0, reverse=True),
                g2[1] + propagate_boundary(g_in2[0], *a1)])
        # Each direction's first row (in its own order) reads the saved
        # forward incoming boundary.
        hp2 = torch.stack([
            torch.cat([b_in2[0][:, None], h2[0][:, :-1]], dim=1),
            torch.cat([h2[1][:, 1:], b_in2[1][:, None]], dim=1)])
        lam32 = lam2.float()
        dx = (lam32[0] * g2[0] + lam32[1] * g2[1]).to(xl.dtype)
        dlam2 = (xl.float()[None] * g2).to(lam2.dtype)
        grads = (dx, *_tap_grads(g2, hp2, (wl2, wc2, wr2)), dlam2)
        return (None, None, _assemble(lay, grads[0], 0)) + tuple(
            _assemble(lay, t, 1) for t in grads[1:])


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def _account(cfg: SPConfig, *, pair: bool, gw: int, g: int, w: int,
             act_bytes: int) -> None:
    """The reference's analytic accounting of one exchange: collective
    ops, the bytes the compact exchange moves and those a full-activation
    collective would have moved."""
    wire_bytes = getattr(torch, cfg.boundary_dtype).itemsize
    k = cfg.n_blocks
    if pair:
        n_ops = 0 if cfg.exchange_mode == "skip" else 1
        rows = sum(_pair_payload_parts(gw, g, w, with_edges=True))
        boundary_bytes = n_ops * k * 2 * rows * w * wire_bytes
        obs.counter("sp_pair_fused_exchanges_total").inc()
    elif cfg.resolved_strategy() == "ppermute":
        n_ops = k - 1
        boundary_bytes = (k - 1) * g * w * wire_bytes
    else:
        n_ops = 1
        boundary_bytes = k * (gw * w * w + g * w) * wire_bytes
    obs.counter("sp_exchanges_total").inc()
    obs.counter("sp_collective_ops_total").inc(n_ops)
    obs.counter("sp_boundary_bytes_total").inc(boundary_bytes)
    obs.counter("sp_activation_bytes_total").inc(act_bytes)
    extra = (dict(fused_pair=True, exchange_mode=cfg.exchange_mode)
             if pair else {})
    obs.event("sp.exchange",
              strategy=cfg.resolved_strategy(pair=pair), n_blocks=k,
              collective_ops=n_ops, boundary_bytes=boundary_bytes,
              activation_bytes=act_bytes, wire_dtype=cfg.boundary_dtype,
              **extra)


def _pad_rows(a, pad: int):
    """Zero rows at the scan end (axis -2): zero taps and lam keep them
    exactly zero both ways, and no real boundary crosses them."""
    return F.pad(a, (0, 0, 0, pad)) if pad else a


def _sp_config(spec, direction, n_seq, strategy, boundary_dtype, x, g, gw,
               axis_name, exchange_mode="overlap") -> SPConfig:
    """The call's config; the block-local launch resolves as ``auto``:
    the kernels on the card, the plain versions on the CPU."""
    inner = resolve_impl("auto", x)
    return SPConfig(
        axis_name=axis_name, n_blocks=n_seq, strategy=strategy,
        boundary_dtype=dtype_name(boundary_dtype if boundary_dtype
                                  is not None else torch.float32),
        exchange_mode=exchange_mode,
        spec=spec.with_(direction=direction, impl=inner,
                        channels_per_weight=g // gw, stream_dtype=x.dtype,
                        boundary=BOUNDARY))


def gspn_scan_sp(x, wl, wc, wr, lam, *, spec: ScanSpec | None = None,
                 mesh=None, axis_name: str = "seq", strategy: str = "auto",
                 chunk: int | None = None, batch_axes=None,
                 boundary_dtype=None):
    """The line scan with its rows sharded over ``axis_name`` of ``mesh``
    (a ``DeviceMesh``), ``impl="sp"``.  Same layout and result as
    ``kernels.ops.gspn_scan``: x, lam (G, H, W), taps (G_w, H, W) in, h
    (G, H, W) in x.dtype out, whole on every rank and differentiable in
    every tensor.  H need not divide the axis.  ``boundary_dtype`` (default
    f32) is the exchange's wire dtype.  On a mesh with a data axis, G is
    sharded over it when G and G_w divide (``batch_axes``, default
    whichever of ``("pod", "data")`` the mesh has).

    Without a mesh, with an axis of one block, or with ``chunk`` (which
    resets the carry per segment, so nothing crosses blocks) it is the
    single-device ``ops.gspn_scan`` with ``impl="auto"``: the kernel on the
    card."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown sp strategy {strategy!r}")
    spec = spec if spec is not None else ScanSpec()
    n_seq = seq_axis_size(mesh, axis_name)
    if n_seq == 1 or chunk is not None:
        from repro_torch.kernels.ops import gspn_scan
        return gspn_scan(x, wl, wc, wr, lam, chunk=chunk,
                         spec=spec.with_(impl="auto", boundary="one_shot"))
    g, h_dim, w = x.shape
    gw = wl.shape[0]
    if g % gw:
        raise ValueError(f"G={g} is not a multiple of G_w={gw}")
    pad = -(-h_dim // n_seq) * n_seq - h_dim
    x, wl, wc, wr, lam = (_pad_rows(a, pad) for a in (x, wl, wc, wr, lam))
    cfg = _sp_config(spec, "fwd", n_seq, strategy, boundary_dtype, x, g, gw,
                     axis_name)
    _account(cfg, pair=False, gw=gw, g=g, w=w,
             act_bytes=x.numel() * x.element_size())
    lay = _layout(mesh, axis_name, batch_axes, g, gw)
    out = _SPScan.apply(cfg, lay, x, wl, wc, wr, lam)
    return out[:, :h_dim] if pad else out


def gspn_scan_sp_pair(x, wl2, wc2, wr2, lam2, *, spec: ScanSpec | None = None,
                      mesh=None, axis_name: str = "seq",
                      strategy: str = "auto", chunk: int | None = None,
                      batch_axes=None, boundary_dtype=None,
                      exchange_mode: str = "overlap"):
    """The fused opposite-direction pair with its rows sharded over
    ``axis_name``, ``impl="sp"``; layout and result as
    ``kernels.ops.gspn_scan_pair`` (x (G, H, W) shared, taps (2, G_w, H,
    W), lam2 (2, G, H, W); slot 0 top to bottom, slot 1 bottom to top).
    Under ``auto`` both directions share ONE gather forward and one in the
    gradient, and nothing travels point to point; an explicit
    ``ppermute``/``allgather`` runs the two directions apart (slot 1
    through the flip identity).  ``exchange_mode`` is the measurement knob
    of EXCHANGE_MODES.  The single-device cases are those of
    :func:`gspn_scan_sp`."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown sp strategy {strategy!r}")
    if exchange_mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown sp exchange mode {exchange_mode!r}")
    spec = spec if spec is not None else ScanSpec(direction="pair_fwd")
    n_seq = seq_axis_size(mesh, axis_name)
    if n_seq == 1 or chunk is not None:
        from repro_torch.kernels.ops import gspn_scan_pair
        return gspn_scan_pair(
            x, wl2, wc2, wr2, lam2, chunk=chunk,
            spec=spec.with_(impl="auto", direction="pair_fwd",
                            boundary="one_shot"))
    if SPConfig(n_blocks=n_seq, strategy=strategy).resolved_strategy(
            pair=True) != "pair_allgather":
        def flip(a):
            return a.flip(-2)

        kw = dict(spec=spec.with_(direction="fwd"), mesh=mesh,
                  axis_name=axis_name, strategy=strategy,
                  batch_axes=batch_axes, boundary_dtype=boundary_dtype)
        out0 = gspn_scan_sp(x, wl2[0], wc2[0], wr2[0], lam2[0], **kw)
        out1 = flip(gspn_scan_sp(flip(x), flip(wl2[1]), flip(wc2[1]),
                                 flip(wr2[1]), flip(lam2[1]), **kw))
        return torch.stack([out0, out1])

    g, h_dim, w = x.shape
    gw = wl2.shape[1]
    if g % gw:
        raise ValueError(f"G={g} is not a multiple of G_w={gw}")
    # Zero rows at the array's end: slot 1 enters through them with a zero
    # carry, the state the unpadded scan starts from.
    pad = -(-h_dim // n_seq) * n_seq - h_dim
    x, wl2, wc2, wr2, lam2 = (_pad_rows(a, pad)
                              for a in (x, wl2, wc2, wr2, lam2))
    cfg = _sp_config(spec, "pair_fwd", n_seq, strategy, boundary_dtype, x, g,
                     gw, axis_name, exchange_mode)
    _account(cfg, pair=True, gw=gw, g=g, w=w,
             act_bytes=2 * x.numel() * x.element_size())
    lay = _layout(mesh, axis_name, batch_axes, g, gw)
    out = _SPPair.apply(cfg, lay, x, wl2, wc2, wr2, lam2)
    return out[:, :, :h_dim] if pad else out
