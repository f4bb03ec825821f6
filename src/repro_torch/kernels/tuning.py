"""The static admission model of the scan kernels' launch shapes on the
H100: which shapes a kernel of ``csrc/gspn_pair.cu`` can run.  It
replaces the reference's VMEM row-tile model (``repro.kernels.tuning``,
a 64 MiB budget per grid cell), which has no counterpart on the card:
there a launch shape is planes, warps and columns per lane, the CTAs a
weight group spreads over, and the shared-memory ring's batches.

A shape is admitted when
- its fields are the ones :func:`launch_shape` derives from its free
  fields (the ring's bytes as ``gspn_scan.ring_bytes`` lays them out);
- a batch is at most the plane;
- and the C side's own checks pass: :func:`check_shape` mirrors
  ``check_shape`` in the source line for line (the ring's stages, and the
  banded adjoint's edge products, within ``SMEM_MAX``; warps within the
  register budget at its columns per lane, ``gspn_scan._MAX_WARPS``,
  and covering its planes and bands; a single batch holding the whole
  plane; at most ``kMaxBufs`` batches), :func:`refusal` the entry
  points' checks around it (``gspn_fwd_launch``, ``gspn_bwd_launch``).

:func:`launch_shape` builds the full
:class:`~repro_torch.kernels.gspn_scan.PairLaunch` of a shape from its
free fields (planes, warps, splits, batch, nbuf, bands, direct and the
windows' columns per lane), deriving the rest as
``gspn_scan.pair_launch_shape`` does; that function stays the static
heuristic, and the tuner (:mod:`repro_torch.kernels.autotune`) only ever
emits shapes admitted here.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import gspn_scan as _gs

# The source's limits (csrc/gspn_pair.cu: kMaxBufs, kMaxShared).
MAX_BUFS = 8
SMEM_MAX = _gs.SMEM_MAX
MAX_PLANES_BANDED = 15   # a banded plane waits at a named barrier, 1..15


def max_threads(k: int) -> int:
    """Threads per CTA the register budget allows at ``k`` columns per
    lane (the source's ``max_threads``, its ``__launch_bounds__``; 32 ×
    ``gspn_scan._MAX_WARPS``)."""
    return 1024 if k == 1 else 512 if k <= 4 else 256 if k == 8 else 128


def item_bytes(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def check_shape(g, h, w, cpw, planes, warps, k, splits, batch, nbuf, smem,
                stage_bytes, bands=1, extra=0, direct=False) -> str | None:
    """The source's ``check_shape``: None when the shape can run, else why
    not (the C side returns ``cudaErrorInvalidValue`` for all of these)."""
    if k not in (1, 2, 4, 8, 16, 32):
        return f"k={k} is not a power of two up to 32"
    if direct:
        if not (k <= 4 and 1 <= bands <= 32 and 32 * k > 2 * h):
            return (f"direct windows need k <= 4, 1..32 windows a CTA and "
                    f"32k > 2H, got k={k}, bands={bands}, H={h}")
    else:
        if not (bands == 1 or (bands in (2, 4, 8, 16, 32) and k <= 4
                               and planes <= MAX_PLANES_BANDED)):
            return (f"bands={bands} need a power of two, k <= 4 and at most "
                    f"{MAX_PLANES_BANDED} planes")
        if 32 * k * bands < w:
            return f"32·k·bands = {32 * k * bands} columns < W={w}"
    if g < 1 or h < 1 or w < 1 or cpw < 1 or g % cpw:
        return f"operands G={g}, H={h}, W={w}, cpw={cpw}"
    if planes < 1 or warps < planes * bands:
        return f"{warps} warps for {planes} planes of {bands} bands"
    if 32 * warps > max_threads(k):
        return (f"{warps} warps exceed the {max_threads(k)} threads the "
                f"registers allow at k={k}")
    if splits < 1 or planes * splits < cpw or planes * (splits - 1) >= cpw:
        return f"{splits} splits of {planes} planes do not cover cpw={cpw}"
    if batch < 1 or not 1 <= nbuf <= MAX_BUFS:
        return f"batch={batch}, nbuf={nbuf} (1..{MAX_BUFS})"
    if nbuf == 1 and batch < h:
        return f"one batch of {batch} rows does not hold the plane of {h}"
    if nbuf * stage_bytes + extra > smem:
        return f"the ring needs {nbuf * stage_bytes + extra} B > smem={smem}"
    if smem > SMEM_MAX:
        return f"smem={smem} B exceeds {SMEM_MAX}"
    return None


def refusal(kind: str, ndir: int, g: int, h: int, w: int, cpw: int,
            item: int, s, chunk: int = 0) -> str | None:
    """Why the entry point (``gspn_fwd_launch`` for ``kind="fwd"``,
    ``gspn_bwd_launch`` for ``"bwd"``) would refuse the launch shape
    ``s`` (a PairLaunch), or None when it runs it."""
    # A stage: the ring's bytes for one batch, as the source lays it out.
    stage = _gs.ring_bytes(kind, ndir, w, item, s.planes, s.batch, 1,
                           s.xpitch)
    if kind == "fwd":
        quad = ndir == 4
        if ndir not in (1, 2, 4):
            return f"the forward runs 1, 2 or 4 directions, not {ndir}"
        if quad and (h != w or chunk > 0
                     or s.xpitch < _gs._slab_words(s.batch, item)):
            return (f"the quad needs a square grid, no chunk and a slab "
                    f"pitch of at least {_gs._slab_words(s.batch, item)} "
                    f"words")
        if not quad and s.xpitch != 0:
            return "only the quad has a slab pitch"
        if s.bands != 1 or s.direct:
            return "only the single adjoint has bands or windows"
        return check_shape(g, h, w, cpw, s.planes, s.warps, s.k, s.splits,
                           s.batch, s.nbuf, s.smem_bytes, stage)
    if kind != "bwd" or ndir not in (1, 2):
        return f"the adjoint runs 1 or 2 directions, not {kind} {ndir}"
    if ndir == 2 and (s.bands != 1 or s.direct):
        return "only the single adjoint has bands or windows"
    if s.xpitch != 0:
        return "only the quad has a slab pitch"
    if s.direct:
        stage = 0
    extra = _gs.edge_bytes(s.warps) if s.bands > 1 and not s.direct else 0
    return check_shape(g, h, w, cpw, s.planes, s.warps, s.k, s.splits,
                       s.batch, s.nbuf, s.smem_bytes, stage, s.bands, extra,
                       s.direct)


def launch_shape(g: int, h: int, w: int, cpw: int, dtype: torch.dtype,
                 kind: str, ndir: int, *, planes: int, warps: int,
                 splits: int, batch: int, nbuf: int, bands: int = 1,
                 direct: bool = False, window_k: int = 0):
    """The PairLaunch of a shape given by its free fields, the rest derived
    as ``pair_launch_shape`` derives them: columns per lane ``k`` from W and
    the bands (``window_k`` for direct windows), the quad's odd slab pitch
    from the batch, the ring's bytes, and the grid (G_w, splits × the CTAs
    that share a row's windows, D).  Raises ValueError on a shape the
    fields cannot describe; admission is :func:`admit`'s."""
    item = item_bytes(dtype)
    groups = 1
    if direct:
        if window_k not in (1, 2, 4) or 32 * window_k - 2 * h < 1:
            raise ValueError(f"direct windows of window_k={window_k} at "
                             f"H={h}")
        k = window_k
        windows = -(-w // (32 * k - 2 * h))
        groups = -(-windows // bands)
        batch, nbuf, smem, pitch = h, 1, 0, 0
    else:
        if window_k:
            raise ValueError("window_k: only direct windows have it")
        k0 = 1 << max(0, math.ceil(w / 32) - 1).bit_length()
        if bands < 1 or bands > k0:
            raise ValueError(f"bands={bands} at W={w}: at most {k0}")
        k = k0 // bands
        pitch = _gs._slab_words(batch, item) | 1 if ndir == 4 else 0
        smem = _gs.ring_bytes(kind, ndir, w, item, planes, batch, nbuf,
                              pitch)
        if bands > 1:
            smem += _gs.edge_bytes(warps)
    return _gs.PairLaunch(
        planes=planes, warps=warps, k=k, splits=splits, stages=nbuf * batch,
        batch=batch, nbuf=nbuf, grid=(g // cpw, splits * groups, ndir),
        smem_bytes=smem, xpitch=pitch, bands=bands, direct=bool(direct))


def admit(g: int, h: int, w: int, cpw: int, dtype: torch.dtype, kind: str,
          ndir: int, s) -> str | None:
    """None when launch shape ``s`` is admitted for these operands, else
    the reason: the shape must be what :func:`launch_shape` derives from
    its own free fields, keep a batch within the plane, and pass the C
    side's checks (:func:`refusal`: the shared memory, the register
    budget, the ring)."""
    if w > _gs._MAX_W:
        return f"W={w} exceeds {_gs._MAX_W} columns"
    if s.batch > h:
        return f"a batch of {s.batch} rows is longer than the plane of {h}"
    try:
        derived = launch_shape(
            g, h, w, cpw, dtype, kind, ndir, planes=s.planes, warps=s.warps,
            splits=s.splits, batch=s.batch, nbuf=s.nbuf, bands=s.bands,
            direct=s.direct, window_k=s.k if s.direct else 0)
    except ValueError as exc:
        return str(exc)
    if derived != s:
        return f"the shape's derived fields differ: {s} != {derived}"
    return refusal(kind, ndir, g, h, w, cpw, item_bytes(dtype), s)
