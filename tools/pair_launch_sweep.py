#!/usr/bin/env python3
"""Time the scan kernels of ``src/repro_torch/kernels/csrc/gspn_pair.cu``
over launch shapes on one CUDA card: the forward template at D = 1 (#1),
2 (#3) and 4 (#5) and the adjoint template at D = 1 (#2) and 2 (#4).

    python3 tools/pair_launch_sweep.py [--only KIND ...]

Each kernel runs with the shape ``gspn_scan.pair_launch_shape`` picks and
with other shapes, each checked against the plain version (1e-5 of the
largest magnitude) and timed warm (CUDA-graph replays of 10 launches, 2
above 50 µs, median of 20) and cold (the L2 flushed before each of 20
timed launches, median), with ``chip_smoke.py``'s timers.  ``--only``
runs the named parts alone (``main``, ``bwd1``, ``quad1024``, ``rows``).

- ``main``: G = 128 planes, cpw = 2, float32, N = 56 / 28 / 14 / 7:
  - the pair (D = 2) and its adjoint: the plane in 1, 2, 3 or 4 ring
    batches, and 2 or 4 warps per CTA;
  - the single scan (D = 1): the whole weight group in one CTA (64 CTAs
    of two planes) or one plane per CTA (128 CTAs, each staging the
    group's taps again), each in 1 or 2 batches;
  - the quad (D = 4): the column slab's pitch padded to an odd number of
    words (conflict-free reads) or left at the words a run needs (56 or
    28 at N = 56 or 28: 8 or 4 lanes on one bank), each in 1 or 2
    batches.
- ``bwd1``: the single adjoint (D = 1), float32: at the main widths one
  or two planes per CTA (128 or 64 CTAs), in 1 or 2 batches; at 1024² (G
  = 32, cpw 2, N = 256), the LM mixer's T→B pass (G = 128, cpw 8, H = 4,
  W = 1024; and at G = 512, four times the batch) and its chunked shape
  (H = 32, chunk 8) the default shape and the row spread over
  1 to 32 warps of a plane from the ring (``bands``; 1 is one warp per
  plane at K = 8 or 32 columns per lane) with one or two planes per CTA,
  or walked in windows of 32, 64 or 128 columns straight from device
  memory (``direct``, where a window is wider than 2H), as many windows
  to a CTA as the registers allow or 4; at the LM's
  within-row pass (H = 1024, W = 4) one to eight planes per CTA.  Then
  ``bwd1`` times windows against 8 bands from the ring over H = 1…32 at
  W = 1024 (G = 128, cpw 8), to place ``DIRECT_ROWS``.
- ``quad1024``: the quad at 1024² (G = 32, N = 256, its planes streaming
  through the ring), one or two planes per CTA (64 or 128 CTAs on the
  card's 132 SMs).
- ``rows``: the cost of a row: the default shape of the pair at H = 512
  and H = 1024 rows (W = 28 and 56), the difference over 512 rows.

Prints one line per measurement and, first, the card's name and power
limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import _cold_ms, _graph_ms  # noqa: E402

G, CPW = 128, 2
PARTS = ("main", "bwd1", "quad1024", "rows")


def _operands(gen, g, h, w, cpw, kind, ndir):
    """(x, wl, wc, wr, lam) of a forward over ``ndir`` directions, or
    (dy, wl, wc, wr) of the adjoint over ``ndir``, on ``g`` planes."""
    lead = (ndir,) if ndir > 1 else ()
    taps = torch.softmax(torch.randn(lead + (g // cpw, h, w, 3),
                                     generator=gen, device="cuda"), dim=-1)
    first = torch.randn((g, h, w) if kind == "fwd" else lead + (g, h, w),
                        generator=gen, device="cuda")
    args = [first] + [taps[..., i].contiguous() for i in range(3)]
    if kind == "fwd":
        args.append(torch.rand(lead + (g, h, w), generator=gen,
                               device="cuda"))
    return args


def _launcher(kind, ndir, args, cpw, chunk, shape):
    """A call of the kernel of ``kind`` over ``ndir`` directions on
    ``args`` with launch ``shape`` (a PairLaunch), through the library's C
    entry."""
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("gspn_pair")
    g = args[0].shape[-3]
    h, w = args[0].shape[-2:]
    out = torch.empty(((ndir,) if ndir > 1 else ()) + (g, h, w),
                      device="cuda")
    sh = (shape.planes, shape.warps, shape.k, shape.splits, shape.batch,
          shape.nbuf)

    def call():  # holds args and out alive as long as it is called
        ptrs = [a.data_ptr() for a in (*args, out)]
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "fwd":
            err = lib.gspn_fwd_launch(ndir, 0, *ptrs, g, h, w, cpw, chunk,
                                      *sh, shape.xpitch, shape.smem_bytes,
                                      stream)
        else:
            err = lib.gspn_bwd_launch(ndir, 0, *ptrs, g, h, w, cpw, chunk,
                                      *sh, shape.bands, int(shape.direct),
                                      shape.smem_bytes, stream)
        cuda_lib.check(lib, err, f"{kind} D={ndir}")
    return call, out


def _variant(shape, h, w, kind, ndir, batches=None, warps=None, planes=None,
             pad=True, cpw=CPW):
    """``shape`` with the H rows cut into ``batches`` batches, ``warps``
    warps per CTA, ``planes`` planes per CTA (a streamed ring shortened,
    as ``pair_launch_shape`` does, until it fits) and, for the quad, the
    slab pitch left unpadded (``pad=False``); the ring's bytes
    recomputed."""
    from repro_torch.kernels.gspn_scan import (BATCHES, SMEM_MAX,
                                               _slab_words, edge_bytes,
                                               ring_bytes)

    if batches is not None:
        batch = -(-h // batches)
        nbuf = -(-h // batch)
        shape = shape._replace(batch=batch, nbuf=nbuf, stages=nbuf * batch)
    if planes is not None:
        splits = -(-cpw // planes)
        shape = shape._replace(planes=planes, splits=splits,
                               grid=(shape.grid[0], splits, shape.grid[2]),
                               warps=planes * shape.bands if shape.direct
                               else max(shape.warps, planes * shape.bands))
    if warps is not None:
        shape = shape._replace(warps=warps)

    def pitch(batch):
        if ndir != 4:
            return 0
        words = _slab_words(batch, 4)
        return words | 1 if pad else words

    def size(s):
        if s.direct:
            return 0
        edges = edge_bytes(s.warps) if s.bands > 1 else 0
        return ring_bytes(kind, ndir, w, 4, s.planes, s.batch, s.nbuf,
                          pitch(s.batch)) + edges

    rows = shape.stages
    while not shape.direct and shape.nbuf > 1 and size(shape) > SMEM_MAX:
        rows -= 1
        batch = -(-rows // BATCHES)
        shape = shape._replace(batch=batch, nbuf=rows // batch,
                               stages=rows // batch * batch)
    shape = shape._replace(xpitch=pitch(shape.batch))
    return shape._replace(smem_bytes=size(shape))


def _variants(base, n, kind, ndir):
    """name -> launch shape of every variant swept for this kernel at the
    main widths."""
    if ndir == 1:
        return {f"planes={p} batches={b}": _variant(base, n, n, kind, ndir,
                                                    batches=b, planes=p)
                for p in (CPW, 1) for b in (1, 2)}
    if ndir == 4:
        return {f"pitch={'odd' if pad else 'unpadded'} batches={b}":
                _variant(base, n, n, kind, ndir, batches=b, pad=pad)
                for pad in (True, False) for b in (1, 2)}
    variants = {"default": base}
    variants.update({f"batches={b}": _variant(base, n, n, kind, ndir,
                                               batches=b) for b in (2, 3, 4)})
    variants.update({f"warps={v}": _variant(base, n, n, kind, ndir, warps=v)
                     for v in (2, 4) if v != base.warps})
    return variants


def _bwd1_variants(g, h, w, cpw):
    """name -> launch shape of the single adjoint's variants at a shape
    beyond the main widths."""
    from repro_torch.kernels.gspn_scan import _MAX_WARPS, pair_launch_shape

    def shape(planes=None, **layout):
        base = pair_launch_shape(g, h, w, cpw, torch.float32, "bwd", 1,
                                 **layout)
        return _variant(base, h, w, "bwd", 1, planes=planes, cpw=cpw) \
            if planes else base

    if w <= 128:  # whole rows: planes per CTA
        return {f"planes={p}": shape(p) for p in (1, 2, 4, 8) if p <= cpw}
    k = 1 << max(0, -(-w // 32) - 1).bit_length()
    variants = {"default": shape()}
    for bands in (1, 2, 4, 8, 16, 32):
        if bands > 1 and not 1 <= k // bands <= 4:
            continue
        for p in (1, 2):
            if p * bands <= _MAX_WARPS[k // bands]:
                variants[f"bands={bands} planes={p}"] = \
                    shape(p, bands=bands, direct=False)
    for window_k in (1, 2, 4):  # windows of 32, 64 or 128 columns
        if 32 * window_k > 2 * h:
            windows = -(-w // (32 * window_k - 2 * h))
            for per in sorted({min(windows, _MAX_WARPS[window_k]), 4}):
                variants[f"direct window_k={window_k} windows/CTA={per}"] = \
                    shape(direct=True, window_k=window_k, bands=per)
    return variants


def _run(gen, g, h, w, cpw, kind, ndir, variants, chunk=None):
    """Check and time every variant of one kernel at one shape."""
    from repro_torch.kernels import gspn_multidir as mk
    from repro_torch.kernels import gspn_scan

    plain = {("fwd", 1): gspn_scan.gspn_scan_fwd_torch,
             ("fwd", 2): mk.gspn_scan_bidir_torch,
             ("fwd", 4): mk.gspn_scan_quad_torch,
             ("bwd", 1): gspn_scan.gspn_scan_bwd_torch,
             ("bwd", 2): mk.gspn_scan_bidir_bwd_torch}[kind, ndir]
    args = _operands(gen, g, h, w, cpw, kind, ndir)
    kw = {} if ndir == 4 else {"chunk": chunk}
    want = plain(*args, **kw)
    scale = want.abs().max().item()
    base = gspn_scan.pair_launch_shape(g, h, w, cpw, torch.float32, kind,
                                       ndir)
    c = gspn_scan.chunk_arg(h, chunk)
    for name, shape in variants.items():
        call, out = _launcher(kind, ndir, args, cpw, c, shape)
        call()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{kind} D={ndir} G={g} H={h} W={w} "
                                 f"{name}: error {err}")
        warm = _graph_ms(call, 10) * 1e3
        if warm > 50:
            warm = _graph_ms(call, 2) * 1e3
        mark = " (default)" if shape == base else ""
        print(f"sweep {kind} D={ndir} G={g} H={h} W={w} cpw={cpw} chunk="
              f"{chunk} {name}{mark} (planes={shape.planes} warps="
              f"{shape.warps} k={shape.k} bands={shape.bands} direct="
              f"{int(shape.direct)} splits={shape.splits} batch={shape.batch}"
              f" nbuf={shape.nbuf} xpitch="
              f"{shape.xpitch} smem={shape.smem_bytes}): warm {warm:.2f}"
              f" us, cold {_cold_ms(call) * 1e3:.2f} us", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import gspn_scan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "main" in args.only:
        for n in (56, 28, 14, 7):
            for kind, ndir in (("fwd", 1), ("fwd", 2), ("fwd", 4),
                               ("bwd", 2)):
                base = gspn_scan.pair_launch_shape(G, n, n, CPW,
                                                   torch.float32, kind, ndir)
                _run(gen, G, n, n, CPW, kind, ndir,
                     _variants(base, n, kind, ndir))
    if "bwd1" in args.only:
        for n in (56, 28, 14, 7):
            base = gspn_scan.pair_launch_shape(G, n, n, CPW, torch.float32,
                                               "bwd", 1)
            _run(gen, G, n, n, CPW, "bwd", 1,
                 {f"planes={p} batches={b}": _variant(base, n, n, "bwd", 1,
                                                      batches=b, planes=p)
                  for p in (1, CPW) for b in (1, 2)})
        for g, h, w, cpw, chunk in ((32, 256, 256, 2, None),
                                    (128, 4, 1024, 8, None),
                                    (512, 4, 1024, 8, None),
                                    (128, 32, 1024, 8, 8),
                                    (128, 1024, 4, 8, None)):
            _run(gen, g, h, w, cpw, "bwd", 1, _bwd1_variants(g, h, w, cpw),
                 chunk)
        for h in (1, 2, 8, 16, 20, 24, 32):
            _run(gen, 128, h, 1024, 8, "bwd", 1, {
                name: gspn_scan.pair_launch_shape(
                    128, h, 1024, 8, torch.float32, "bwd", 1, **layout)
                for name, layout in (("direct", {"direct": True}),
                                     ("bands=8", {"bands": 8}))})
    if "quad1024" in args.only:
        base = gspn_scan.pair_launch_shape(32, 256, 256, CPW, torch.float32,
                                           "fwd", 4)
        _run(gen, 32, 256, 256, CPW, "fwd", 4,
             {f"planes={p}": _variant(base, 256, 256, "fwd", 4, planes=p)
              for p in (CPW, 1)})
    if "rows" in args.only:
        for w in (28, 56):
            for kind in ("fwd", "bwd"):
                us = {}
                for h in (512, 1024):
                    shape = gspn_scan.pair_launch_shape(G, h, w, CPW,
                                                        torch.float32, kind)
                    call, _ = _launcher(
                        kind, 2, _operands(gen, G, h, w, CPW, kind, 2), CPW,
                        0, shape)
                    us[h] = _graph_ms(call, 3, n=10) * 1e3
                print(f"rows {kind} W={w}: H=512 {us[512]:.2f} us, H=1024 "
                      f"{us[1024]:.2f} us, "
                      f"{(us[1024] - us[512]) / 512 * 1e3:.1f} ns a row",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
