#!/usr/bin/env python3
"""Time the scan kernels of ``src/repro_torch/kernels/csrc/gspn_pair.cu``
over launch shapes on one CUDA card, at the vision main path's shapes:
the forward template at D = 1 (#1), 2 (#3) and 4 (#5) and the pair
adjoint (#4).

    python3 tools/pair_launch_sweep.py

For G = 128 planes, cpw = 2, float32 and N = 56 / 28 / 14 / 7, each
kernel runs with the shape ``gspn_scan.pair_launch_shape`` picks and with
other shapes, each checked against the plain version (1e-5 of the largest
magnitude) and timed warm (CUDA-graph replays of 10 launches, median of
20) and cold (the L2 flushed before each of 20 timed launches, median),
with ``chip_smoke.py``'s timers:

- the pair (D = 2) and its adjoint: the plane in 1, 2, 3 or 4 ring
  batches, and 2 or 4 warps per CTA;
- the single scan (D = 1): the whole weight group in one CTA (64 CTAs of
  two planes) or one plane per CTA (128 CTAs, each staging the group's
  taps again), each in 1 or 2 batches;
- the quad (D = 4): the column slab's pitch padded to an odd number of
  words (conflict-free reads) or left at the words a run needs (56 or 28
  at N = 56 or 28: 8 or 4 lanes on one bank), each in 1 or 2 batches.

Then the quad at 1024² (G = 32, N = 256, its planes streaming through the
ring), one or two planes per CTA (64 or 128 CTAs on the card's 132 SMs),
and the cost of a row: the default shape of the pair at H = 512 and H =
1024 rows (W = 28 and 56), the difference over 512 rows.  Prints one line
per measurement and, first, the card's name and power limit; exits 1
without a card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import _cold_ms, _graph_ms  # noqa: E402

G, CPW = 128, 2


def _operands(gen, h, w, kind, ndir, g=G):
    """(x, wl, wc, wr, lam) of a forward over ``ndir`` directions, or
    (dy, wl, wc, wr) of the pair adjoint, on ``g`` planes."""
    lead = (ndir,) if ndir > 1 else ()
    taps = torch.softmax(torch.randn(lead + (g // CPW, h, w, 3),
                                     generator=gen, device="cuda"), dim=-1)
    first = torch.randn((g, h, w) if kind == "fwd" else (2, g, h, w),
                        generator=gen, device="cuda")
    args = [first] + [taps[..., i].contiguous() for i in range(3)]
    if kind == "fwd":
        args.append(torch.rand(lead + (g, h, w), generator=gen,
                               device="cuda"))
    return args


def _launcher(kind, ndir, args, shape):
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
            err = lib.gspn_fwd_launch(ndir, 0, *ptrs, g, h, w, CPW, 0, *sh,
                                      shape.xpitch, shape.smem_bytes, stream)
        else:
            err = lib.gspn_pair_bwd_launch(0, *ptrs, g, h, w, CPW, 0, *sh,
                                           shape.smem_bytes, stream)
        cuda_lib.check(lib, err, f"{kind} D={ndir}")
    return call, out


def _variant(shape, h, w, kind, ndir, batches=None, warps=None, planes=None,
             pad=True):
    """``shape`` with the H rows cut into ``batches`` batches, ``warps``
    warps per CTA, ``planes`` planes per CTA (a streamed ring shortened,
    as ``pair_launch_shape`` does, until it fits) and, for the quad, the
    slab pitch left unpadded (``pad=False``); the ring's bytes
    recomputed."""
    from repro_torch.kernels.gspn_scan import (BATCHES, SMEM_MAX,
                                               _slab_words, ring_bytes)

    if batches is not None:
        batch = -(-h // batches)
        nbuf = -(-h // batch)
        shape = shape._replace(batch=batch, nbuf=nbuf, stages=nbuf * batch)
    if planes is not None:
        splits = -(-CPW // planes)
        shape = shape._replace(planes=planes, splits=splits,
                               grid=(shape.grid[0], splits, shape.grid[2]))
    if warps is not None:
        shape = shape._replace(warps=warps)

    def pitch(batch):
        if ndir != 4:
            return 0
        words = _slab_words(batch, 4)
        return words | 1 if pad else words

    def size(s):
        return ring_bytes(kind, ndir, w, 4, s.planes, s.batch, s.nbuf,
                          pitch(s.batch))

    rows = shape.stages
    while shape.nbuf > 1 and size(shape) > SMEM_MAX:
        rows -= 1
        batch = -(-rows // BATCHES)
        shape = shape._replace(batch=batch, nbuf=rows // batch,
                               stages=rows // batch * batch)
    shape = shape._replace(xpitch=pitch(shape.batch))
    return shape._replace(smem_bytes=size(shape))


def _variants(base, n, kind, ndir):
    """name -> launch shape of every variant swept for this kernel."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import gspn_multidir as mk
    from repro_torch.kernels import gspn_scan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    plain = {("fwd", 1): gspn_scan.gspn_scan_fwd_torch,
             ("fwd", 2): mk.gspn_scan_bidir_torch,
             ("fwd", 4): mk.gspn_scan_quad_torch,
             ("bwd", 2): mk.gspn_scan_bidir_bwd_torch}
    cases = [(G, n, kind, ndir, None) for n in (56, 28, 14, 7)
             for kind, ndir in plain]
    cases += [(32, 256, "fwd", 4, {f"planes={p}": p for p in (CPW, 1)})]
    for g, n, kind, ndir, planes in cases:
        args = _operands(gen, n, n, kind, ndir, g)
        want = plain[kind, ndir](*args)
        scale = want.abs().max().item()
        base = gspn_scan.pair_launch_shape(g, n, n, CPW, torch.float32,
                                           kind, ndir)
        variants = _variants(base, n, kind, ndir) if planes is None else {
            name: _variant(base, n, n, kind, ndir, planes=p)
            for name, p in planes.items()}
        for name, shape in variants.items():
            call, out = _launcher(kind, ndir, args, shape)
            call()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if not err <= 1e-5 * scale:
                raise AssertionError(f"{kind} D={ndir} N={n} {name}: "
                                     f"error {err}")
            mark = " (default)" if shape == base else ""
            print(f"sweep {kind} D={ndir} G={g} N={n} {name}{mark} (planes="
                  f"{shape.planes} warps={shape.warps} batch={shape.batch} "
                  f"nbuf={shape.nbuf} xpitch={shape.xpitch} smem="
                  f"{shape.smem_bytes}): warm {_graph_ms(call, 10) * 1e3:.2f}"
                  f" us, cold {_cold_ms(call) * 1e3:.2f} us", flush=True)
    for w in (28, 56):
        for kind in ("fwd", "bwd"):
            us = {}
            for h in (512, 1024):
                shape = gspn_scan.pair_launch_shape(G, h, w, CPW,
                                                    torch.float32, kind)
                call, _ = _launcher(kind, 2, _operands(gen, h, w, kind, 2),
                                    shape)
                us[h] = _graph_ms(call, 3, n=10) * 1e3
            print(f"rows {kind} W={w}: H=512 {us[512]:.2f} us, H=1024 "
                  f"{us[1024]:.2f} us, {(us[1024] - us[512]) / 512 * 1e3:.1f}"
                  f" ns a row", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
