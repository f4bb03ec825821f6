#!/usr/bin/env python3
"""Time the pair scan kernels (#3 forward, #4 adjoint) of
``src/repro_torch/kernels/csrc/gspn_pair.cu`` over launch shapes on one
CUDA card, at the vision main path's shapes.

    python3 tools/pair_launch_sweep.py

For G = 128 planes, cpw = 2, float32 and N = 56 / 28 / 14 / 7, each
kernel runs with the shape ``gspn_multidir.pair_launch_shape`` picks and
with other ring batchings (the plane in 1, 2, 3 or 4 batches) and other warp
counts (2, 4 or 8 warps per CTA), each checked against the plain version
(1e-5 of the largest magnitude) and timed warm (CUDA-graph replays of 10
launches, median of 20) and cold (the L2 flushed before each of 20
timed launches, median), with ``chip_smoke.py``'s timers.  Then the cost of a row: the default
shape at H = 512 and H = 1024 rows (W = 28 and 56), the difference over
512 rows.  Prints one line per measurement and, first, the card's name
and power limit; exits 1 without a card.
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


def _operands(gen, h, w, kind):
    taps = torch.softmax(torch.randn((2, G // CPW, h, w, 3), generator=gen,
                                     device="cuda"), dim=-1)
    first = torch.randn((G, h, w) if kind == "fwd" else (2, G, h, w),
                        generator=gen, device="cuda")
    args = [first] + [taps[..., i].contiguous() for i in range(3)]
    if kind == "fwd":
        args.append(torch.rand((2, G, h, w), generator=gen, device="cuda"))
    return args


def _launcher(kind, args, shape):
    """A call of the kernel of ``kind`` on ``args`` with launch ``shape``
    (a PairLaunch), through the library's C entry."""
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("gspn_pair")
    entry = lib.gspn_pair_launch if kind == "fwd" else lib.gspn_pair_bwd_launch
    h, w = args[0].shape[-2:]
    out = torch.empty((2, G, h, w), device="cuda")

    def call():  # holds args and out alive as long as it is called
        ptrs = [a.data_ptr() for a in (*args, out)]
        err = entry(0, *ptrs, G, h, w, CPW, 0, shape.planes, shape.warps,
                    shape.k, shape.splits, shape.batch, shape.nbuf,
                    shape.smem_bytes, torch.cuda.current_stream().cuda_stream)
        cuda_lib.check(lib, err, f"gspn_pair {kind}")
    return call, out


def _variant(shape, h, w, kind, batches=None, warps=None):
    """``shape`` with the H rows cut into ``batches`` batches and/or
    ``warps`` warps per CTA."""
    from repro_torch.kernels.gspn_multidir import _region_bytes

    if batches is not None:
        batch = -(-h // batches)
        nbuf = -(-h // batch)
        per_plane = 2 if kind == "fwd" else 1
        shape = shape._replace(
            batch=batch, nbuf=nbuf, stages=nbuf * batch,
            smem_bytes=nbuf * (3 + per_plane * shape.planes)
            * _region_bytes(batch, w, 4))
    if warps is not None:
        shape = shape._replace(warps=warps)
    return shape


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import gspn_multidir as mk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    plain = {"fwd": mk.gspn_scan_bidir_torch,
             "bwd": mk.gspn_scan_bidir_bwd_torch}
    for n in (56, 28, 14, 7):
        for kind in ("fwd", "bwd"):
            args = _operands(gen, n, n, kind)
            want = plain[kind](*args)
            scale = want.abs().max().item()
            base = mk.pair_launch_shape(G, n, n, CPW, torch.float32, kind)
            variants = {"default": base}
            variants.update({f"batches={b}": _variant(base, n, n, kind,
                                                      batches=b)
                             for b in (2, 3, 4)})
            variants.update({f"warps={v}": _variant(base, n, n, kind, warps=v)
                             for v in (2, 4) if v != base.warps})
            for name, shape in variants.items():
                call, out = _launcher(kind, args, shape)
                call()
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                if not err <= 1e-5 * scale:
                    raise AssertionError(f"{kind} N={n} {name}: error {err}")
                print(f"sweep {kind} N={n} {name} (warps={shape.warps} "
                      f"batch={shape.batch} nbuf={shape.nbuf}): warm "
                      f"{_graph_ms(call, 10) * 1e3:.2f} us, cold "
                      f"{_cold_ms(call) * 1e3:.2f} us", flush=True)
    for w in (28, 56):
        for kind in ("fwd", "bwd"):
            us = {}
            for h in (512, 1024):
                shape = mk.pair_launch_shape(G, h, w, CPW, torch.float32, kind)
                call, _ = _launcher(kind, _operands(gen, h, w, kind), shape)
                us[h] = _graph_ms(call, 3, n=10) * 1e3
            print(f"rows {kind} W={w}: H=512 {us[512]:.2f} us, H=1024 "
                  f"{us[1024]:.2f} us, {(us[1024] - us[512]) / 512 * 1e3:.1f}"
                  f" ns a row", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
