#!/usr/bin/env python3
"""Compare the scan kernels' device time per launch between checkouts of
the PyTorch port, on one CUDA card, in alternating fresh processes.

    python3 tools/ab_kernels.py parent=path/to/a change=path/to/b \\
        --order ABBAABBAABBAABBAABBA

Each leg is a fresh process that imports ``repro_torch`` from one
checkout's ``src`` and times, through the public wrappers, the single
scan #1 (``gspn_scan_fwd``), the pair #3 (``gspn_scan_bidir``), its
adjoint #4 (``gspn_scan_bidir_bwd``) and the quad #5 (``gspn_scan_quad``)
at the vision main path's shapes (G = 128, cpw = 2, float32, N = 56 / 28
/ 14 / 7), on operands made from seed 0: CUDA-graph replays of 10
launches, median of 20, with ``chip_smoke.py``'s timer.  ``--order``
names the legs by checkout, A for the first argument, B for the second.
For each kernel and N it prints both sides' medians over their legs, the
spread between the quartiles of each side's legs, and in how many of the
order's AB pairs (legs 1-2, 3-4, ...) the second checkout was faster.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
G, CPW = 128, 2
WIDTHS = (56, 28, 14, 7)


def leg(src: str) -> dict:
    """µs per launch of each kernel at each width, from the checkout whose
    ``src`` is given."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    from chip_smoke import _graph_ms
    from repro_torch.kernels import gspn_multidir as mk
    from repro_torch.kernels import gspn_scan

    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(n, lead):
        taps = torch.softmax(torch.randn(lead + (G // CPW, n, n, 3),
                                         generator=gen, device="cuda"), -1)
        x = torch.randn((G, n, n), generator=gen, device="cuda")
        lam = torch.rand(lead + (G, n, n), generator=gen, device="cuda")
        return [x] + [taps[..., i].contiguous() for i in range(3)] + [lam]

    out = {}
    for n in WIDTHS:
        single, pair, quad = (operands(n, lead) for lead in ((), (2,), (4,)))
        dy = torch.randn((2, G, n, n), generator=gen, device="cuda")
        calls = {
            "#1 gspn_scan_fwd": lambda: gspn_scan.gspn_scan_fwd(*single),
            "#3 gspn_scan_bidir": lambda: mk.gspn_scan_bidir(*pair),
            "#4 gspn_scan_bidir_bwd": lambda: mk.gspn_scan_bidir_bwd(
                dy, *pair[1:4]),
            "#5 gspn_scan_quad": lambda: mk.gspn_scan_quad(*quad),
        }
        for name, fn in calls.items():
            out[f"{name} N={n}"] = _graph_ms(fn, 10) * 1e3
    return out


def _quartile_spread(values: list[float]) -> float:
    if len(values) < 2:
        return 0.0
    q = statistics.quantiles(values, n=4)
    return q[2] - q[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CHECKOUT")
    ap.add_argument("--order", default="ABBAABBAABBAABBAABBA")
    ap.add_argument("--leg", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if args.leg:
        print(json.dumps(leg(args.leg)))
        return 0
    if len(args.trees) != 2:
        ap.error("name two checkouts, NAME=CHECKOUT each")
    trees = dict(zip("AB", (t.split("=", 1) for t in args.trees)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    legs = []
    for i, key in enumerate(args.order):
        name, path = trees[key]
        src = str(pathlib.Path(path).resolve() / "src")
        res = subprocess.run([sys.executable, __file__, "--leg", src],
                             check=True, capture_output=True, text=True)
        legs.append((key, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"leg {i + 1} {name}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in legs[-1][1].items()), flush=True)
    (a_name, _), (b_name, _) = trees["A"], trees["B"]
    pairs = [(legs[i], legs[i + 1]) for i in range(0, len(legs) - 1, 2)
             if {legs[i][0], legs[i + 1][0]} == {"A", "B"}]
    for case in legs[0][1]:
        side = {k: [r[case] for key, r in legs if key == k] for k in "AB"}
        wins = sum(1 for p in pairs
                   if dict(p)["B"][case] < dict(p)["A"][case])
        print(f"{case}: {a_name} median {statistics.median(side['A']):.2f}"
              f" us (quartile spread {_quartile_spread(side['A']):.2f}), "
              f"{b_name} median {statistics.median(side['B']):.2f} us "
              f"(spread {_quartile_spread(side['B']):.2f}), {b_name} faster"
              f" in {wins} of {len(pairs)} pairs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
