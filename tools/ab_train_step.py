#!/usr/bin/env python3
"""Compare the eager host cost of GSPN-2-T's loss and gradients between
checkouts of the PyTorch port, on one CUDA card.

    python3 tools/ab_train_step.py parent=path/to/a change=path/to/b \\
        --order ABBAABBA --runs 20

Each leg is a fresh process that imports ``repro_torch`` from one
checkout's ``src``, builds GSPN-2-T (224², batch 64, f32, TF32 off,
weights from seed 0, ``synth_images``), runs ``vision_loss`` and
``torch.autograd.grad`` three times to warm up, then times ``--runs``
calls one by one on the host clock, the card synchronised before and
after each.  ``--order`` names the legs by checkout, A for the first
argument, B for the second.  Where the checkout has the kernel layer's
span helpers (``ops._dispatch_span``, ``gspn_scan._span``), the leg also
counts their calls in one step and times 100000 calls of each with
tracing off, which bounds the host time they add to a step.

``--smoke`` runs each leg on the CPU with the reduced model, batch 4,
to check the script itself.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

BATCH = 64


def _sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _helper_cost(step, x) -> dict:
    """Calls of the span helpers in one ``step`` and µs per call of each,
    tracing off; empty where the checkout has none."""
    from repro_torch.kernels import gspn_scan, ops

    if not hasattr(ops, "_dispatch_span"):
        return {}
    calls = {"dispatch": 0, "launch": 0}
    originals = (ops._dispatch_span, gspn_scan._span)

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    ops._dispatch_span = counted("dispatch", originals[0])
    gspn_scan._span = counted("launch", originals[1])
    try:
        step()
    finally:
        ops._dispatch_span, gspn_scan._span = originals
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with ops._dispatch_span("gspn_scan_pair_bwd", "cuda", x):
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        with gspn_scan._span("gspn_pair_bwd", 128, 56, 56, x.dtype):
            pass
    t2 = time.perf_counter()
    return {"calls_per_step": calls,
            "dispatch_us": (t1 - t0) / n * 1e6,
            "launch_us": (t2 - t1) / n * 1e6}


def leg(src: str, runs: int, smoke: bool) -> dict:
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.configs.gspn2_vision import GSPN2_T, reduced_vision
    from repro_torch.data.pipeline import DataConfig, synth_images
    from repro_torch.models.vision import GSPNVision, vision_loss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, dev, batch_size = ((reduced_vision(), "cpu", 4) if smoke
                            else (GSPN2_T, "cuda", BATCH))
    model = GSPNVision(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_images(
        DataConfig(1, 1, batch_size, seed=0), 0, cfg.img_size,
        cfg.n_classes).items()}
    params = list(model.parameters())

    def step():
        loss, _ = vision_loss(model, batch)
        return torch.autograd.grad(loss, params)

    for _ in range(3):
        step()
    times = []
    for _ in range(runs):
        _sync(dev)
        t0 = time.perf_counter()
        step()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"repro_torch": repro_torch.__file__, "ms": times,
            "median_ms": statistics.median(times),
            "spans": _helper_cost(step, batch["images"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CHECKOUT")
    ap.add_argument("--order", default="ABBAABBA")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--leg", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.leg:
        print(json.dumps(leg(args.leg, args.runs, args.smoke)))
        return 0
    if not args.smoke and not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if len(args.trees) != 2:
        ap.error("name two checkouts, NAME=CHECKOUT each")
    trees = dict(zip("AB", (t.split("=", 1) for t in args.trees)))
    if not args.smoke:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip(), flush=True)
    medians = {name: [] for name, _ in trees.values()}
    for i, key in enumerate(args.order):
        name, path = trees[key]
        src = str(pathlib.Path(path).resolve() / "src")
        cmd = [sys.executable, __file__, "--leg", src, "--runs",
               str(args.runs)] + (["--smoke"] if args.smoke else [])
        out = subprocess.run(cmd, check=True, capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
        result = json.loads(out)
        medians[name].append(result["median_ms"])
        print(f"leg {i + 1} {name}: median {result['median_ms']:.3f} ms, "
              f"min {min(result['ms']):.3f}, max {max(result['ms']):.3f} "
              f"over {args.runs} runs; span helpers {result['spans']}; "
              f"repro_torch from {result['repro_torch']}", flush=True)
    for name, values in medians.items():
        print(f"{name}: median of leg medians "
              f"{statistics.median(values):.3f} ms, legs "
              f"{[round(v, 3) for v in values]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
