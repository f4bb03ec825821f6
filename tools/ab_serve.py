#!/usr/bin/env python3
"""Compare the host-bound LM serving calls between checkouts of the
PyTorch port, on one CUDA card.

    python3 tools/ab_serve.py parent=path/to/a change=path/to/b \\
        --order ABBAABBA --runs 20

Each leg is a fresh process that imports ``repro_torch`` from one
checkout's ``src`` and builds ``qwen2-1.5b-gspn`` at full width on the
card (its own policy, weights from seed 0).  Under ``torch.no_grad()``,
as the serving engine runs them, it times on the host clock, the card
synchronised before and after each call, ``--runs`` calls each of:

* ``lm_decode_step`` of 4 slots (the engine's decode tick);
* ``lm_prefill_chunk`` of 1024 tokens resumed at 1024 (one chunk);
* ``model.ln_f`` on the decode step's (4, 1, 1536) bf16 input, 1000
  calls a run, in µs per call: one of the 57 rmsnorm calls of a step.

``--order`` names the legs by checkout, A for the first argument, B for
the second.  ``--smoke`` runs each leg on the CPU with the reduced model
and 16-token chunks, to check the script itself.
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

SLOTS = 4
CHUNK = 1024
NORM_CALLS = 1000


def _sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _times(fn, runs: int, dev: str, calls: int = 1) -> list:
    """ms per call of ``fn`` over ``runs`` runs of ``calls`` calls."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(runs):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3 / calls)
    return out


def leg(src: str, runs: int, smoke: bool) -> dict:
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.configs.qwen2_1_5b_gspn import full, reduced
    from repro_torch.models import lm

    cfg, dev, chunk = ((reduced(), "cpu", 16) if smoke
                       else (full(), "cuda", CHUNK))
    model = lm.LM(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    token = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen,
                          device=dev)
    ctoks = torch.randint(0, cfg.vocab, (1, chunk), generator=gen,
                          device=dev)
    # The KV capacity is unused by the gspn kind's O(W) state.
    caches = lm.init_lm_cache(cfg, SLOTS, 2 * CHUNK, device=dev)
    resume = lm.init_lm_cache(cfg, 1, 2 * CHUNK, device=dev)
    for sub in resume.values():
        sub["pos"].fill_(chunk)
    x = torch.randn((SLOTS, 1, cfg.d_model), generator=gen,
                    device=dev).to(cfg.compute_dtype)
    with torch.no_grad():
        decode = _times(lambda: lm.lm_decode_step(model, token, caches),
                        runs, dev)
        chunk_ms = _times(
            lambda: lm.lm_prefill_chunk(model, ctoks, resume, chunk),
            runs, dev)
        norm = _times(lambda: model.ln_f(x), runs, dev, NORM_CALLS)
    return {"repro_torch": repro_torch.__file__,
            "decode_ms": statistics.median(decode),
            "chunk_ms": statistics.median(chunk_ms),
            "rmsnorm_us": statistics.median(norm) * 1e3,
            "decode_all": decode, "chunk_all": chunk_ms}


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
    keys = ("decode_ms", "chunk_ms", "rmsnorm_us")
    medians = {name: {k: [] for k in keys} for name, _ in trees.values()}
    for i, key in enumerate(args.order):
        name, path = trees[key]
        src = str(pathlib.Path(path).resolve() / "src")
        cmd = [sys.executable, __file__, "--leg", src, "--runs",
               str(args.runs)] + (["--smoke"] if args.smoke else [])
        out = subprocess.run(cmd, check=True, capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
        result = json.loads(out)
        for k in keys:
            medians[name][k].append(result[k])
        print(f"leg {i + 1} {name}: decode step {result['decode_ms']:.3f} "
              f"ms, chunk {result['chunk_ms']:.3f} ms, rmsnorm "
              f"{result['rmsnorm_us']:.3f} µs (medians of {args.runs}); "
              f"repro_torch from {result['repro_torch']}", flush=True)
    for name, per in medians.items():
        print(f"{name}: " + "; ".join(
            f"{k} median of legs {statistics.median(v):.3f}, legs "
            f"{[round(x, 3) for x in v]}" for k, v in per.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
