#!/usr/bin/env python3
"""Where the serving tier's threads spend the card's time: tokens/s of
one request stream through the single engine and through the router,
synchronous and threaded, on one CUDA card.

    python3 tools/tier_threads.py [--repeat 2] [--smoke]

Builds ``qwen2-1.5b-gspn`` at full width (its own policy, weights from
seed 0) and serves ``chip_smoke.py``'s serving requests twice over (12
requests of 4096 to 16 prompt tokens, 16 new tokens each, 4 slots a
engine, chunks of 1024, greedy) through:

* ``engine``: one ``ServeEngine``, ``run()``;
* ``sync-N``: a ``Router`` of N replicas that share the model, ticked
  round-robin on the caller's thread;
* ``threaded-N@P``: the same on N worker threads, the caller's ``drive``
  loop sleeping P ms a tick (``router.POLL``: the reference's 0.5 ms,
  and 5 ms).

Every configuration runs ``--repeat`` times in turns; each run prints its
wall seconds, tokens/s and TTFT p50, and checks its greedy tokens against
the single engine's.  ``--smoke`` runs the reduced model on the CPU with
chunks of 16, to check the script.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
import pathlib

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

PROMPTS = (4096, 2048, 1536, 1024, 100, 16) * 2
NEW = 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import qwen2_1_5b_gspn
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine, drive
    from repro_torch.serve import router as router_mod
    from repro_torch.serve.router import Router

    if args.smoke:
        dev, cfg, chunk = "cpu", qwen2_1_5b_gspn.reduced(), 16
        prompts = tuple(max(p // 64, 4) for p in PROMPTS)
    else:
        if not torch.cuda.is_available():
            print("tier_threads: needs a CUDA card (or --smoke)",
                  file=sys.stderr)
            return 1
        dev, cfg, chunk = "cuda", qwen2_1_5b_gspn.full(), 1024
        prompts = PROMPTS
    model = lm.LM(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    prompt_toks = [torch.randint(0, cfg.vocab, (n,), generator=gen).numpy()
                   for n in prompts]
    max_len = max(prompts) + NEW
    poll = router_mod.POLL

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=NEW)
                for i, p in enumerate(prompt_toks)]

    def engines(n):
        return [ServeEngine(model, batch_size=4, max_len=max_len,
                            prefill_chunk=chunk, seed=i) for i in range(n)]

    def run_engine():
        eng = engines(1)[0]
        hs = [eng.submit(r) for r in reqs()]
        eng.run()
        return hs

    def run_sync(n):
        router = Router(engines(n))
        hs = [router.submit(r) for r in reqs()]
        router.run()
        return hs

    def run_threaded(n, poll_ms):
        router = Router(engines(n), threaded=True)
        router_mod.POLL = poll_ms / 1e3
        router.start()
        try:
            rs = reqs()
            _dt, hs = drive(router, rs, [0.0] * len(rs))
        finally:
            router.stop()
            router_mod.POLL = poll
        return hs

    configs = {"engine": run_engine,
               "sync-1": lambda: run_sync(1), "sync-2": lambda: run_sync(2)}
    for n in (1, 2):
        for poll in (0.5, 5.0):
            configs[f"threaded-{n}@{poll}ms"] = \
                (lambda n=n, poll=poll: run_threaded(n, poll))
    want = None
    if dev == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    run_engine()                                    # warm-up
    results = {name: [] for name in configs}
    for rep in range(args.repeat):
        for name, fn in configs.items():
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            hs = fn()
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res = {h.uid: h.result() for h in hs}
            toks = {u: r.tokens for u, r in res.items()}
            want = want or toks
            if toks != want:
                raise AssertionError(f"{name}: tokens differ from the "
                                     f"single engine's")
            total = sum(len(t) for t in toks.values())
            ttfts = sorted(r.ttft for r in res.values())
            results[name].append(total / wall)
            print(f"tier_threads {name} run {rep}: {wall:.3f} s, "
                  f"{total / wall:.3f} tok/s, ttft p50 "
                  f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms", flush=True)
    for name, rates in results.items():
        print(f"tier_threads {name}: median {statistics.median(rates):.3f} "
              f"tok/s over {len(rates)} runs {[round(r, 3) for r in rates]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
