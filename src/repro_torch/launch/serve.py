"""Serving launcher: build a model with seeded weights and serve a
synthetic request stream through the continuous-batching engine
(DESIGN.md §9), on the card unless ``--device`` names another device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b-gspn \\
        --requests 8 --prefill-chunk 1024 --max-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --requests 8 --prefill-chunk 1024 --max-len 4112

Engine knobs: ``--max-batch`` (decode slots), ``--max-len`` (prompt plus
generated tokens per request, and the positions of each slot's KV cache
under attention), ``--prefill-chunk`` (0 = one-shot prefill;
otherwise longer prompts are consumed in chunks between decode steps),
``--scheduler fcfs|sjf``, ``--temperature`` (0 = greedy), ``--impl``
(the GSPN scan: ``auto`` runs kernel #1 on the card), ``--precision``
(the model's dtype policy, DESIGN.md §10) and ``--state-dtype`` (the
pooled state at rest).  ``--reduced`` serves the architecture's small
config.  The reference launcher's router, tuning-cache, sequence-parallel
and checkpoint flags are not ported yet (ROADMAP.md §1 items 2, 4, 6) and
do not parse.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import get_arch, resolve_dtype, with_precision
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib
from repro_torch.launch import args as largs
from repro_torch.models.lm import LM, count_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", "--batch", type=int, default=4,
                    dest="max_batch")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size in tokens (0 = one-shot)")
    ap.add_argument("--scheduler", default="fcfs", choices=["fcfs", "sjf"])
    ap.add_argument("--temperature", type=float, default=0.0)
    largs.add_impl_arg(ap)
    largs.add_precision_args(ap, state_dtype=True)
    largs.add_device_arg(ap)
    largs.add_observability_args(ap)
    args = ap.parse_args(argv)

    largs.setup_observability(args)
    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.reduced() if args.reduced else entry.full()
    if args.precision:
        cfg = with_precision(cfg, args.precision)
    if args.impl:
        cfg = dataclasses.replace(cfg, gspn_impl=args.impl)

    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(
        model, batch_size=args.max_batch, max_len=args.max_len,
        temperature=args.temperature, prefill_chunk=args.prefill_chunk,
        scheduler=args.scheduler,
        state_dtype=(resolve_dtype(args.state_dtype)
                     if args.state_dtype else None))
    chunk = eng.prefill_chunk
    print(f"[serve] {cfg.name} on {device}: {count_params(model)} "
          f"parameters, {eng.pool.nbytes / 2**20:.3f} MiB pooled state, "
          f"prefill chunk {chunk}")

    rng = np.random.default_rng(0)
    # When chunking is on, the long prompts exceed one chunk, so the
    # chunked path runs at this entry point's sizes.
    long_len = min(args.max_len - args.max_new, 3 * chunk) if chunk else 24
    handles = []
    for i in range(args.requests):
        plen = long_len if (chunk and i % 2) else 12
        handles.append(eng.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, max(plen, 4)),
            max_new_tokens=args.max_new)))
    cuda_lib.clear_counts()
    t0 = obs.monotonic()
    eng.run()
    dt = obs.monotonic() - t0
    largs.finish_observability(args, "serve")
    results = [h.result() for h in handles]
    if not results:
        print(f"[serve] {args.arch}: 0 requests")
        return
    total = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft for r in results)
    m = eng.metrics
    print(f"[serve] {args.arch}: {len(results)} requests, {total} tokens, "
          f"{total / dt:.1f} tok/s")
    print(f"[serve] ttft p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms, "
          f"max {ttfts[-1] * 1e3:.1f} ms; queue depth "
          f"mean {m['queue_depth_mean']:.1f} / max {m['queue_depth_max']}; "
          f"{m['prefills']} one-shot prefills, {m['prefill_chunks']} "
          f"prefill chunks, {m['decode_steps']} decode steps over "
          f"{m['ticks']} ticks")
    print(f"[serve] scan launches {dict(cuda_lib.launch_counts)}, plain "
          f"scan calls {dict(cuda_lib.plain_calls)}")


if __name__ == "__main__":
    main()
