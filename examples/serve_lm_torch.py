"""Request-generator driver for the PyTorch port's continuous-batching
engine, the twin of ``examples/serve_lm.py`` for its ``gspn`` and
``attn`` mixers.

    PYTHONPATH=src python examples/serve_lm_torch.py --requests 12 --rate 8 \\
        --prefill-chunk 32 --scheduler sjf --mixer attn

Builds a small LM with seeded weights on the card (``--device cpu`` runs
the plain path on the CPU), with the GSPN-2 mixer (``--mixer gspn``, the
default) or GQA attention (``--mixer attn``, the reference example's
default; its KV cache holds 512 positions a slot), then plays an arrival
process against the engine: requests arrive at ``--rate`` req/s (exponential
inter-arrivals) with a short/long prompt mix, and the driver interleaves
``submit`` with engine ``tick()``s, as a front end would.  Long prompts
are consumed in ``--prefill-chunk``-token chunks between decode steps, so
they never stall the decode batch (DESIGN.md §9).

Printed per request: TTFT (submit -> first token), queue delay (submit ->
admission), mean inter-token latency, prefill chunk count and finish
reason; overall: tok/s, p50/max TTFT, max queue depth, and the scan
kernel's launches.  ``--stream`` prints tokens as they are produced.
"""

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve.engine import Request, ServeEngine, drive


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="offered load, requests/s (0 = all at once)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--scheduler", default="fcfs", choices=["fcfs", "sjf"])
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--mixer", default="gspn", choices=["gspn", "attn"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = LMConfig(
        name=f"serve-{args.mixer}", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab=8192,
        unit=((args.mixer, 4),), n_units=1, gspn_proxy_dim=8,
        gspn_row_width=32, remat="none")
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))

    stream = (lambda uid, tok: print(f"    [stream] req {uid} -> {tok}")) \
        if args.stream else None
    eng = ServeEngine(model, batch_size=args.batch, max_len=512,
                      temperature=args.temperature, top_k=50,
                      prefill_chunk=args.prefill_chunk,
                      scheduler=args.scheduler, stream=stream)

    # Request generator: discrete short/long prompt lengths, exponential
    # inter-arrival times at the offered rate.
    rng = np.random.default_rng(0)
    plens = rng.choice([16, 96], size=args.requests, p=[0.7, 0.3])
    gaps = (rng.exponential(1.0 / args.rate, args.requests)
            if args.rate > 0 else np.zeros(args.requests))
    arrivals = np.cumsum(gaps)
    reqs = [Request(uid=i, prompt=rng.integers(0, 8192, int(plens[i])),
                    max_new_tokens=int(rng.integers(
                        min(8, args.max_new), args.max_new + 1)))
            for i in range(args.requests)]

    cuda_lib.clear_counts()
    dt, handles = drive(eng, reqs, arrivals, idle_sleep=0.005)

    results = {h.uid: h.result() for h in handles if h.done}
    if not results:
        print("served 0 requests")
        return results
    total = sum(len(r.tokens) for r in results.values())
    ttfts = sorted(r.ttft for r in results.values())
    print(f"served {len(results)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, mixer={args.mixer}, device={device}, "
          f"slots={args.batch}, chunk={eng.prefill_chunk}, "
          f"sched={args.scheduler})")
    m = eng.metrics
    print(f"ttft p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms / "
          f"max {ttfts[-1] * 1e3:.1f} ms; queue depth "
          f"mean {m['queue_depth_mean']:.1f} / "
          f"max {m['queue_depth_max']}")
    print(f"scan launches {dict(cuda_lib.launch_counts)}, plain scan calls "
          f"{dict(cuda_lib.plain_calls)}")
    for uid in sorted(results)[:6]:
        r = results[uid]
        itl = 1e3 * (sum(r.itl) / len(r.itl)) if r.itl else 0.0
        print(f"  req {uid}: {len(r.tokens)} toks, "
              f"ttft {r.ttft * 1e3:.1f} ms, queue {r.queue_delay * 1e3:.1f} "
              f"ms, itl {itl:.1f} ms, chunks {r.prefill_chunks}, "
              f"{r.finish_reason}: {r.tokens[:8]}...")
    return results


if __name__ == "__main__":
    main()
