"""Serving launcher: build a model with seeded weights and serve a
synthetic request stream through the continuous-batching engine
(DESIGN.md §9), on the card unless ``--device`` names another device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b-gspn \\
        --requests 8 --prefill-chunk 1024 --max-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --requests 8 --prefill-chunk 1024 --max-len 4112
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --requests 8 --prefill-chunk 1024 --max-len 4112

Engine knobs: ``--max-batch`` (decode slots), ``--max-len`` (prompt plus
generated tokens per request, and the positions of each slot's KV cache
under attention), ``--prefill-chunk`` (0 = one-shot prefill;
otherwise longer prompts are consumed in chunks between decode steps),
``--scheduler fcfs|sjf``, ``--temperature`` (0 = greedy), ``--impl``
(the GSPN scan: ``auto`` runs kernel #1 on the card), ``--precision``
(the model's dtype policy, DESIGN.md §10) and ``--state-dtype`` (the
pooled state at rest).  ``--reduced`` serves the architecture's small
config; ``--ckpt-dir`` restores the parameters of the latest checkpoint
the trainer wrote there; ``--tune-cache`` layers a tuning cache over the
seed cache (DESIGN.md §11).

Tier knobs (DESIGN.md §15): ``--replicas N`` engines behind the router,
sharing the model (one copy of the weights on the card), each with its
own pool, sampling generator (seed = its index) and CUDA stream;
``--router least_loaded|ttft``; ``--prefix-cache N`` entries of one
shared prefix-state cache, so prompts that share a chunk-aligned prefix
resume prefill from its cached state (refused for an architecture that
prefills in one shot, ``zamba2-2.7b`` and ``xlstm-1.3b``, and with
``--prefill-chunk 0``); ``--slo-ttft`` seconds, past which predicted
admissions are counted.  An encoder-decoder ``--arch`` (``whisper-base``)
is refused: the engine carries no audio frames.

Sequence parallelism (DESIGN.md §8): ``--seq-parallel N`` runs as N
processes, one per rank, as ``torchrun`` starts them (``RANK``,
``WORLD_SIZE`` = N, ``MASTER_ADDR``, ``MASTER_PORT``); each holds the
whole model and serves the same requests, the mixer's prefill and chunk
scans sharded over a ``seq`` mesh of N blocks (``gspn_impl="sp"`` unless
``--impl`` names another).  The group is NCCL where every rank has a card
of its own, gloo on the CPU or where the ranks share a card.  Rank 0
prints the report.  It takes one engine: replicas would issue their
collectives in a different order on each rank.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b-gspn \\
        --reduced --device cpu --prefill-chunk 16 --max-len 64 \\
        --replicas 2 --router ttft --prefix-cache 8
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch qwen2-1.5b-gspn --prefill-chunk 1024 --max-len 4112 \\
        --requests 6 --seq-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_arch, resolve_dtype, with_precision
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib
from repro_torch.launch import args as largs
from repro_torch.launch import mesh as lmesh
from repro_torch.models.lm import (LM, Ctx, count_params,
                                   supports_chunked_prefill)
from repro_torch.serve.cache import PrefixStateCache
from repro_torch.serve.engine import Request, ServeEngine, no_audio_message
from repro_torch.serve.router import Router


def main(argv=None):
    """Serve the synthetic stream; returns the requests' results."""
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
    ap.add_argument("--seq-parallel", type=int, default=1,
                    help="carve a seq mesh axis of this many ranks (one "
                         "process each, started as torchrun starts them) "
                         "and serve with the scans sharded over it "
                         "(impl=sp, DESIGN.md §8)")
    ap.add_argument("--ckpt-dir", default="",
                    help="restore the parameters of the latest checkpoint "
                         "here (the trainer's layout)")
    largs.add_impl_arg(ap)
    largs.add_precision_args(ap, state_dtype=True)
    largs.add_tuning_args(ap)
    largs.add_router_args(ap)
    largs.add_device_arg(ap)
    largs.add_observability_args(ap)
    args = ap.parse_args(argv)
    entry = get_arch(args.arch)
    if entry.full().encoder_layers:
        ap.error(no_audio_message(args.arch))
    if args.prefix_cache > 0:
        cfg = entry.reduced() if args.reduced else entry.full()
        if not supports_chunked_prefill(cfg):
            ap.error(f"--prefix-cache needs chunked prefill, which "
                     f"{args.arch} has not: its recurrent mixers prefill "
                     f"in one shot")
        if args.prefill_chunk <= 0:
            ap.error("--prefix-cache needs chunked prefill: give "
                     "--prefill-chunk")

    device = resolve_device(args.device)
    ctx, say = None, print
    if args.seq_parallel > 1:
        if args.replicas > 1:
            ap.error("--seq-parallel takes one engine, not --replicas")
        world = os.environ.get("WORLD_SIZE")
        if world != str(args.seq_parallel):
            ap.error(f"--seq-parallel {args.seq_parallel} runs one process "
                     f"a rank, as torchrun starts them; WORLD_SIZE is "
                     f"{world}")
        device = lmesh.init_distributed(device)
        if dist.get_rank():
            say = _quiet
        mesh = lmesh.make_sp_mesh(args.seq_parallel)
        ctx = Ctx(mesh=mesh)
    try:
        return _serve(args, device, ctx, say)
    finally:
        if ctx is not None:
            dist.destroy_process_group()


def _quiet(*args, **kwargs):
    """``print`` on ranks other than 0."""


def _serve(args, device, ctx, say):
    largs.setup_observability(args)
    largs.load_tune_cache(args, "serve")
    entry = get_arch(args.arch)
    cfg = entry.reduced() if args.reduced else entry.full()
    if args.precision:
        cfg = with_precision(cfg, args.precision)
    if args.impl:
        cfg = dataclasses.replace(cfg, gspn_impl=args.impl)
    elif ctx is not None:
        # The mesh is read by impl="sp" only; without it the seq axis
        # would be carved and then unused.
        cfg = dataclasses.replace(cfg, gspn_impl="sp")
    if ctx is not None:
        axes = dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.shape))
        say(f"[serve] mesh axes {axes} over {dist.get_backend()} (gspn "
          f"impl={cfg.gspn_impl})")

    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))
    if args.ckpt_dir:
        _, step = CheckpointManager(args.ckpt_dir).restore(
            target={"params": dict(model.named_parameters())})
        say(f"[serve] restored checkpoint step {step} from "
            f"{args.ckpt_dir}")
    prefix_cache = (PrefixStateCache(capacity=args.prefix_cache)
                    if args.prefix_cache > 0 else None)

    def make_engine(seed=0):
        return ServeEngine(
            model, batch_size=args.max_batch, max_len=args.max_len,
            temperature=args.temperature, prefill_chunk=args.prefill_chunk,
            scheduler=args.scheduler, seed=seed, prefix_cache=prefix_cache,
            ctx=ctx,
            state_dtype=(resolve_dtype(args.state_dtype)
                         if args.state_dtype else None))

    engines = [make_engine(seed=i) for i in range(max(args.replicas, 1))]
    eng = engines[0]
    chunk = eng.prefill_chunk
    say(f"[serve] {cfg.name} on {device}: {count_params(model)} "
        f"parameters, {eng.pool.nbytes / 2**20:.3f} MiB pooled state a "
        f"replica, prefill chunk {chunk}")
    if args.replicas > 1:
        tier = Router(engines, policy=args.router, slo_ttft=args.slo_ttft)
        say(f"[serve] router: {args.replicas} replicas, "
            f"policy={args.router}, slo_ttft={args.slo_ttft * 1e3:.0f} ms"
            + (f", prefix cache {args.prefix_cache} entries"
               if prefix_cache is not None else ""))
    else:
        tier = eng

    rng = np.random.default_rng(0)
    # When chunking is on, the long prompts exceed one chunk, so the
    # chunked path runs at this entry point's sizes.
    long_len = min(args.max_len - args.max_new, 3 * chunk) if chunk else 24
    handles = []
    for i in range(args.requests):
        plen = long_len if (chunk and i % 2) else 12
        handles.append(tier.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, max(plen, 4)),
            max_new_tokens=args.max_new)))
    cuda_lib.clear_counts()
    t0 = obs.monotonic()
    tier.run()
    dt = obs.monotonic() - t0
    if say is print:
        largs.finish_observability(args, "serve")
    results = [h.result() for h in handles]
    if not results:
        say(f"[serve] {args.arch}: 0 requests")
        return results
    total = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft for r in results)
    cached = sum(r.cached_tokens for r in results)
    say(f"[serve] {args.arch}: {len(results)} requests, {total} tokens, "
        f"{total / dt:.1f} tok/s"
        + (f", {cached} prompt tokens prefix-cached"
           if prefix_cache is not None else ""))
    if args.replicas > 1:
        placed = [h.replica for h in handles]
        risk = obs.counter("router_slo_at_risk_total").value
        say(f"[serve] placement: "
            f"{[placed.count(r) for r in range(args.replicas)]} "
            f"requests/replica; {risk} admissions predicted past SLO")
        say(f"[serve] ttft p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms, "
            f"max {ttfts[-1] * 1e3:.1f} ms")
    else:
        m = eng.metrics
        say(f"[serve] ttft p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms, "
            f"max {ttfts[-1] * 1e3:.1f} ms; queue depth "
            f"mean {m['queue_depth_mean']:.1f} / max "
            f"{m['queue_depth_max']}; {m['prefills']} one-shot prefills, "
            f"{m['prefill_chunks']} prefill chunks, {m['decode_steps']} "
            f"decode steps over {m['ticks']} ticks")
    say(f"[serve] scan launches {dict(cuda_lib.launch_counts)}, plain "
        f"scan calls {dict(cuda_lib.plain_calls)}")
    return results


if __name__ == "__main__":
    main()
