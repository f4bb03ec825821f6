#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (vision serving and training, the
four-direction launch ladder, LM serving and LM training on the GSPN-2
mixer and on attention) on one CUDA card and hold every CUDA kernel
against its plain PyTorch version.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. the toolchain and the card: torch, CUDA, nvcc, the card's name and
   power limit; no card means exit 1 before anything else;
2. the build of every CUDA kernel from the checkout's sources;
3. kernels: each kernel (the forward scans #1 and #3 and their adjoints
   #2 and #4) against its plain version on the card, at the main path's
   shapes (batch 64 of GSPN-2-T at 224²: G = 128 planes, G_w = 64,
   H = W = 56/28/14/7), the 1024² stage-1 shape (G = 32, H = W = 256), a
   ragged shape (H = 19, W = 37, cpw 1 and 4) and a chunked one, and the
   single scan and its adjoint also at the ``qwen2-1.5b-gspn`` mixer's
   two passes at ``train_4k`` (G = 128, cpw 8: H = 4 rows of W = 1024,
   and H = 1024 rows of W = 4), at the LM train phase's (G = 16) and at
   H = 32, W = 1024 with chunk 8, in
   float32 and bfloat16 streams (tolerance 1e-5 of the largest magnitude,
   1e-2 for the forward's bfloat16 output); at all but the ragged and
   small chunked shapes, the device time per launch of the kernel and of
   the plain version (CUDA-graph replays timed by CUDA events, median of
   20) and of one eager call, and at the main-path shapes the kernel's
   time with the L2 flushed before each launch (``cold_ms``, as the main
   path finds its operands in device memory).  #1, #3 and #5 are the D =
   1, 2 and 4 instances of one forward template (a warp per plane,
   neighbours by shuffle, a ``cp.async`` ring in shared memory, taps
   staged once per weight group), #2 and #4 the D = 1 and 2 instances of
   its adjoint template (#2 spreading a row of more than 128 columns over
   warps: on a plane of up to 16 rows, windows of 64 or 128 columns read
   from device memory four rows ahead; on a taller one, eight bands that
   share the row from the ring).  Then the single-launch quad kernel (#5) against its
   plain version at the main-path shapes (N = 56/28/14/7), at 1024² (G =
   32, N = 256, its transposed directions streaming column slabs of x
   through the ring) and on a ragged square (N = 19, cpw 1 and 4),
   float32 and bfloat16, timed through its wrapper, which reads x in
   place (no stacked copy), warm and with a cold L2;
4. the single-direction gradient: the gradients of one "rl"
   ``directional_scan`` at 28², G = 128, through kernels #1 and #2 under
   autograd, counted (one launch each, no plain call) and held against
   the plain path (1e-5 of the largest magnitude);
5. model (serving): GSPN-2-T classification forward at 224², batch 64, weights from
   a seeded generator, images from ``synth_images``; the kernel path
   against the plain path on the card (TF32 off for convolutions and
   matrix products, 1e-4 of the largest logit), one counted forward that
   must launch the pair kernel 52 times and never call a plain scan, the
   forward's images/s over 10 timed runs, a profile of one forward
   (device time by kernel, idle share, the forward as one CUDA graph);
   and the reduced model on the card against the plain path on the CPU;
6. training: one GSPN-2-T training step at 224², batch 64, f32: a counted
   ``vision_loss`` + ``backward()`` that must launch the pair kernel and
   its adjoint 52 times each and never call a plain scan, its gradients
   against the plain path on the card (loss 1e-5 relative, each
   parameter's gradient 1e-4 of its largest magnitude), 5 timed runs of
   the loss and gradients alone, 5 timed AdamW steps (step ms, images/s,
   peak memory) and a profile of one step;
7. the trainer twin ``examples/train_vision_torch.py``, 60 steps on the
   reduced model, whose held-out accuracy must end above 2/n_classes;
8. the four-direction launch ladder (the paper's §4.3 design point) at
   GSPN-2-T's stage shapes, batch 64 (G = 128, cpw 2, N = 56/28/14/7,
   float32): the GSPN-1 per-step emulation, one scan per direction (#1
   four times), the pair dispatch (#3 twice) and the quad (#5 once), each
   through the port's public functions and held equal to the pair rung
   (1e-5 of the largest magnitude); its launches asserted from the
   counters and again from the ``kernel.launch`` spans; its device time as
   a CUDA graph and as an eager call (per_step eager only); a Chrome trace
   of one traced pass of every rung written to ``build/ladder_trace.json``;
9. LM serving: ``qwen2-1.5b-gspn`` at full width (28 layers, d_model 1536,
   d_ff 8960, vocab 151 936, C_proxy 8, row width 1024) with weights from
   a seeded generator on the card: its parameter count; under the f32
   policy, one 2048-token prefill through kernel #1 against the plain
   path (``impl="torch"``), a chunk chain of 2 × 1024 tokens against the
   one-shot prefill, and two decode steps against ``apply_lm`` at the same
   positions (logits within 1e-4 of their largest magnitude), each pass
   counted (56 launches of #1 per prefill or chunk, none per decode step,
   no plain scan); then a ``ServeEngine`` with 4 slots, prefill chunks of
   1024, greedy, under the config's own policy, over 6 requests of 4096,
   2048, 1536, 1024, 100 and 16 prompt tokens and 16 new tokens each:
   per-request TTFT and tokens, tok/s, the median decode step and chunk
   (``serve.*`` spans), the card's idle share over one decode step and
   one chunk (profiler), peak memory, and #1's launches by shape from the
   counters (56 per prefill or chunk, none per decode step), which the
   ``kernels`` line reports at the kernel phase's serving shapes (#1 at
   G = 8, cpw 8: 1 and 2 rows of 1024, 1024 rows of 1 and 2);
10. LM training (``lm train ...`` lines), ``qwen2-1.5b-gspn`` at full
   width with seeded weights and ``synth_tokens`` batches: (a) under the
   f32 policy without rematerialisation, ``lm_loss`` and every
   parameter's gradient at 1 × 2048 tokens through #1 and #2 against the
   plain path (loss 1e-5 relative, each gradient 1e-4 of its largest
   magnitude; 56 launches of each, no plain scan); (b) under the config's
   own policy and ``remat="unit"``, ``build_train_step`` with AdamW at
   2 × 4096 tokens: one counted step (112 launches of #1 and 56 of #2, by
   shape: G = 16, cpw 8, 4 rows of 1024 and 1024 rows of 4, which the
   ``kernels`` line reports at the kernel phase's training shapes), the
   median of 5 timed steps and tokens/s, loss and gradients alone, peak
   memory and a profiled step; (c) two steps of the ``bf16`` preset with
   the f32 master copy and loss scaling (finite gradients, the working
   copy equal to the master rounded, the kernels' bf16 instances); (d)
   the trainer twin ``examples/train_lm_torch.py --preset small`` for 60
   steps, whose loss must fall, then a restart that resumes from its
   checkpoint under ``build/``;
11. the attn block kind (``lm attn ...`` lines), ``qwen2-1.5b`` at full
   width (28 layers, d_model 1536, 12 heads over 2, vocab 151 936, tied,
   qkv bias) with seeded weights, no scan launched anywhere: (a) under
   the f32 policy, a 2048-token prompt as two chunks of 1024 against the
   one-shot prefill (logits 1e-4, KV caches 1e-4) and 2 decode steps
   against ``apply_lm`` with its attention dense (1e-4; blockwise, 2050
   tokens would halve the key block to 2), and ``chunked_attention`` at
   1 x 4096,
   forward and gradients, against the exact (f64) attention (1e-5) and
   against ``full_attention`` (2e-5: on the card the dense path's own
   f32 dv sits 8.9e-6 from the exact one, the blockwise path's 3.9e-6);
   (b) the
   engine under the config's own policy over the serving phase's
   requests (4 slots, chunks of 1024, max_len 4112): TTFT per request,
   tok/s, the median decode step and chunk, their idle shares and
   attention's share of their device time, the KV pool's bytes, peak
   memory; (c) training at 2 x 4096 under ``remat="unit"`` with AdamW:
   the median of 5 steps, tokens/s, loss and gradients alone, peak
   memory, a profiled step and attention's share of its device time
   (the kernels under the ``attention.*`` spans of that profile); (d) ``granite-3-2b`` ``full()`` under the f32 policy: a
   prefill of 1024 and 4 decode steps against ``apply_lm`` (1e-4).

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores, at the 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations per output element: the scan does 4 multiplies and 3 adds,
# the adjoint 6 multiplies and 3 adds.
OPS_PER_ELEMENT = {"fwd": 7, "bwd": 9}
MAIN_WIDTHS = (56, 28, 14, 7)
BATCH = 64
REPLACES = {
    "gspn_quad_fwd": "src/repro/kernels/gspn_multidir.py:422",
    "gspn_pair_fwd": "src/repro/kernels/gspn_multidir.py:165",
    "gspn_scan_fwd": "src/repro/kernels/gspn_scan.py:224",
    "gspn_pair_bwd": "src/repro/kernels/gspn_multidir.py:336",
    "gspn_scan_bwd": "src/repro/kernels/gspn_scan.py:384",
}
# Every kernel is an instance of a template in one source.
SOURCES = dict.fromkeys(REPLACES, "src/repro_torch/kernels/csrc/gspn_pair.cu")
# Kernels timed with a cold L2 at the main-path shapes: all of them.
COLD = tuple(REPLACES)
# Names of the scan kernels in the profiler's device records.
SCAN_KERNELS = ("gspn_fwd_kernel", "gspn_bwd_kernel")
# The templates' direction count D of each kernel.
NDIR = {"gspn_scan_fwd": 1, "gspn_pair_fwd": 2, "gspn_quad_fwd": 4,
        "gspn_scan_bwd": 1, "gspn_pair_bwd": 2}
# The single scan's and its adjoint's further shapes (G, H, W, cpw,
# chunk): the qwen2-1.5b-gspn mixer's T→B pass and within-row pass at
# train_4k (batch 16, C_proxy 8), and a chunked wide shape.
LM_SHAPES = ((128, 4, 1024, 8, None), (128, 1024, 4, 8, None),
             (128, 32, 1024, 8, 8))
# The single scan's shapes on the LM serving path (one request, C_proxy 8):
# the T→B pass of a one-shot prefill of up to 1024 tokens and of a seeded
# chunk of 1024 (1 and 2 rows of 1024), the within-row pass of both (1024
# rows of 1), and of a one-shot prefill of 2048 (1024 rows of 2).
SERVE_SHAPES = ((8, 1, 1024, 8, None), (8, 2, 1024, 8, None),
                (8, 1024, 1, 8, None), (8, 1024, 2, 8, None))
# The serving phase: the engine's requests (prompt tokens) and new tokens.
SERVE_PROMPTS = (4096, 2048, 1536, 1024, 100, 16)
SERVE_NEW = 16
SERVE_CHUNK = 1024
# The f32 checks' prompt: two chunks.
CHECK_LEN = 2048
# The LM training phase: batch x tokens of the timed steps (one chip's
# share of train_4k), the shapes of #1 and #2 there (G = 2 sequences x
# C_proxy 8, cpw 8: the T→B pass, 4 rows of 1024, and the within-row pass,
# 1024 rows of 4), the timed steps, and the trainer twin's steps.
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_SHAPES = ((16, 4, 1024, 8, None), (16, 1024, 4, 8, None))
TRAIN_STEPS = 5
TWIN_STEPS = 60


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median over ``n`` calls of CUDA-event time around one call of
    ``fn``: device time plus whatever host time the call leaves the card
    idle for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _captured(fn, per_graph: int) -> torch.cuda.CUDAGraph:
    """``per_graph`` calls of ``fn`` captured in a CUDA graph, after three
    warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return graph


def _graph_ms(fn, per_graph: int, n: int = 20) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in a
    CUDA graph, the median of ``n`` timed replays divided by
    ``per_graph``.  Replays leave out the host's launch overhead."""
    graph = _captured(fn, per_graph)
    ms = _median_ms(graph.replay, n=n) / per_graph
    del graph
    return ms


def _cold_ms(fn, n: int = 20) -> float:
    """Device time of one call of ``fn`` with the L2 cache flushed first:
    ``fn`` captured once in a CUDA graph; before each of ``n`` timed
    replays a 256 MiB buffer is written (more than the 50 MB L2) and the
    card spins for about half a millisecond, outside the timed window, so
    the host has queued the replay before it starts.  Median of ``n``."""
    graph = _captured(fn, 1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(n):
        flush.fill_(1)
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph, flush
    return statistics.median(times)


def _scan_inputs(gen, g, h, w, cpw, dtype, pair, kind="fwd", ndir=None):
    """(x, wl, wc, wr, lam) for a forward scan, (dy, wl, wc, wr) for an
    adjoint; ``ndir`` 4 gives the quad's operands."""
    lead = (ndir,) if ndir else (2,) if pair else ()
    dev = "cuda"
    x = torch.randn((g, h, w), generator=gen, device=dev)
    taps = torch.softmax(torch.randn(lead + (g // cpw, h, w, 3),
                                     generator=gen, device=dev), dim=-1)
    lam = torch.rand(lead + (g, h, w), generator=gen, device=dev)
    if kind == "bwd":
        dy = torch.randn(lead + (g, h, w), generator=gen, device=dev)
        return tuple(t.to(dtype).contiguous()
                     for t in (dy, taps[..., 0], taps[..., 1], taps[..., 2]))
    return tuple(t.to(dtype).contiguous()
                 for t in (x, taps[..., 0], taps[..., 1], taps[..., 2], lam))


def kernel_phase(gen):
    from repro_torch.kernels import gspn_multidir, gspn_scan

    kernels = {
        "gspn_scan_fwd": (gspn_scan.gspn_scan_fwd,
                          gspn_scan.gspn_scan_fwd_torch, False, "fwd"),
        "gspn_pair_fwd": (gspn_multidir.gspn_scan_bidir,
                          gspn_multidir.gspn_scan_bidir_torch, True, "fwd"),
        "gspn_scan_bwd": (gspn_scan.gspn_scan_bwd,
                          gspn_scan.gspn_scan_bwd_torch, False, "bwd"),
        "gspn_pair_bwd": (gspn_multidir.gspn_scan_bidir_bwd,
                          gspn_multidir.gspn_scan_bidir_bwd_torch, True,
                          "bwd"),
    }
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(2 * BATCH, w, w, 2, None, dtype, True) for w in MAIN_WIDTHS]
        cases += [(32, 256, 256, 2, None, dtype, True),
                  (8, 19, 37, 1, None, dtype, False),
                  (8, 19, 37, 4, None, dtype, False),
                  (8, 38, 37, 4, 19, dtype, False)]
        cases += [shape + (dtype, True) for shape in LM_SHAPES]
        cases += [shape + (dtype, True) for shape in SERVE_SHAPES]
        cases += [shape + (dtype, True) for shape in TRAIN_SHAPES]
    # The adjoints write f32 computed in f32 from the same inputs as their
    # plain versions, in either stream dtype.
    tol = {("fwd", torch.float32): 1e-5, ("fwd", torch.bfloat16): 1e-2,
           ("bwd", torch.float32): 1e-5, ("bwd", torch.bfloat16): 1e-5}
    results = []
    for name, (kernel, plain, pair, kind) in kernels.items():
        for g, h, w, cpw, chunk, dtype, timed in cases:
            if pair and (g, h, w, cpw, chunk) in LM_SHAPES + TRAIN_SHAPES:
                continue
            if name != "gspn_scan_fwd" and \
                    (g, h, w, cpw, chunk) in SERVE_SHAPES:
                continue
            args = _scan_inputs(gen, g, h, w, cpw, dtype, pair, kind)
            got = kernel(*args, chunk=chunk)
            want = plain(*args, chunk=chunk)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            dname = str(dtype).removeprefix("torch.")
            row = dict(kernel=name, g=g, h=h, w=w, cpw=cpw, chunk=chunk,
                       dtype=dname, max_abs_err=err, max_abs=scale,
                       tol=tol[kind, dtype] * scale,
                       launch_shape=_launch_shape(g, h, w, cpw, dtype, kind,
                                                  NDIR[name]))
            if timed:
                nbytes = sum(t.numel() * t.element_size() for t in args) \
                    + got.numel() * got.element_size()
                row.update(
                    ms=_graph_ms(lambda: kernel(*args, chunk=chunk), 10),
                    plain_ms=_graph_ms(lambda: plain(*args, chunk=chunk), 2),
                    call_ms=_median_ms(lambda: kernel(*args, chunk=chunk)),
                    plain_call_ms=_median_ms(
                        lambda: plain(*args, chunk=chunk)),
                    **_bound(nbytes, got.numel(), kind))
                if name in COLD and h in MAIN_WIDTHS:
                    row["cold_ms"] = _cold_ms(
                        lambda: kernel(*args, chunk=chunk))
            print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()),
                  flush=True)
            if not err <= row["tol"]:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {row}")
            results.append(row)
    return results + _quad_rows(gen)


def _launch_shape(g, h, w, cpw, dtype, kind, ndir):
    """The launch shape ``pair_launch_shape`` picks, as printed in a kernel
    row."""
    from repro_torch.kernels.gspn_scan import pair_launch_shape

    s = pair_launch_shape(g, h, w, cpw, dtype, kind, ndir)
    return (f"planes={s.planes},warps={s.warps},K={s.k},splits={s.splits},"
            f"S={s.stages},batch={s.batch},"
            f"grid={'x'.join(map(str, s.grid))},xpitch={s.xpitch},"
            f"bands={s.bands},direct={int(s.direct)},smem={s.smem_bytes}")


def _bound(nbytes, out_elements, kind):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT[kind] * out_elements / PEAK_F32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _quad_rows(gen):
    """Kernel #5 against its plain version.  ``ms`` and ``cold_ms`` are
    the public wrapper, which reads x in place, against the bound of the
    function it computes (x read once, taps and lam read, out written)."""
    from repro_torch.kernels import gspn_multidir as mk

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(2 * BATCH, n, 2, dtype, True) for n in MAIN_WIDTHS]
        cases += [(32, 256, 2, dtype, True), (8, 19, 1, dtype, False),
                  (8, 19, 4, dtype, False)]
    rows = []
    for g, n, cpw, dtype, timed in cases:
        args = _scan_inputs(gen, g, n, n, cpw, dtype, False, ndir=4)
        got = mk.gspn_scan_quad(*args)
        want = mk.gspn_scan_quad_torch(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        row = dict(kernel=mk.KERNEL_QUAD, g=g, h=n, w=n, cpw=cpw, chunk=None,
                   dtype=str(dtype).removeprefix("torch."), max_abs_err=err,
                   max_abs=scale, tol=tol * scale,
                   launch_shape=_launch_shape(g, n, n, cpw, dtype, "fwd", 4))
        if timed:
            nbytes = sum(t.numel() * t.element_size() for t in args) \
                + got.numel() * got.element_size()
            row.update(
                ms=_graph_ms(lambda: mk.gspn_scan_quad(*args), 10),
                plain_ms=_graph_ms(lambda: mk.gspn_scan_quad_torch(*args), 2),
                call_ms=_median_ms(lambda: mk.gspn_scan_quad(*args)),
                plain_call_ms=_median_ms(
                    lambda: mk.gspn_scan_quad_torch(*args)),
                **_bound(nbytes, got.numel(), "fwd"))
            if n in MAIN_WIDTHS:
                row["cold_ms"] = _cold_ms(lambda: mk.gspn_scan_quad(*args))
        print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)
        if not err <= row["tol"]:
            raise AssertionError(f"{mk.KERNEL_QUAD} disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def single_direction_grad_check(gen):
    """Gradients of one "rl" ``directional_scan`` (kernels #1 and #2 under
    autograd) against the plain path, 1e-5 of the largest magnitude.
    Returns the counted run's launches by shape."""
    from repro_torch.core.gspn import directional_scan
    from repro_torch.kernels import cuda_lib

    args = _scan_inputs(gen, 2 * BATCH, 28, 28, 2, torch.float32, False)
    r = torch.randn(args[0].shape, generator=gen, device="cuda")

    def grads(impl):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = directional_scan(*leaves, "rl", impl=impl)
        return torch.autograd.grad((out * r).sum(), leaves)

    cuda_lib.clear_counts()
    got = grads("auto")
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    want = grads("torch")
    torch.cuda.synchronize()
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(got, want))
    print(f"directional_scan 'rl' gradients, kernels vs plain: launches "
          f"{launches}, worst error / largest magnitude {worst:.3e}",
          flush=True)
    if launches != {"gspn_scan_fwd": 1, "gspn_scan_bwd": 1} \
            or not worst <= 1e-5:
        raise AssertionError("single-direction gradients disagree or "
                             "missed the kernels")
    return shapes


def _profile(fn, wall_s, what, spans=None):
    """Where one call of ``fn`` spends device time: the profiler's device
    time by kernel, the scan kernels' share (forward and adjoint), and the
    device's idle share of an eager call that took ``wall_s``.  With
    ``spans``, a prefix of ``obs`` span names, tracing is on for the call
    and the device time of the kernels launched inside those spans is
    read from the same profile, by span.  Returns the device time in ms,
    None when the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    if spans:
        obs.clear()
        obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        obs.disable()
    # Kernel records only: the operator records carry the same device
    # time, and so do the device-side ranges that the profiler adds for
    # each obs span (named as the span, idle gaps included).
    spanned = {r.name for r in obs.records()}
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in spanned]
    ops.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in ops)
    scan_us = {k: sum(e.self_device_time_total for e in ops
                      if f"{k}<" in e.key)
               for k in SCAN_KERNELS}
    if device_us == 0:
        print(f"profile {what}: the profiler recorded no device time; "
              f"device breakdown not measured", flush=True)
        return None
    scans = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / device_us:.4f})"
                      for k, v in scan_us.items())
    print(f"profile {what}: device time {device_us / 1e3:.3f} ms, eager "
          f"{wall_s * 1e3:.3f} ms, device idle share "
          f"{1 - device_us / 1e6 / wall_s:.3f}, scan kernels "
          f"{sum(scan_us.values()) / 1e3:.3f} ms "
          f"({sum(scan_us.values()) / device_us:.4f} of device time: "
          f"{scans})", flush=True)
    for e in ops[:15]:
        print(f"profile {what} op: {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    if spans:
        _span_share(prof, spans, device_us, what)
    return device_us / 1e3


def _span_share(prof, prefix, device_us, what):
    """The device time under the host-side ``record_function`` ranges
    whose names start with ``prefix`` (each range's kernels and those of
    the operators inside it), by name, and their share of the profile's
    device time ``device_us``.  Fails when the spans hold more device
    time than the profile has, or when no span was recorded."""
    by_name = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if e.name.startswith(prefix) and \
                e.device_type == torch.autograd.DeviceType.CPU:
            by_name[e.name] += e.device_time_total
            count[e.name] += 1
    total = sum(by_name.values())
    if not count:
        raise AssertionError(f"profile {what}: no {prefix}* span recorded")
    parts = ", ".join(f"{n} {by_name[n] / 1e3:.3f} ms x{count[n]}"
                      for n in sorted(by_name))
    if total == 0:
        print(f"profile {what}: {prefix}* spans ({parts}) hold no device "
              f"time; their share not measured", flush=True)
        return
    print(f"profile {what}: {prefix}* spans' device time "
          f"{total / 1e3:.3f} ms, {total / device_us:.4f} of the profile's "
          f"device time ({parts})", flush=True)
    if total > device_us * 1.0001:
        raise AssertionError(f"profile {what}: the {prefix}* spans hold "
                             f"more device time than the profile")


def _profile_forward(model, images, wall_s):
    """The profile of one kernel-path forward, and the forward replayed as
    one CUDA graph, which removes the host's launch overhead."""
    from repro_torch.models.vision import apply_vision

    _profile(lambda: apply_vision(model, images), wall_s, "forward")

    def forward():
        with torch.inference_mode():
            model(images)

    graph_ms = _graph_ms(forward, 1, n=10)
    print(f"forward as one CUDA graph: {graph_ms:.3f} ms "
          f"({BATCH / graph_ms * 1e3:.1f} images/s, median of 10 replays)",
          flush=True)


def model_phase(gen):
    from repro_torch.configs.gspn2_vision import GSPN2_T, reduced_vision
    from repro_torch.data.pipeline import DataConfig, synth_images
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.vision import GSPNVision, apply_vision

    cfg = GSPN2_T
    t0 = time.perf_counter()
    model = GSPNVision(cfg, device="cuda", generator=gen).eval()
    plain = GSPNVision(dataclasses.replace(cfg, impl="torch"),
                       device="meta").eval()
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = synth_images(DataConfig(1, 1, BATCH, seed=0), 0, cfg.img_size,
                         cfg.n_classes)
    images = torch.from_numpy(batch["images"]).cuda()
    torch.cuda.synchronize()
    print(f"model {cfg.name}: {sum(p.numel() for p in model.parameters())} "
          f"parameters, set-up {time.perf_counter() - t0:.3f} s", flush=True)

    apply_vision(model, images)                       # warm-up, not counted
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    logits = apply_vision(model, images)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain_calls = sum(cuda_lib.plain_calls.values())
    print(f"main path: launches {launches}, by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain_calls}", flush=True)
    n_blocks = sum(cfg.depths)
    if launches != {"gspn_pair_fwd": 2 * n_blocks} or plain_calls:
        raise AssertionError(
            f"expected {2 * n_blocks} pair launches and no plain scan in one "
            f"forward, got {launches} and {plain_calls} plain calls")

    ref = apply_vision(plain, images)
    torch.cuda.synchronize()
    if logits.shape != (BATCH, cfg.n_classes) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: {logits.shape}")
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"logits kernel vs plain path: max_abs_err={err} "
          f"max_abs={scale} tol={1e-4 * scale}", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError("kernel path logits disagree with the plain path")

    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        apply_vision(model, images)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(3):
        apply_vision(plain, images)
    torch.cuda.synchronize()
    dt_plain = (time.perf_counter() - t0) / 3
    print(f"forward batch {BATCH} at {cfg.img_size}^2: kernel path "
          f"{dt * 1e3:.3f} ms ({BATCH / dt:.1f} images/s, {n} runs), plain "
          f"path {dt_plain * 1e3:.3f} ms ({BATCH / dt_plain:.1f} images/s, "
          f"3 runs), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    _profile_forward(model, images, dt)

    # The reduced model on the card against the plain path on the CPU.
    small = reduced_vision()
    cpu = GSPNVision(small, device="cpu",
                     generator=torch.Generator().manual_seed(1)).eval()
    card = GSPNVision(small, device="meta").eval()
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    b = synth_images(DataConfig(1, 1, 4, seed=1), 0, small.img_size,
                     small.n_classes)
    x = torch.from_numpy(b["images"])
    want = apply_vision(cpu, x)
    got = apply_vision(card, x.cuda()).cpu()
    err = (got - want).abs().max().item()
    print(f"reduced model card vs CPU: max_abs_err={err}", flush=True)
    if not err <= 1e-4 * want.abs().max().item():
        raise AssertionError("reduced model on the card disagrees with CPU")
    return shapes


def _twin():
    """The trainer twin, ``examples/train_vision_torch.py``, as a module."""
    path = ROOT / "examples" / "train_vision_torch.py"
    spec = importlib.util.spec_from_file_location("train_vision_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_phase(gen):
    """One GSPN-2-T training step at full width: counted, held against the
    plain path, timed and profiled.  Returns the counted step's launches
    by shape."""
    from repro_torch.configs.gspn2_vision import GSPN2_T
    from repro_torch.data.pipeline import DataConfig, synth_images
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.vision import GSPNVision, vision_loss
    from repro_torch.optim.adamw import AdamWConfig

    cfg = GSPN2_T
    model = GSPNVision(cfg, device="cuda", generator=gen)
    plain = GSPNVision(dataclasses.replace(cfg, impl="torch"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synth_images(
        DataConfig(1, 1, BATCH, seed=0), 0, cfg.img_size,
        cfg.n_classes).items()}
    params = dict(model.named_parameters())

    def loss_and_grads(m):
        loss, _ = vision_loss(m, batch)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    loss_and_grads(model)                            # warm-up, not counted
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    loss, grads = loss_and_grads(model)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain_calls = sum(cuda_lib.plain_calls.values())
    print(f"train step: launches {launches}, by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain_calls}", flush=True)
    n = 2 * sum(cfg.depths)
    if launches != {"gspn_pair_fwd": n, "gspn_pair_bwd": n} or plain_calls:
        raise AssertionError(
            f"expected {n} pair launches and {n} pair adjoint launches and "
            f"no plain scan in one step, got {launches} and {plain_calls} "
            f"plain calls")

    want_loss, want = loss_and_grads(plain)
    torch.cuda.synchronize()
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    errs = {name: ((g - w).abs().max() / w.abs().max()).item()
            for name, g, w in zip(params, grads, want)}
    worst = max(errs, key=errs.get)
    print(f"train step kernel vs plain path: loss {loss.item()} vs "
          f"{want_loss.item()} (relative {rel:.3e}, tol 1e-5); gradients of "
          f"{len(errs)} parameters, worst {worst} at {errs[worst]:.3e} of "
          f"its largest magnitude (tol 1e-4), median "
          f"{statistics.median(errs.values()):.3e}", flush=True)
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("non-finite gradients")
    if not rel <= 1e-5 or not errs[worst] <= 1e-4:
        raise AssertionError("kernel path gradients disagree with the "
                             "plain path")
    del plain, grads, want

    n_steps = 5
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss_and_grads(model)
    torch.cuda.synchronize()
    dt_grads = (time.perf_counter() - t0) / n_steps
    print(f"loss and gradients only (forward + backward): "
          f"{dt_grads * 1e3:.3f} ms ({n_steps} runs)", flush=True)

    step, _ = _twin().make_step(
        model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60,
                           weight_decay=0.01))
    step(batch)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(batch) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    losses = [v.item() for v in losses]
    print(f"train step batch {BATCH} at {cfg.img_size}^2, f32, AdamW: "
          f"{dt * 1e3:.3f} ms ({BATCH / dt:.1f} images/s, {n_steps} steps), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"losses {losses}", flush=True)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("non-finite training loss")
    _profile(lambda: step(batch), dt, "train step")
    return shapes


def twin_phase():
    """The trainer twin on the card: 60 steps, must learn."""
    t0 = time.perf_counter()
    acc = _twin().main(["--steps", "60"])
    print(f"trainer twin: held-out accuracy {acc:.2f} after 60 steps, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def _ladder_rungs(x, wl, wc, wr, lam):
    """The four rungs of one four-direction pass, each from the same
    operands in the original orientation (taps and lam stacked per
    direction, (4, ...)) to the (4, G, N, N) result in that orientation:
    name -> (function, its kernel launches)."""
    from repro_torch.core.gspn import DIRECTIONS, directional_scan
    from repro_torch.kernels.gspn_multidir import gspn_scan_quad

    def per_direction():
        return torch.stack([directional_scan(x, wl[i], wc[i], wr[i], lam[i], d)
                            for i, d in enumerate(DIRECTIONS)])

    def quad():
        # Entries 2 and 3 (lr, rl) go in and come out in transposed
        # geometry.
        def t4(a):
            return torch.stack([a[0], a[1], a[2].transpose(-1, -2),
                                a[3].transpose(-1, -2)])
        return t4(gspn_scan_quad(x, t4(wl), t4(wc), t4(wr), t4(lam)))

    return {
        "per_step": (lambda: directional_scan(x, wl, wc, wr, lam, DIRECTIONS,
                                              impl="per_step"), {}),
        "per_direction": (per_direction, {"gspn_scan_fwd": 4}),
        "pair": (lambda: directional_scan(x, wl, wc, wr, lam, DIRECTIONS),
                 {"gspn_pair_fwd": 2}),
        "quad": (quad, {"gspn_quad_fwd": 1}),
    }


def ladder_phase(gen):
    """The four-direction launch ladder at GSPN-2-T's stage shapes, batch
    64, f32.  Timing runs with tracing off; then one counted pass of every
    rung with tracing on, whose launches are asserted from the counters
    and from the spans and written as a Chrome trace.  Returns that pass's
    launches by shape for the single scan and the quad."""
    from repro_torch import obs
    from repro_torch.core.gspn import DIRECTIONS, _normalize_taps_oriented
    from repro_torch.kernels import cuda_lib
    from repro_torch.obs import report

    g, gw = 2 * BATCH, BATCH
    operands = {}
    for n in MAIN_WIDTHS:
        x = torch.randn((g, n, n), generator=gen, device="cuda")
        lam = torch.sigmoid(torch.randn((4, g, n, n), generator=gen,
                                        device="cuda"))
        logits = torch.randn((4, gw, n, n, 3), generator=gen, device="cuda")
        taps = [_normalize_taps_oriented(logits[i], d, "softmax")
                for i, d in enumerate(DIRECTIONS)]
        wl, wc, wr = (torch.stack([t[k] for t in taps]) for k in range(3))
        operands[n] = (x, wl, wc, wr, lam)
        for name, (fn, _) in _ladder_rungs(*operands[n]).items():
            graph = "n/a (synchronises every row)" if name == "per_step" \
                else f"{_graph_ms(fn, 5):.6f}"
            eager = _median_ms(fn, n=5 if name == "per_step" else 20)
            print(f"ladder time n={n} g={g} cpw=2 float32 rung={name}: "
                  f"graph_ms={graph} eager_ms={eager:.6f}", flush=True)

    shapes = {}
    obs.enable()
    try:
        for n in MAIN_WIDTHS:
            rungs = _ladder_rungs(*operands[n])
            want = rungs["pair"][0]()
            scale = want.abs().max().item()
            for name, (fn, expected) in rungs.items():
                first = len(obs.spans("kernel.launch"))
                cuda_lib.clear_counts()
                with obs.trace("ladder.rung", rung=name, n=n):
                    out = fn()
                torch.cuda.synchronize()
                launches = dict(cuda_lib.launch_counts)
                rows = cuda_lib.plain_calls["per_step_row"]
                shapes.update({k: v for k, v in cuda_lib.launch_shapes.items()
                               if k[0] in ("gspn_scan_fwd", "gspn_quad_fwd")})
                spans = {}
                for r in obs.spans("kernel.launch")[first:]:
                    spans[r.args["kernel"]] = spans.get(r.args["kernel"], 0) + 1
                err = (out - want).abs().max().item()
                print(f"ladder pass n={n} rung={name}: launches {launches}, "
                      f"kernel.launch spans {spans}, per-step row steps "
                      f"{rows}, max_abs_err vs pair {err} (tol "
                      f"{1e-5 * scale})", flush=True)
                if launches != expected or spans != expected:
                    raise AssertionError(f"ladder rung {name} at n={n}: "
                                         f"expected launches {expected}")
                if name == "per_step" and rows != 4 * n:
                    raise AssertionError(f"per_step ran {rows} row steps, "
                                         f"expected {4 * n}")
                if out.shape != want.shape or not err <= 1e-5 * scale:
                    raise AssertionError(f"ladder rung {name} at n={n} "
                                         f"disagrees with the pair rung")
    finally:
        obs.disable()
    path = ROOT / "build" / "ladder_trace.json"
    path.parent.mkdir(exist_ok=True)
    obs.save_chrome_trace(path)
    print(f"ladder chrome trace: {path}", flush=True)
    report.summarize_trace(obs.chrome_trace())
    return shapes


def _wall_s(fn, n: int = 5) -> float:
    """Median host-clock seconds of one eager call of ``fn`` that ends in a
    synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _counted(fn, what, expect):
    """Run ``fn`` with the counters at 0; fail unless #1 was launched
    ``expect`` times and no plain scan ran.  Returns fn's result."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.clear_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = cuda_lib.launch_counts["gspn_scan_fwd"]
    plain = sum(cuda_lib.plain_calls.values())
    print(f"lm {what}: #1 launches {launches}, plain scan calls {plain}",
          flush=True)
    if dict(cuda_lib.launch_counts) != ({"gspn_scan_fwd": expect}
                                        if expect else {}) or plain:
        raise AssertionError(f"lm {what}: expected {expect} launches of #1 "
                             f"and no plain scan, got "
                             f"{dict(cuda_lib.launch_counts)} and {plain}")
    return out


def _logits_check(what, got, want, tol=1e-4):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    print(f"lm {what}: logits max_abs_err={err} max_abs={scale} "
          f"tol={tol * scale}", flush=True)
    if not (torch.isfinite(got).all() and err <= tol * scale):
        raise AssertionError(f"lm {what}: logits disagree")


def lm_serve_phase():
    """The LM serving path at full width (``qwen2-1.5b-gspn`` ``full()``):
    kernel path against the plain path, chunk chain against one-shot and
    decode against the forward under the f32 policy, then the engine over
    the requests of ``SERVE_PROMPTS`` under the config's own policy.
    Returns the engine run's launches by shape."""
    from repro_torch import obs
    from repro_torch.configs.base import with_precision
    from repro_torch.configs.qwen2_1_5b_gspn import full
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = full()
    prompts, chunk, new, check_len = (SERVE_PROMPTS, SERVE_CHUNK, SERVE_NEW,
                                      CHECK_LEN)
    device = "cuda"
    per_pass = 2 * cfg.layer_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = lm.LM(cfg, device=device, generator=gen)
    torch.cuda.synchronize()
    print(f"lm {cfg.name}: {lm.count_params(model)} parameters "
          f"({cfg.layer_count()} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, C_proxy {cfg.gspn_proxy_dim}, "
          f"row width {cfg.gspn_row_width}), set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # (b), (c): the f32 policy over the same weights (stored in f32).
    f32 = with_precision(cfg, "f32")
    kern = lm.LM(f32, device="meta")
    kern.load_state_dict(model.state_dict(), assign=True)
    plain = lm.LM(dataclasses.replace(f32, gspn_impl="torch"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    toks = torch.randint(0, cfg.vocab, (1, check_len + 2), generator=gen,
                         device=device)
    prompt = toks[:, :check_len]
    with torch.no_grad():
        logits, caches = _counted(lambda: lm.lm_prefill(kern, prompt,
                                                        check_len + 2),
                                  f"f32 prefill of {check_len}", per_pass)
        want, _ = lm.lm_prefill(plain, prompt, check_len + 2)
        _logits_check(f"f32 prefill of {check_len}, kernel vs plain",
                      logits, want)
        del want
        c = lm.init_lm_cache(f32, 1, check_len + 2, device=device)
        parts = []
        for lo in range(0, check_len, chunk):
            part, c = _counted(
                lambda: lm.lm_prefill_chunk(kern, prompt[:, lo:lo + chunk],
                                            c, lo),
                f"f32 chunk at {lo}", per_pass)
            parts.append(part)
        _logits_check(f"f32 chunk chain of {check_len} vs one-shot",
                      torch.cat(parts, 1), logits)
        worst = max((a.float() - b.float()).abs().max().item()
                    / max(b.float().abs().max().item(), 1e-30)
                    for k in caches for n in caches[k]
                    for a, b in [(c[k][n], caches[k][n])])
        print(f"lm f32 chunk chain caches vs one-shot: worst leaf error / "
              f"largest magnitude {worst:.3e} (tol 1e-4)", flush=True)
        if not worst <= 1e-4:
            raise AssertionError("chunk-chain caches disagree")
        del parts, c
        steps = []
        for i in (check_len, check_len + 1):
            step, caches = _counted(
                lambda: lm.lm_decode_step(kern, toks[:, i:i + 1], caches),
                f"f32 decode step at {i}", 0)
            steps.append(step)
        full_logits = lm.apply_lm(kern, toks)[:, check_len:]
        _logits_check("f32 decode vs apply_lm", torch.cat(steps, 1),
                      full_logits)
        del logits, caches, steps, full_logits, kern, plain
    print(f"lm f32 checks: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    # (d): the engine under the config's own policy.
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, batch_size=4, max_len=max(prompts) + new,
                      prefill_chunk=chunk)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=rng).numpy(),
                    max_new_tokens=new) for i, n in enumerate(prompts)]
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    obs.clear()
    obs.enable()
    try:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        obs.disable()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain_calls = sum(cuda_lib.plain_calls.values())
    m = eng.metrics
    passes = m["prefills"] + m["prefill_chunks"]
    results = [h.result() for h in handles]
    total = sum(len(r.tokens) for r in results)
    for r, n in zip(results, prompts):
        print(f"lm serve request {r.uid}: prompt {n}, ttft "
              f"{r.ttft * 1e3:.3f} ms, queue {r.queue_delay * 1e3:.3f} ms, "
              f"chunks {r.prefill_chunks}, {len(r.tokens)} tokens "
              f"{r.tokens}", flush=True)
    step_ms = [s.dur / 1e6 for s in obs.spans("serve.decode_step")]
    chunk_ms = [s.dur / 1e6 for s in obs.spans("serve.prefill_chunk")]
    print(f"lm serve: {len(results)} requests, {total} tokens in "
          f"{dt:.3f} s ({total / dt:.3f} tok/s); {m['prefills']} one-shot "
          f"prefills, {m['prefill_chunks']} chunks, {m['decode_steps']} "
          f"decode steps; median decode step {statistics.median(step_ms):.3f}"
          f" ms (of {len(step_ms)}), median chunk "
          f"{statistics.median(chunk_ms):.3f} ms (of {len(chunk_ms)}); peak "
          f"memory of the run {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB",
          flush=True)
    print(f"lm serve: #1 launches {launches} by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain_calls}, {per_pass} expected per prefill "
          f"or chunk", flush=True)
    if launches != {"gspn_scan_fwd": per_pass * passes} or plain_calls:
        raise AssertionError(f"lm serve: expected {per_pass} launches of #1 "
                             f"per prefill or chunk ({passes}) and none per "
                             f"decode step")
    if [len(r.tokens) for r in results] != [new] * len(prompts) or \
            not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        raise AssertionError("lm serve: wrong tokens")

    # The card's idle share over one decode step of the 4 slots and one
    # chunk of 1024 tokens resumed at 1024.
    last = eng.last_token
    caches = eng.pool.caches
    c = lm.init_lm_cache(cfg, 1, eng.max_len, device=device)
    for sub in c.values():
        sub["pos"].fill_(chunk)
    ctoks = toks[:, :chunk]
    with torch.no_grad():
        def decode():
            return lm.lm_decode_step(model, last, caches)

        def resume():
            return lm.lm_prefill_chunk(model, ctoks, c, chunk)

        _profile(decode, _wall_s(decode), "lm decode step (4 slots)")
        _profile(resume, _wall_s(resume), f"lm chunk of {chunk}")
    return shapes


def _train_counted(fn, what, expect):
    """Run ``fn`` with the counters at 0; fail unless #1 and #2 were
    launched as ``expect`` says and no plain scan ran.  Returns fn's
    result and the launches by shape."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.clear_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain = sum(cuda_lib.plain_calls.values())
    print(f"lm train {what}: launches {launches} by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain}", flush=True)
    if launches != expect or plain:
        raise AssertionError(f"lm train {what}: expected launches {expect} "
                             f"and no plain scan, got {launches} and {plain}")
    return out, shapes


def _lm_example():
    """``examples/train_lm_torch.py`` as a module."""
    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lm_train_phase():
    """The LM training path at full width (``qwen2-1.5b-gspn`` ``full()``,
    seeded weights, ``synth_tokens`` batches): (a) the f32 kernel path
    against the plain path, loss and every gradient; (b) the config's own
    policy under ``remat="unit"``: a counted step, the timed steps, loss
    and gradients alone, peak memory and a profiled step; (c) the ``bf16``
    preset with the master copy and loss scaling; (d) the trainer twin and
    its restart.  Returns (b)'s counted step's launches by shape."""
    import shutil

    from repro_torch.configs.base import with_precision
    from repro_torch.configs.qwen2_1_5b_gspn import full
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (LossScaleConfig, build_train_step,
                                        init_train_state)

    cfg = full()
    n_layers = cfg.layer_count()
    device = "cuda"

    def batch_of(n, seq, step):
        return to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                               global_batch=n), step), device)

    def loss_and_grads(m, batch):
        loss, _ = lm.lm_loss(m, batch)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    # (a) The f32 policy, no rematerialisation: kernels against plain.
    f32 = dataclasses.replace(with_precision(cfg, "f32"), remat="none")
    gen = torch.Generator(device=device).manual_seed(2)
    model = lm.LM(f32, device=device, generator=gen)
    plain = lm.LM(dataclasses.replace(f32, gspn_impl="torch"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = batch_of(1, CHECK_LEN, 0)
    per = 2 * n_layers
    (loss, grads), _ = _train_counted(
        lambda: loss_and_grads(model, batch),
        f"f32 loss and gradients, 1 x {CHECK_LEN} tokens",
        {"gspn_scan_fwd": per, "gspn_scan_bwd": per})
    want_loss, want = loss_and_grads(plain, batch)
    torch.cuda.synchronize()
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    errs = {n: ((g - w).abs().max() / w.abs().max()).item()
            for (n, _), g, w in zip(model.named_parameters(), grads, want)}
    worst = max(errs, key=errs.get)
    print(f"lm train f32 kernel vs plain: loss {loss.item()} vs "
          f"{want_loss.item()} (relative {rel:.3e}, tol 1e-5); gradients "
          f"of {len(errs)} parameters, worst {worst} at {errs[worst]:.3e} "
          f"of its largest magnitude (tol 1e-4), median "
          f"{statistics.median(errs.values()):.3e}", flush=True)
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("lm train: non-finite gradients")
    if not rel <= 1e-5 or not errs[worst] <= 1e-4:
        raise AssertionError("lm train: kernel path disagrees with the "
                             "plain path")
    del model, plain, grads, want, loss, want_loss
    torch.cuda.empty_cache()

    # (b) The config's own policy (f32 parameters, bf16 products, the
    # mixer in f32) under remat="unit", AdamW.
    if cfg.remat != "unit":
        raise AssertionError(f"full() rematerialises {cfg.remat!r}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=device).manual_seed(3)
    model = lm.LM(cfg, device=device, generator=gen)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    batches = [batch_of(TRAIN_BATCH, TRAIN_SEQ, s) for s in range(2)]
    state, _ = step(state, batches[0])                # warm-up, not counted
    torch.cuda.synchronize()
    (state, metrics), shapes = _train_counted(
        lambda: step(state, batches[1]),
        f"step, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat unit",
        {"gspn_scan_fwd": 4 * n_layers, "gspn_scan_bwd": 2 * n_layers})
    for (g, h, w, _, _) in TRAIN_SHAPES:
        for name, n in (("gspn_scan_fwd", 2 * n_layers),
                        ("gspn_scan_bwd", n_layers)):
            if shapes.get((name, g, h, w, "float32")) != n:
                raise AssertionError(f"lm train: expected {n} launches of "
                                     f"{name} at {g}x{h}x{w}")
    print(f"lm train step metrics: " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in metrics.items()), flush=True)

    batch = batches[1]
    dt_grads = _wall_s(lambda: loss_and_grads(model, batch), n=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for s in range(TRAIN_STEPS):
        b = batch_of(TRAIN_BATCH, TRAIN_SEQ, 2 + s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"lm train step {TRAIN_BATCH} x {TRAIN_SEQ} tokens, its own "
          f"policy, remat unit, AdamW: median {dt * 1e3:.3f} ms of "
          f"{TRAIN_STEPS} steps ({[round(t * 1e3, 3) for t in times]}), "
          f"{tokens / dt:.1f} tokens/s; loss and gradients alone "
          f"{dt_grads * 1e3:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
          f"{losses}", flush=True)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("lm train: non-finite loss")
    _profile(lambda: step(state, batch), dt, "lm train step")
    del model, state, step, batches, batch, metrics
    torch.cuda.empty_cache()

    # (c) The bf16 preset: bf16 parameters and scans, the f32 master copy
    # and dynamic loss scaling.
    bf16 = with_precision(cfg, "bf16")
    gen = torch.Generator(device=device).manual_seed(4)
    model = lm.LM(bf16, device=device, generator=gen)
    ls = LossScaleConfig()
    state = init_train_state(model, ocfg, master_weights=True,
                             loss_scaling=ls)
    step = build_train_step(model, ocfg, master_weights=True,
                            loss_scaling=ls)
    torch.cuda.reset_peak_memory_stats()
    for s in range(2):
        b = batch_of(TRAIN_BATCH, TRAIN_SEQ, s)
        t0 = time.perf_counter()
        (state, metrics), bshapes = _train_counted(
            lambda: step(state, b), f"bf16 master step {s}",
            {"gspn_scan_fwd": 4 * n_layers, "gspn_scan_bwd": 2 * n_layers})
        dt_b = time.perf_counter() - t0
        if {k[-1] for k in bshapes} != {"bfloat16"}:
            raise AssertionError("lm train: the bf16 step ran f32 scans")
        same = all(torch.equal(p, state["master"][n].to(torch.bfloat16))
                   for n, p in state["params"].items())
        print(f"lm train bf16 master step {s}: {dt_b * 1e3:.3f} ms, loss "
              f"{float(metrics['loss']):.6f}, grads_finite "
              f"{float(metrics['grads_finite']):.0f}, loss scale "
              f"{float(metrics['loss_scale'])} -> "
              f"{float(state['loss_scale']['scale'])}, working copy == "
              f"master rounded to bf16: {same}", flush=True)
        if float(metrics["grads_finite"]) != 1.0 or not same:
            raise AssertionError("lm train: bf16 master step failed")
    print(f"lm train bf16 master steps: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del model, state, step, metrics
    torch.cuda.empty_cache()

    # (d) The trainer twin, then a restart from its checkpoint.
    ckpt = ROOT / "build" / "lm_twin_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    example = _lm_example()
    argv = ["--preset", "small", "--mixer", "gspn", "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    tr = example.main(argv + ["--steps", str(TWIN_STEPS)])
    print(f"lm trainer twin: loss {tr.history[0]:.4f} -> "
          f"{tr.history[-1]:.4f} over {len(tr.history)} steps, "
          f"{tr.recoveries} recoveries, {tr.stragglers} stragglers, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not tr.history[-1] < tr.history[0] or tr.step != TWIN_STEPS:
        raise AssertionError("lm trainer twin: the loss did not fall")
    tr = example.main(argv + ["--steps", "10"])
    print(f"lm trainer twin restart: resumed at step {tr._first_step}, "
          f"ran to {tr.step}, loss {tr.history[0]:.4f} -> "
          f"{tr.history[-1]:.4f}", flush=True)
    if tr._first_step != TWIN_STEPS or tr.step != TWIN_STEPS + 10 or \
            not all(map(math.isfinite, tr.history)):
        raise AssertionError("lm trainer twin did not restart from its "
                             "checkpoint")
    return shapes


def _no_scans(fn, what):
    """Run ``fn`` with the counters at 0; fail if any GSPN scan ran (the
    attention path launches no kernel of its own and no scan).  Returns
    fn's result."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.clear_counts()
    out = fn()
    torch.cuda.synchronize()
    if cuda_lib.launch_counts or cuda_lib.plain_calls:
        raise AssertionError(f"lm attn {what}: a scan ran: "
                             f"{dict(cuda_lib.launch_counts)}, "
                             f"{dict(cuda_lib.plain_calls)}")
    return out


def _exact_attention(q, k, v):
    """Causal GQA attention in f64 (q's head h reads kv head h // G),
    returned in q's dtype: the exact value both f32 paths round."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(d)
    i = torch.arange(s, device=q.device)
    p = torch.softmax(torch.where(i[None, :] <= i[:, None], logits,
                                  -math.inf), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.double())
    return out.reshape(b, s, hq, d).to(q.dtype)


def lm_attn_phase():
    """The attn block kind at full width: ``qwen2-1.5b`` ``full()`` with
    seeded weights.  (a) Under the f32 policy: a chunk chain against the
    one-shot prefill, decode against ``apply_lm``, and
    ``chunked_attention`` against ``full_attention`` at one layer's
    shapes; (b) the engine over ``SERVE_PROMPTS`` under the config's own
    policy; (c) training at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` under
    ``remat="unit"`` with AdamW; (d) ``granite-3-2b`` ``full()`` under the
    f32 policy, prefill and decode against ``apply_lm``."""
    from repro_torch import obs
    from repro_torch.configs import granite_3_2b
    from repro_torch.configs.base import with_precision
    from repro_torch.configs.qwen2_1_5b import full
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    from repro_torch.models import attention, lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.step import build_train_step, init_train_state

    cfg = full()
    device = "cuda"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = lm.LM(cfg, device=device, generator=gen)
    torch.cuda.synchronize()
    print(f"lm attn {cfg.name}: {lm.count_params(model)} parameters "
          f"({cfg.layer_count()} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads}, head_dim {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, qkv bias {cfg.qkv_bias}, "
          f"tied {cfg.tie_embeddings}), set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # (a) The f32 policy over the same weights (stored in f32).
    f32 = with_precision(cfg, "f32")
    kern = lm.LM(f32, device="meta")
    kern.load_state_dict(model.state_dict(), assign=True)
    chunk, check_len = SERVE_CHUNK, CHECK_LEN
    max_len = check_len + 2
    toks = torch.randint(0, cfg.vocab, (1, max_len), generator=gen,
                         device=device)
    prompt = toks[:, :check_len]
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = _no_scans(
            lambda: lm.lm_prefill(kern, prompt, max_len),
            f"f32 prefill of {check_len}")
        print(f"lm attn f32 prefill of {check_len}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
        c = lm.init_lm_cache(f32, 1, max_len, device=device)
        parts = []
        for lo in range(0, check_len, chunk):
            part, c = _no_scans(
                lambda: lm.lm_prefill_chunk(kern, prompt[:, lo:lo + chunk],
                                            c, lo),
                f"f32 chunk at {lo}")
            parts.append(part)
        _logits_check(f"attn f32 chunk chain of {check_len} vs one-shot",
                      torch.cat(parts, 1), logits)
        worst = max((a.float() - b.float()).abs().max().item()
                    / max(b.float().abs().max().item(), 1e-30)
                    for k in caches for n in ("k", "v")
                    for a, b in [(c[k][n], caches[k][n])])
        print(f"lm attn f32 chunk chain KV caches vs one-shot: worst leaf "
              f"error / largest magnitude {worst:.3e} (tol 1e-4)",
              flush=True)
        if not worst <= 1e-4 or not all(
                torch.equal(c[k]["length"], caches[k]["length"])
                for k in caches):
            raise AssertionError("lm attn: chunk-chain caches disagree")
        del parts, c
        steps = []
        for i in (check_len, check_len + 1):
            step, caches = _no_scans(
                lambda: lm.lm_decode_step(kern, toks[:, i:i + 1], caches),
                f"f32 decode step at {i}")
            steps.append(step)
        # The reference forward of all max_len tokens with its attention
        # dense: 2050 = 2 x 1025 would halve block_k from 512 down to 2.
        dense = lm.LM(dataclasses.replace(f32, attn_block_k=max_len),
                      device="meta")
        dense.load_state_dict(model.state_dict(), assign=True)
        t0 = time.perf_counter()
        full_logits = _no_scans(lambda: lm.apply_lm(dense, toks),
                                f"f32 apply_lm of {max_len}")
        print(f"lm attn f32 apply_lm of {max_len} tokens (attention dense, "
              f"attn_block_k {max_len}): "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
        _logits_check("attn f32 decode vs apply_lm", torch.cat(steps, 1),
                      full_logits[:, check_len:])
        del logits, caches, steps, full_logits, kern, dense

    # One layer's attention in f32: blockwise against dense, forward and
    # gradients, at 1 x 4096 tokens; and each against the exact (f64)
    # attention, which tells the two paths' own f32 rounding apart.
    g2 = torch.Generator(device=device).manual_seed(5)
    seq = 4096
    shapes = ((1, seq, cfg.n_heads, cfg.hd), (1, seq, cfg.n_kv_heads, cfg.hd),
              (1, seq, cfg.n_kv_heads, cfg.hd))
    qkv = [torch.randn(s, generator=g2, device=device).requires_grad_()
           for s in shapes]
    ct = torch.randn(shapes[0], generator=g2, device=device)
    outs = {}
    for name, fn in (("chunked", lambda *a: attention.chunked_attention(
            *a, block_k=cfg.attn_block_k)),
                     ("full", attention.full_attention),
                     ("exact", _exact_attention)):
        out = fn(*qkv)
        outs[name] = (out.detach(), *torch.autograd.grad(out, qkv, ct))

    def errs(a, b):
        return [((x.double() - y.double()).abs().max()
                 / y.double().abs().max()).item()
                for x, y in zip(outs[a], outs[b])]

    for a, b in (("chunked", "full"), ("chunked", "exact"),
                 ("full", "exact")):
        e = errs(a, b)
        print(f"lm attn {a} vs {b} attention, 1 x {seq}, {cfg.n_heads} "
              f"over {cfg.n_kv_heads} heads, {cfg.hd}, f32: error / "
              f"largest magnitude out {e[0]:.3e}, dq {e[1]:.3e}, dk "
              f"{e[2]:.3e}, dv {e[3]:.3e}", flush=True)
    if not max(errs("chunked", "exact")) <= 1e-5:
        raise AssertionError("lm attn: chunked_attention is not within "
                             "1e-5 of the exact attention")
    if not max(errs("chunked", "full")) <= 2e-5:
        raise AssertionError("lm attn: chunked_attention disagrees with "
                             "full_attention")
    del qkv, ct, outs
    print(f"lm attn f32 checks: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    # (b) The engine under the config's own policy.
    torch.cuda.reset_peak_memory_stats()
    prompts, new = SERVE_PROMPTS, SERVE_NEW
    eng = ServeEngine(model, batch_size=4, max_len=max(prompts) + new,
                      prefill_chunk=chunk)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=rng).numpy(),
                    max_new_tokens=new) for i, n in enumerate(prompts)]
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    obs.clear()
    obs.enable()
    try:
        t0 = time.perf_counter()
        _no_scans(eng.run, "engine run")
        dt = time.perf_counter() - t0
    finally:
        obs.disable()
    m = eng.metrics
    results = [h.result() for h in handles]
    total = sum(len(r.tokens) for r in results)
    for r, n in zip(results, prompts):
        print(f"lm attn serve request {r.uid}: prompt {n}, ttft "
              f"{r.ttft * 1e3:.3f} ms, queue {r.queue_delay * 1e3:.3f} ms, "
              f"chunks {r.prefill_chunks}, {len(r.tokens)} tokens "
              f"{r.tokens}", flush=True)
    step_ms = [s.dur / 1e6 for s in obs.spans("serve.decode_step")]
    chunk_ms = [s.dur / 1e6 for s in obs.spans("serve.prefill_chunk")]
    print(f"lm attn serve: {len(results)} requests, {total} tokens in "
          f"{dt:.3f} s ({total / dt:.3f} tok/s); {m['prefills']} one-shot "
          f"prefills, {m['prefill_chunks']} chunks, {m['decode_steps']} "
          f"decode steps; median decode step {statistics.median(step_ms):.3f}"
          f" ms (of {len(step_ms)}), median chunk "
          f"{statistics.median(chunk_ms):.3f} ms (of {len(chunk_ms)}); KV "
          f"pool {eng.pool.nbytes} bytes ({max(prompts) + new} positions x "
          f"4 slots); peak memory of the run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if [len(r.tokens) for r in results] != [new] * len(prompts) or \
            not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        raise AssertionError("lm attn serve: wrong tokens")
    last, pooled = eng.last_token, eng.pool.caches
    c = lm.init_lm_cache(cfg, 1, eng.max_len, device=device)
    ctoks = toks[:, :chunk]
    with torch.no_grad():
        def decode():
            return lm.lm_decode_step(model, last, pooled)

        def resume():
            return lm.lm_prefill_chunk(model, ctoks, c, chunk)

        _profile(decode, _wall_s(decode), "lm attn decode step (4 slots)",
                 spans="attention.")
        _profile(resume, _wall_s(resume), f"lm attn chunk of {chunk} at "
                                          f"{chunk}", spans="attention.")
    del eng, last, pooled, c, model
    torch.cuda.empty_cache()

    # (c) Training under the config's own policy, remat="unit", AdamW.
    if cfg.remat != "unit":
        raise AssertionError(f"full() rematerialises {cfg.remat!r}")

    def batch_of(n, seq, step):
        return to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                               global_batch=n), step), device)

    def loss_and_grads(m, batch):
        loss, _ = lm.lm_loss(m, batch)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    tokens = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=device).manual_seed(3)
    model = lm.LM(cfg, device=device, generator=gen)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    batch = batch_of(TRAIN_BATCH, TRAIN_SEQ, 0)
    state, metrics = _no_scans(lambda: step(state, batch), "train step")
    print(f"lm attn train step metrics: " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in metrics.items()), flush=True)
    dt_grads = _wall_s(lambda: loss_and_grads(model, batch), n=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for s in range(TRAIN_STEPS):
        b = batch_of(TRAIN_BATCH, TRAIN_SEQ, 1 + s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"lm attn train step {TRAIN_BATCH} x {TRAIN_SEQ} tokens, its own "
          f"policy, remat unit, AdamW: median {dt * 1e3:.3f} ms of "
          f"{TRAIN_STEPS} steps ({[round(t * 1e3, 3) for t in times]}), "
          f"{tokens / dt:.1f} tokens/s; loss and gradients alone "
          f"{dt_grads * 1e3:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
          f"{losses}", flush=True)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("lm attn train: non-finite loss")
    # Attention's share: the device time under the attention.* spans of
    # the same profiled step (the blockwise forward, its recompute under
    # remat and its two-sweep backward, in each of the 28 layers).
    _profile(lambda: step(state, batch), dt, "lm attn train step",
             spans="attention.")
    del state, step, metrics, model
    torch.cuda.empty_cache()

    # (d) granite-3-2b full() under the f32 policy: no qkv bias, groups of
    # 4, an odd vocabulary.
    gcfg = with_precision(granite_3_2b.full(), "f32")
    gen = torch.Generator(device=device).manual_seed(7)
    t0 = time.perf_counter()
    model = lm.LM(gcfg, device=device, generator=gen)
    print(f"lm attn {gcfg.name}: {lm.count_params(model)} parameters "
          f"({gcfg.layer_count()} layers, d_model {gcfg.d_model}, "
          f"{gcfg.n_heads} heads over {gcfg.n_kv_heads}, vocab {gcfg.vocab}, "
          f"qkv bias {gcfg.qkv_bias}), f32, set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    plen, n_dec = 1024, 4
    gtoks = torch.randint(0, gcfg.vocab, (1, plen + n_dec), generator=gen,
                          device=device)
    with torch.no_grad():
        logits, caches = _no_scans(
            lambda: lm.lm_prefill(model, gtoks[:, :plen], plen + n_dec),
            f"granite prefill of {plen}")
        steps = []
        for i in range(plen, plen + n_dec):
            step_logits, caches = _no_scans(
                lambda: lm.lm_decode_step(model, gtoks[:, i:i + 1], caches),
                f"granite decode step at {i}")
            steps.append(step_logits)
        full_logits = lm.apply_lm(model, gtoks)
        _logits_check(f"attn {gcfg.name} f32 prefill of {plen} vs "
                      f"apply_lm", logits, full_logits[:, :plen])
        _logits_check(f"attn {gcfg.name} f32 {n_dec} decode steps vs "
                      f"apply_lm", torch.cat(steps, 1), full_logits[:, plen:])
    if full_logits.shape[-1] != gcfg.vocab:
        raise AssertionError("lm attn granite: wrong vocabulary")
    del model, logits, caches, steps, full_logits
    torch.cuda.empty_cache()


def main() -> int:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib

    print(" / ".join(_run([cuda_lib.nvcc_path(), "--version"])
                     .splitlines()[-2:]))
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi, flush=True)
    # Full f32 in convolutions and matrix products for every comparison.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"build {time.perf_counter() - t0:.3f} s", flush=True)
    for name, log in cuda_lib.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_phase(gen)
    # #2's launches are those of the single-direction gradient.
    single_bwd = {k: v for k, v in single_direction_grad_check(gen).items()
                  if k[0] == "gspn_scan_bwd"}
    shapes = model_phase(torch.Generator().manual_seed(0))
    # The adjoints' launches are those of the counted training step.
    shapes.update({k: v for k, v in
                   train_phase(torch.Generator().manual_seed(0)).items()
                   if k[0].endswith("_bwd")})
    twin_phase()
    shapes.update(ladder_phase(torch.Generator(device="cuda").manual_seed(1)))
    shapes.update(single_bwd)
    # #1's launches at the serving shapes are those of the engine's run.
    shapes.update(lm_serve_phase())
    # #1's and #2's at the training shapes, those of the counted step.
    shapes.update(lm_train_phase())
    # The attention LM launches no kernel: its phase adds no launches.
    lm_attn_phase()

    entries = []
    for row in rows:
        if row["dtype"] != "float32" or "ms" not in row:
            continue
        key = (row["kernel"], row["g"], row["h"], row["w"], row["dtype"])
        entries.append({
            "name": f"{row['kernel']}@G{row['g']}xH{row['h']}xW{row['w']}"
                    f"/{row['dtype']}",
            "route": "cuda", "source": SOURCES[row["kernel"]],
            "replaces": REPLACES[row["kernel"]],
            "launches": shapes.get(key, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "cold_ms": row.get("cold_ms"),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
