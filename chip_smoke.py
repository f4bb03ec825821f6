#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (serving, training and the
four-direction launch ladder) on one CUDA card and hold every CUDA kernel
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
   ragged shape (H = 19, W = 37, cpw 1 and 4) and a chunked one, in
   float32 and bfloat16 streams (tolerance 1e-5 of the largest magnitude,
   1e-2 for the forward's bfloat16 output); at the main-path and 1024²
   shapes, the device time per launch of the kernel and of the plain
   version (CUDA-graph replays timed by CUDA events, median of 20) and of
   one eager call, and at the main-path shapes the kernel's time with the
   L2 flushed before each launch (``cold_ms``, as the main path finds its
   operands in device memory).  #1, #3 and #5 are the D = 1, 2 and 4
   instances of one forward template (a warp per plane, neighbours by
   shuffle, a ``cp.async`` ring in shared memory, taps staged once per
   weight group), #4 its pair adjoint, #2 the first design's single
   adjoint.  Then the gradient of a single-direction ``directional_scan``
   ("rl"), kernels #1 and #2 against the plain path; then the
   single-launch quad kernel (#5) against its plain version at the
   main-path shapes (N = 56/28/14/7), at 1024² (G = 32, N = 256, its
   transposed directions streaming column slabs of x through the ring)
   and on a ragged square (N = 19, cpw 1 and 4), float32 and bfloat16,
   timed through its wrapper, which reads x in place (no stacked copy),
   warm and with a cold L2;
4. model (serving): GSPN-2-T classification forward at 224², batch 64, weights from
   a seeded generator, images from ``synth_images``; the kernel path
   against the plain path on the card (TF32 off for convolutions and
   matrix products, 1e-4 of the largest logit), one counted forward that
   must launch the pair kernel 52 times and never call a plain scan, the
   forward's images/s over 10 timed runs, a profile of one forward
   (device time by kernel, idle share, the forward as one CUDA graph);
   and the reduced model on the card against the plain path on the CPU;
5. training: one GSPN-2-T training step at 224², batch 64, f32: a counted
   ``vision_loss`` + ``backward()`` that must launch the pair kernel and
   its adjoint 52 times each and never call a plain scan, its gradients
   against the plain path on the card (loss 1e-5 relative, each
   parameter's gradient 1e-4 of its largest magnitude), 5 timed runs of
   the loss and gradients alone, 5 timed AdamW steps (step ms, images/s,
   peak memory) and a profile of one step;
6. the trainer twin ``examples/train_vision_torch.py``, 60 steps on the
   reduced model, whose held-out accuracy must end above 2/n_classes;
7. the four-direction launch ladder (the paper's §4.3 design point) at
   GSPN-2-T's stage shapes, batch 64 (G = 128, cpw 2, N = 56/28/14/7,
   float32): the GSPN-1 per-step emulation, one scan per direction (#1
   four times), the pair dispatch (#3 twice) and the quad (#5 once), each
   through the port's public functions and held equal to the pair rung
   (1e-5 of the largest magnitude); its launches asserted from the
   counters and again from the ``kernel.launch`` spans; its device time as
   a CUDA graph and as an eager call (per_step eager only); a Chrome trace
   of one traced pass of every rung written to ``build/ladder_trace.json``.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.
"""

from __future__ import annotations

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
SOURCES = {name: f"src/repro_torch/kernels/csrc/{src}" for name, src in (
    ("gspn_quad_fwd", "gspn_pair.cu"), ("gspn_scan_fwd", "gspn_pair.cu"),
    ("gspn_scan_bwd", "gspn_scan.cu"), ("gspn_pair_fwd", "gspn_pair.cu"),
    ("gspn_pair_bwd", "gspn_pair.cu"))}
# Kernels timed with a cold L2 at the main-path shapes: the forward
# template's instances and the pair adjoint.
COLD = ("gspn_pair_fwd", "gspn_pair_bwd", "gspn_scan_fwd", "gspn_quad_fwd")
# Names of the scan kernels in the profiler's device records.
SCAN_KERNELS = ("gspn_fwd_kernel", "gspn_pair_bwd_kernel",
                "gspn_scan_bwd_kernel")
# The forward template's direction count D of each forward kernel.
NDIR = {"gspn_scan_fwd": 1, "gspn_pair_fwd": 2, "gspn_quad_fwd": 4}


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
    # The adjoints write f32 computed in f32 from the same inputs as their
    # plain versions, in either stream dtype.
    tol = {("fwd", torch.float32): 1e-5, ("fwd", torch.bfloat16): 1e-2,
           ("bwd", torch.float32): 1e-5, ("bwd", torch.bfloat16): 1e-5}
    results = []
    for name, (kernel, plain, pair, kind) in kernels.items():
        for g, h, w, cpw, chunk, dtype, timed in cases:
            args = _scan_inputs(gen, g, h, w, cpw, dtype, pair, kind)
            got = kernel(*args, chunk=chunk)
            want = plain(*args, chunk=chunk)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            dname = str(dtype).removeprefix("torch.")
            row = dict(kernel=name, g=g, h=h, w=w, cpw=cpw, chunk=chunk,
                       dtype=dname, max_abs_err=err, max_abs=scale,
                       tol=tol[kind, dtype] * scale)
            if name != "gspn_scan_bwd":
                row["launch_shape"] = _launch_shape(
                    g, h, w, cpw, dtype, kind, NDIR.get(name, 2))
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
    _single_direction_grad_check(gen)
    return results + _quad_rows(gen)


def _launch_shape(g, h, w, cpw, dtype, kind, ndir):
    """The launch shape ``pair_launch_shape`` picks, as printed in a kernel
    row."""
    from repro_torch.kernels.gspn_scan import pair_launch_shape

    s = pair_launch_shape(g, h, w, cpw, dtype, kind, ndir)
    return (f"planes={s.planes},warps={s.warps},K={s.k},splits={s.splits},"
            f"S={s.stages},batch={s.batch},"
            f"grid={'x'.join(map(str, s.grid))},xpitch={s.xpitch},"
            f"smem={s.smem_bytes}")


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


def _single_direction_grad_check(gen):
    """Gradients of one "rl" ``directional_scan`` (kernels #1 and #2 under
    autograd) against the plain path, 1e-5 of the largest magnitude."""
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


def _profile(fn, wall_s, what):
    """Where one call of ``fn`` spends device time: the profiler's device
    time by kernel, the scan kernels' share (forward and adjoint), and the
    device's idle share of an eager call that took ``wall_s``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Kernel records only: the operator records carry the same device time.
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in ops)
    scan_us = {k: sum(e.self_device_time_total for e in ops
                      if f"{k}<" in e.key)
               for k in SCAN_KERNELS}
    if device_us == 0:
        print(f"profile {what}: the profiler recorded no device time; "
              f"device breakdown not measured", flush=True)
        return
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
    shapes = model_phase(torch.Generator().manual_seed(0))
    # The adjoints' launches are those of the counted training step.
    shapes.update({k: v for k, v in
                   train_phase(torch.Generator().manual_seed(0)).items()
                   if k[0].endswith("_bwd")})
    twin_phase()
    shapes.update(ladder_phase(torch.Generator(device="cuda").manual_seed(1)))

    entries = []
    for row in rows:
        if row["dtype"] != "float32" or row["h"] not in MAIN_WIDTHS:
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
