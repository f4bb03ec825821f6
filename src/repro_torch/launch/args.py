"""Launcher flags shared by the entry points, the port's copy of
``repro.launch.args``: the kernel impl, the precision policy with the
pooled state's dtype, the device, the tuning cache, the serving tier's
router flags, and the trace and metrics outputs.  The serve launcher
defines ``--seq-parallel`` itself, and the train launcher its
multi-host flags, as the reference's do.
"""

from __future__ import annotations

from repro_torch import obs
from repro_torch.configs.base import PRECISIONS


def add_observability_args(ap):
    """``--trace-out`` / ``--metrics-out`` (DESIGN.md §13)."""
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run here "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics-registry snapshot here "
                         "(.prom => Prometheus text, else JSON)")


def add_tuning_args(ap):
    """``--tune-cache`` (DESIGN.md §11)."""
    ap.add_argument("--tune-cache", default="",
                    help="kernel tuning cache JSON (DESIGN.md §11), "
                         "layered over the seed cache measured on the "
                         "H100; every scan launch then takes its launch "
                         "shape from it where it holds a valid entry")


def add_router_args(ap):
    """The serving tier's ``--replicas``, ``--router``, ``--prefix-cache``
    and ``--slo-ttft`` (DESIGN.md §15), with the reference's defaults."""
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the router (1 = a bare "
                         "engine, no router tier); on one card they share "
                         "the model's weights")
    ap.add_argument("--router", default="least_loaded",
                    choices=["least_loaded", "ttft"],
                    help="admission policy: fewest in-flight requests, or "
                         "TTFT-predictive (work ahead x measured per-chunk "
                         "latency)")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="capacity (entries) of the shared prefix-state "
                         "cache; 0 disables prefix reuse")
    ap.add_argument("--slo-ttft", type=float, default=0.5,
                    help="TTFT SLO in seconds; admissions predicted to "
                         "miss it count router_slo_at_risk_total")


def add_impl_arg(ap):
    """``--impl``: the GSPN scan's implementation."""
    ap.add_argument("--impl", default="",
                    choices=["", "auto", "cuda", "torch", "sp"],
                    help="the GSPN scan's implementation: auto (the CUDA "
                         "kernel on the card, the plain scan on the CPU), "
                         "cuda, torch (the plain scan), or sp (rows "
                         "sharded over the seq mesh, block-local scans as "
                         "auto)")


def add_precision_args(ap, *, state_dtype: bool = False):
    """``--precision`` (and optionally ``--state-dtype``), DESIGN.md §10."""
    ap.add_argument("--precision", default="",
                    choices=[""] + sorted(PRECISIONS),
                    help="mixed-precision policy (params/compute/carries)")
    if state_dtype:
        ap.add_argument("--state-dtype", default="",
                        choices=["", "f32", "bf16"],
                        help="at-rest dtype of the pooled propagation "
                             "state (bf16 halves the pool's bytes)")


def add_device_arg(ap):
    """``--device``: the card unless the caller asks for another."""
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain path on the CPU)")


def setup_observability(args):
    """Enable tracing before the model is built, so every span is kept."""
    if args.trace_out:
        obs.enable()


def finish_observability(args, tag: str):
    """Write the trace and metrics files the flags name (no-ops when they
    are unset)."""
    if args.trace_out:
        print(f"[{tag}] trace: {obs.save_chrome_trace(args.trace_out)} "
              f"({len(obs.records())} events)")
    if args.metrics_out:
        print(f"[{tag}] metrics: {obs.save_metrics(args.metrics_out)}")


def load_tune_cache(args, tag: str):
    """Layer ``--tune-cache`` over the global tuning cache (no-op when
    unset)."""
    if args.tune_cache:
        from repro_torch.kernels.autotune import load_cache
        n = load_cache(args.tune_cache)
        print(f"[{tag}] tuning cache: {n} entries from {args.tune_cache}")
