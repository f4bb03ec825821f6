"""Launcher flags shared by the entry points, the port's copy of the
groups of ``repro.launch.args`` that its serving and training paths use:
the kernel impl, the precision policy with the pooled state's dtype, the
device, and the trace and metrics outputs.  The reference's router,
tuning-cache, sequence-parallel and multi-host flags come with the parts
of the port that use them (ROADMAP.md §1 items 2, 4 and 6); until then
they do not parse.
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


def add_impl_arg(ap):
    """``--impl``: the GSPN scan's implementation."""
    ap.add_argument("--impl", default="", choices=["", "auto", "cuda", "torch"],
                    help="the GSPN scan's implementation: auto (the CUDA "
                         "kernel on the card, the plain scan on the CPU), "
                         "cuda, or torch (the plain scan)")


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
