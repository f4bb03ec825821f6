"""Unified observability: structured tracing + metrics registry
(DESIGN.md §13), the port's own copy of ``repro.obs`` with the same API
and record formats; enabled spans enter ``torch.profiler.record_function``
(see :mod:`repro_torch.obs.tracing`).

One import surface for every instrumented layer; in the port those are
the kernel layer, whose dispatches and launches enter spans, the serving
engine (``serve.*`` spans, ``serve_*`` metrics) and the sequence-parallel
scan (``sp.*`` spans, the ``sp.exchange`` event, ``sp_*`` counters; see
:mod:`repro_torch.parallel.gspn_sp`)::

    from repro_torch import obs

    with obs.trace("kernel.launch", kernel="gspn_quad_fwd", g=128) as sp:
        ...
    obs.counter("example_total").inc()

Tracing is OFF by default (``obs.enable()`` turns it on; disabled spans
are shared no-op singletons).  Metrics are always on.
Export via :func:`save_chrome_trace` (Perfetto / chrome://tracing) and
:func:`save_metrics` (JSON or Prometheus text); pretty-print either with
``python -m repro_torch.obs.report``.
"""

from repro_torch.obs.metrics import (DEPTH_BUCKETS, LATENCY_BUCKETS,  # noqa: F401
                               REGISTRY, Counter, Gauge, Histogram,
                               Registry, counter, gauge, histogram,
                               prometheus, snapshot)
from repro_torch.obs.metrics import save_snapshot as save_metrics  # noqa: F401
from repro_torch.obs.tracing import (NOOP_SPAN, Span, async_begin,  # noqa: F401
                               async_end, chrome_trace, clear, disable,
                               enable, enabled, event, monotonic,
                               monotonic_ns, records, save_chrome_trace,
                               spans, trace)
