"""Typed metrics registry: counters, gauges, fixed-bucket histograms
(DESIGN.md §13), the port's copy of ``repro.obs.metrics``.

Unlike tracing (off by default), metrics are ALWAYS on: a counter
increment is one lock acquire + one int add, cheap enough for a hot
loop.  The registry is a process-global name → metric map with
get-or-create semantics, exported two ways:

* :meth:`Registry.snapshot` — plain-JSON dict (written by
  :func:`save_snapshot`; pretty-printed by
  ``python -m repro_torch.obs.report``);
* :meth:`Registry.prometheus` — Prometheus text exposition format
  (cumulative ``le`` buckets, ``_sum``/``_count`` series) so a real
  deployment can scrape the same registry.

Histogram semantics follow Prometheus: bucket ``i`` counts observations
``v <= edges[i]`` (upper bounds are INCLUSIVE — an exact-boundary value
lands in its edge's bucket), with one implicit overflow bucket
(``+Inf``) past the last edge.  The first bucket doubles as the
underflow bucket: every observation below ``edges[0]`` lands there.
:data:`LATENCY_BUCKETS` spans 100µs–10s logarithmically, the
reference's buckets.
"""

from __future__ import annotations

import bisect
import json
import math
import threading

# Log-spaced seconds, 1-2.5-5 per decade.
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Small-integer buckets (queue depths, batch occupancy).
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class Counter:
    """Monotonically increasing count."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0

    def set(self, v: float):
        self._value = float(v)

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram with inclusive upper-bound edges.

    ``counts[i]`` holds observations ``edges[i-1] < v <= edges[i]``
    (``counts[0]``: ``v <= edges[0]``, the underflow-inclusive bucket);
    ``counts[-1]`` is the ``+Inf`` overflow bucket.  Tracks sum, count,
    min and max alongside.
    """

    def __init__(self, name: str, buckets=LATENCY_BUCKETS, help: str = ""):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name}: edges must be strictly "
                             f"increasing and non-empty, got {buckets}")
        self.name, self.help = name, help
        self.edges = edges
        self._lock = threading.Lock()
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float):
        v = float(v)
        # bisect_left: first edge >= v, so v == edge stays in edge's
        # bucket (inclusive upper bound); v > edges[-1] overflows.
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def quantile(self, q: float) -> float:
        """Approximate quantile: the upper edge of the bucket where the
        cumulative count crosses ``q`` (max observed for overflow)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(q)
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                return self.edges[i] if i < len(self.edges) else self.max
        return self.max

    def to_dict(self) -> dict:
        return {"buckets": list(self.edges), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None}


class Registry:
    """Process-global name → metric map with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, cls, name, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, buckets=LATENCY_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, buckets, help)

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self):
        """Drop every metric (tests); accessors re-create lazily."""
        with self._lock:
            self._metrics.clear()

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serialisable snapshot of every registered metric."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.to_dict()
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition format (cumulative le buckets)."""
        lines = []
        with self._lock:
            items = list(self._metrics.items())
        for name, m in sorted(items):
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(m)]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name} {m.value}")
            else:
                acc = 0
                for edge, c in zip(m.edges, m.counts):
                    acc += c
                    lines.append(f'{name}_bucket{{le="{edge}"}} {acc}')
                acc += m.counts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {acc}')
                lines.append(f"{name}_sum {m.sum}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


# Module-level conveniences against the global registry — the form the
# instrumented layers use (get-or-create each call, so a test-time
# ``REGISTRY.reset()`` can never leave a layer holding a dead metric).
def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, buckets=LATENCY_BUCKETS, help: str = "") -> Histogram:
    return REGISTRY.histogram(name, buckets, help)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def prometheus() -> str:
    return REGISTRY.prometheus()


def save_snapshot(path) -> str:
    """Write the registry to ``path``: Prometheus text when the suffix is
    ``.prom``, JSON otherwise."""
    path = str(path)
    if path.endswith(".prom"):
        with open(path, "w") as f:
            f.write(prometheus())
    else:
        with open(path, "w") as f:
            json.dump(snapshot(), f, indent=1)
    return path
