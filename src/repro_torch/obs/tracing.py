"""Structured tracing: nested spans over a monotonic clock (DESIGN.md §13).

The port's copy of ``repro.obs.tracing``, with the same API and record
format; the one difference is that an enabled span enters
``torch.profiler.record_function(name)`` where the reference enters
``jax.named_scope(name)``.  Design constraints, in order:

1. **Disabled is free.**  One module-level flag guards the fast path;
   ``trace(name)`` with tracing off returns a shared no-op singleton —
   no span object, no clock read, no buffer touch, no profiler record.
2. **Bounded.**  Finished spans land in a ring buffer (``deque`` with
   ``maxlen``); a long run can trace forever without growing.
3. **Thread-safe.**  Spans record the thread id of the thread that
   entered them; ``deque.append`` is atomic under the GIL, so concurrent
   threads interleave records without a lock.  Nesting is reconstructed
   from (tid, ts, dur) intervals — the Chrome trace model — so no
   explicit parent pointers are kept.
4. **Monotonic.**  All durations use ``time.perf_counter_ns``; wall
   clock (``time.time``) is reserved for timestamps in artifacts,
   never for measuring elapsed time.  Other
   modules import :data:`monotonic` from here so the repo has exactly
   one duration clock.

Span kinds (Chrome trace-event phases, loadable in Perfetto or
``chrome://tracing`` via :func:`chrome_trace` / :func:`save_chrome_trace`):

* ``X`` complete spans — ``with trace("kernel.launch", g=128) as sp:
  ...; sp.set(kernel=...)``.  When tracing is enabled the span also
  enters ``torch.profiler.record_function(name)``, so spans line up with
  the operators and kernels of a ``torch.profiler`` trace.
* ``i`` instant events — ``event("train.loss_scale", scale=2048.0)``.
* ``b``/``e`` async spans — ``async_begin("request", uid)`` /
  ``async_end("request", uid)``: long-lived logical operations that
  overlap many thread-local spans.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from torch.profiler import record_function

# THE duration clock of the port: whatever measures elapsed time imports
# these; time.time() is for wall-clock timestamps only.
monotonic = time.perf_counter
monotonic_ns = time.perf_counter_ns

DEFAULT_RING = 65536

_ENABLED = False                     # the one fast-path guard
_BUF: deque = deque(maxlen=DEFAULT_RING)
_T0 = monotonic_ns()                 # trace epoch (set again by enable())


class _NoopSpan:
    """Returned by :func:`trace` when tracing is off.  A singleton: the
    disabled fast path allocates nothing and touches no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Record:
    """One finished trace record (ring-buffer entry)."""

    __slots__ = ("ph", "name", "ts", "dur", "tid", "aid", "args")

    def __init__(self, ph, name, ts, dur=0, tid=0, aid=None, args=None):
        self.ph = ph                 # X | i | b | e  (Chrome phases)
        self.name = name
        self.ts = ts                 # ns, monotonic
        self.dur = dur               # ns (X only)
        self.tid = tid
        self.aid = aid               # async id (b/e only)
        self.args = args or {}


class Span:
    """A live ``X`` span.  ``set(**attrs)`` annotates it after creation —
    the idiom for attributes only known mid-span."""

    __slots__ = ("name", "args", "_t0", "_tid", "_scope")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def set(self, **attrs):
        self.args.update(attrs)
        return self

    def __enter__(self):
        # line our spans up with torch.profiler's timeline
        self._scope = record_function(self.name)
        self._scope.__enter__()
        self._tid = threading.get_ident()
        self._t0 = monotonic_ns()
        return self

    def __exit__(self, et, ev, tb):
        t1 = monotonic_ns()
        self._scope.__exit__(et, ev, tb)
        _BUF.append(Record("X", self.name, self._t0, t1 - self._t0,
                           self._tid, None, self.args))
        return False


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------

def enable(ring: int = DEFAULT_RING):
    """Turn tracing on with a fresh ring buffer of ``ring`` records."""
    global _ENABLED, _BUF, _T0
    _BUF = deque(maxlen=ring)
    _T0 = monotonic_ns()
    _ENABLED = True


def disable():
    """Turn tracing off.  Recorded spans stay readable until the next
    :func:`enable` / :func:`clear`."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def clear():
    _BUF.clear()


def trace(name: str, **attrs):
    """Context manager for one span.  True no-op (shared singleton, no
    allocation beyond the call itself) when tracing is disabled."""
    if not _ENABLED:
        return NOOP_SPAN
    return Span(name, attrs)


def event(name: str, **attrs):
    """Record an instant event (Chrome ``i`` phase)."""
    if not _ENABLED:
        return
    _BUF.append(Record("i", name, monotonic_ns(), 0,
                       threading.get_ident(), None, attrs))


def async_begin(name: str, aid, **attrs):
    """Open an async span (Chrome ``b`` phase) — a logical operation that
    outlives any one stack frame."""
    if not _ENABLED:
        return
    _BUF.append(Record("b", name, monotonic_ns(), 0,
                       threading.get_ident(), aid, attrs))


def async_end(name: str, aid, **attrs):
    if not _ENABLED:
        return
    _BUF.append(Record("e", name, monotonic_ns(), 0,
                       threading.get_ident(), aid, attrs))


def records() -> list:
    """All buffered records, oldest first."""
    return list(_BUF)


def spans(name: str | None = None) -> list:
    """Finished ``X`` spans, optionally filtered by name."""
    return [r for r in _BUF if r.ph == "X"
            and (name is None or r.name == name)]


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing).
# ---------------------------------------------------------------------------

def chrome_trace() -> dict:
    """The buffered records as a Chrome trace-event JSON object.

    Timestamps are microseconds relative to the trace epoch (enable()).
    ``X``/``i`` records keep their recording thread's tid; ``b``/``e``
    async pairs carry their id and render as separate tracks that span
    the thread-local child spans they logically contain.
    """
    pid = os.getpid()
    evs = []
    for r in list(_BUF):
        e = {"ph": r.ph, "name": r.name, "pid": pid, "tid": r.tid,
             "ts": (r.ts - _T0) / 1e3, "cat": "repro"}
        if r.ph == "X":
            e["dur"] = r.dur / 1e3
        if r.ph in ("b", "e"):
            e["cat"] = "request"
            e["id"] = str(r.aid)
        if r.args:
            e["args"] = dict(r.args)
        evs.append(e)
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def save_chrome_trace(path) -> str:
    """Write :func:`chrome_trace` to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f, indent=1)
    return str(path)
