"""One :class:`~repro_torch.serve.engine.ServeEngine` behind the router
(DESIGN.md §15), the port of ``repro.serve.replica``.

A replica owns its engine exclusively.  The router hands requests over
through a locked inbox; the engine itself is only ever touched by the
replica's scheduling context: either the caller's thread (sync mode,
``tick()``), or the replica's worker thread (``start()``), which loops
admit→prefill→decode quanta until stopped.  That single-owner rule is
what makes the tier safe without locking the engine.  PyTorch releases
the GIL inside its operators and the kernel wrappers' ``ctypes`` calls
release it too, and each engine ticks on its own CUDA stream, so N
replica workers on one card overlap their host and device work.

Failure semantics: ``fail()`` stops the worker, evacuates every
unfinished request (inbox + engine queue + admitted slots) and returns
``[(Request, RequestHandle), ...]`` with handles reset to ``queued`` —
the router re-submits them to survivors under the same handles, so a
caller's handle survives the replica it was first placed on.  Decode
progress on the failed replica is discarded (restart semantics).  Every
wait has a timeout: a worker that does not stop within ``JOIN_TIMEOUT``
seconds raises rather than hanging its caller.
"""

from __future__ import annotations

import collections
import threading
import time

from repro_torch import obs

# Seconds a stop waits for the worker thread.
JOIN_TIMEOUT = 30.0


class Replica:
    """A routed serving replica: engine + inbox + optional worker thread."""

    def __init__(self, rid: int, engine):
        self.rid = rid
        self.engine = engine
        self.alive = True
        self.error: Exception | None = None
        self.on_result = None            # router installs: fn(rid, Result)
        self._inbox = collections.deque()  # [(Request, RequestHandle)]
        self._lock = threading.Lock()
        self._thread = None
        self._running = False
        self._busy = False               # mid-tick (see ``idle``)
        engine._finish_hook = self._finished

    def _finished(self, res):
        if self.on_result is not None:
            self.on_result(self.rid, res)

    # -- routing-side surface (any thread) ----------------------------------
    def submit(self, req, handle):
        """Hand a request over.  Validation runs here, synchronously, so
        an oversized request raises at the submitter — not inside the
        worker thread where the error would be orphaned."""
        self.engine.check_fits(req)
        handle.replica = self.rid
        with self._lock:
            self._inbox.append((req, handle))

    @property
    def load(self) -> int:
        """Requests on this replica in any pre-finished state: inbox +
        admission queue + in-flight prefill + active decode slots.  The
        least-loaded policy's signal."""
        eng = self.engine
        with self._lock:
            n = len(self._inbox)
        n += eng.queue_depth + int(eng.active.sum())
        if eng._inflight is not None:
            n += 1
        return n

    @property
    def pending_chunks(self) -> int:
        """Prefill chunks of work ahead of a new arrival (engine estimate
        plus the not-yet-drained inbox) — the TTFT-predictive policy's
        work signal."""
        chunk = self.engine.prefill_chunk or 1
        n = self.engine.pending_chunks
        with self._lock:
            for req, _h in self._inbox:
                n += max(-(-len(req.prompt) // chunk), 1)
        return n

    @property
    def idle(self) -> bool:
        """False while anything is queued, in flight, or mid-tick.  The
        ``_busy`` leg matters in threaded mode: the engine's own ``idle``
        flickers true inside a tick (a request popped from the queue is
        not yet marked active until its prefill returns), and a ``drive``
        loop polling from another thread must not mistake that for
        drained."""
        if self._busy:
            return False
        with self._lock:
            if self._inbox:
                return False
        return self.engine.idle

    # -- scheduling (owner context only) ------------------------------------
    def _drain_inbox(self):
        while True:
            with self._lock:
                if not self._inbox:
                    return
                req, h = self._inbox.popleft()
                # submit under the lock: ``idle`` must never observe the
                # gap between popping the inbox and queuing on the engine
                # (a ``drive`` loop polling idle would call the drain done
                # early)
                self.engine.submit(req, handle=h)

    def tick(self):
        """One replica quantum: drain the inbox, run one engine tick."""
        self._busy = True
        try:
            self._drain_inbox()
            if not self.engine.idle:
                self.engine.tick()
        finally:
            self._busy = False

    # -- threaded mode -------------------------------------------------------
    def start(self):
        """Run the scheduling loop on a worker thread (the engine's tick
        enters the engine's CUDA stream on that thread)."""
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name=f"replica-{self.rid}", daemon=True)
        self._thread.start()

    def _loop(self):
        with self.engine._on_stream():
            while self._running:
                if self.idle:
                    time.sleep(0.0005)
                    continue
                try:
                    self.tick()
                except Exception as exc:  # noqa: BLE001 — surfaced via .error
                    # An orphaned worker exception must not vanish: record
                    # it, mark the replica dead, and let the router's next
                    # tick drain this replica to survivors.
                    self.error = exc
                    self.alive = False
                    obs.event("replica.error", rid=self.rid,
                              error=repr(exc))
                    return

    def stop(self):
        """Stop the worker thread after its current tick."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=JOIN_TIMEOUT)
            if self._thread.is_alive():
                raise RuntimeError(f"replica {self.rid}: the worker did "
                                   f"not stop within {JOIN_TIMEOUT} s")
            self._thread = None

    # -- failure -------------------------------------------------------------
    def fail(self) -> list:
        """Kill this replica and evacuate everything unfinished.  Returns
        ``[(Request, RequestHandle), ...]`` — inbox arrivals after the
        engine's own drain order (admitted first, then queued) so the
        earliest-placed work is re-routed first."""
        self.alive = False
        self.stop()
        with self._lock:
            inbox = list(self._inbox)
            self._inbox.clear()
        obs.event("replica.failed", rid=self.rid,
                  evacuated=len(inbox))
        return self.engine.drain() + inbox
