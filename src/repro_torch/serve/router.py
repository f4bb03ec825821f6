"""SLO-aware data-parallel serving router (DESIGN.md §15), the port of
``repro.serve.router``.

N engine replicas behind one submission surface.  The router speaks only
the handle API: ``submit`` places a request on a replica chosen by the
admission policy and returns the
:class:`~repro_torch.serve.engine.RequestHandle`; the handle stays valid
across re-placements (replica failure drains to survivors under the
same handles).  On one card the replicas share one
``LM`` (its weights once) and each engine keeps its own pool, sampling
generator and CUDA stream.

Admission policies (pluggable via ``POLICIES`` or a callable):

* ``least_loaded`` — fewest requests in any pre-finished state;
* ``ttft`` — TTFT-predictive: estimated first-token latency per replica
  = (chunks of prefill work ahead + the request's own chunks) × the
  measured per-chunk latency (the live ``serve_prefill_chunk_seconds``
  histogram mean).  The prediction also powers the SLO awareness: when
  even the best replica's predicted TTFT exceeds ``slo_ttft``, the
  router counts the admission as at-risk (``router_slo_at_risk_total``)
  and emits an event — the fleet-is-too-small signal an autoscaler
  would act on.

Observability: router-level counters/gauges (requests routed, requeues,
replica failures, replicas-alive) plus a predicted-TTFT histogram, and
one async ``router.request`` span per uid that nests over the owning
engine's ``request`` span, so a trace shows placement and execution as
two levels of the same timeline.

Scheduling modes: sync (``tick()`` round-robins every alive replica —
deterministic, what the tests drive) and threaded (``start()`` gives
each replica its own worker; ``tick()`` becomes a short sleep so the
same ``drive()`` loop works unchanged).  A shared
:class:`~repro_torch.serve.cache.PrefixStateCache` can be passed to every
replica's engine so a prefix prefilled anywhere is reusable everywhere.
"""

from __future__ import annotations

import time
from typing import Optional

from repro_torch import obs
from repro_torch.serve.engine import Request, RequestHandle
from repro_torch.serve.replica import Replica


def _router_metrics():
    """Router-level metrics in the process-global registry (get-or-create
    per access, same pattern as the engine's ``_serve_metrics``)."""
    return {
        "routed": obs.counter("router_requests_routed_total",
                              "requests placed on a replica"),
        "requeued": obs.counter("router_requeued_total",
                                "requests re-routed off a failed replica"),
        "failures": obs.counter("router_replica_failures_total",
                                "replica failures handled"),
        "alive": obs.gauge("router_replicas_alive",
                           "replicas currently accepting requests"),
        "pttft": obs.histogram("router_predicted_ttft_seconds",
                               help="admission-time predicted TTFT of the "
                                    "chosen replica (ttft policy)"),
        "slo_risk": obs.counter("router_slo_at_risk_total",
                                "admissions whose predicted TTFT exceeded "
                                "the SLO on every alive replica"),
    }


def _request_chunks(req: Request, replica: Replica) -> int:
    chunk = replica.engine.prefill_chunk or 1
    return max(-(-len(req.prompt) // chunk), 1)


def _mean_chunk_seconds() -> float:
    """Live mean of the engine-measured per-chunk prefill latency — the
    TTFT predictor's cost model.  0.0 until the first chunk has run (the
    predictor then degrades to pure work-ahead counting, which preserves
    the argmin)."""
    h = obs.histogram("serve_prefill_chunk_seconds")
    return h.sum / h.count if h.count else 0.0


def _pick_least_loaded(req, replicas):
    r = min(replicas, key=lambda r: (r.load, r.rid))
    return r, None


def _pick_ttft(req, replicas):
    per_chunk = _mean_chunk_seconds()

    def predicted(r):
        return (r.pending_chunks + _request_chunks(req, r)) * per_chunk \
            if per_chunk else float(r.pending_chunks + _request_chunks(req, r))

    r = min(replicas, key=lambda r: (predicted(r), r.rid))
    return r, (predicted(r) if per_chunk else None)


# Seconds a tick sleeps in threaded mode, where the workers do the work.
POLL = 0.0005

POLICIES = {
    "least_loaded": _pick_least_loaded,
    "ttft": _pick_ttft,
}


class Router:
    """N replicas behind an SLO-aware admission policy."""

    def __init__(self, engines, *, policy="least_loaded",
                 slo_ttft: float = 0.5, threaded: bool = False):
        if not engines:
            raise ValueError("router needs at least one engine")
        if callable(policy):
            self._pick = policy
            self.policy = getattr(policy, "__name__", "custom")
        else:
            if policy not in POLICIES:
                raise ValueError(f"unknown router policy {policy!r}; "
                                 f"expected one of {sorted(POLICIES)} "
                                 "or a callable")
            self._pick = POLICIES[policy]
            self.policy = policy
        self.slo_ttft = slo_ttft
        self.threaded = threaded
        self.replicas = [Replica(rid, eng) for rid, eng in enumerate(engines)]
        for r in self.replicas:
            r.on_result = self._on_result
        _router_metrics()["alive"].set(len(self.replicas))
        self._started = False

    # -- placement -----------------------------------------------------------
    def _alive(self):
        return [r for r in self.replicas if r.alive]

    def submit(self, req: Request,
               handle: Optional[RequestHandle] = None) -> RequestHandle:
        """Place ``req`` on the policy-chosen replica; returns its handle
        (a re-route passes the existing one)."""
        alive = self._alive()
        if not alive:
            raise RuntimeError("no alive replicas")
        m = _router_metrics()
        replica, predicted = self._pick(req, alive)
        if predicted is not None:
            m["pttft"].observe(predicted)
            if predicted > self.slo_ttft:
                # even the best placement is predicted to miss the SLO:
                # the router admits anyway (shedding is a policy layered
                # above) but makes the capacity shortfall observable
                m["slo_risk"].inc()
                obs.event("router.slo_at_risk", uid=req.uid,
                          predicted_ttft_ms=round(predicted * 1e3, 3),
                          slo_ms=round(self.slo_ttft * 1e3, 3))
        if handle is None:
            handle = RequestHandle(uid=req.uid)
            obs.async_begin("router.request", req.uid,
                            policy=self.policy, replica=replica.rid)
        replica.submit(req, handle)
        m["routed"].inc()
        obs.event("router.routed", uid=req.uid, replica=replica.rid,
                  policy=self.policy)
        return handle

    def _on_result(self, rid, res):
        obs.async_end("router.request", res.uid, replica=rid,
                      finish_reason=res.finish_reason)

    # -- scheduling ----------------------------------------------------------
    def tick(self):
        """Sync mode: detect dead replicas (worker errors), then give every
        alive replica one quantum.  Threaded mode: the workers are already
        ticking — yield briefly so ``drive()`` loops don't spin."""
        for r in self.replicas:
            if not r.alive and r.error is not None:
                self.fail_replica(r.rid)
        if self._started:
            time.sleep(POLL)
            return
        for r in self._alive():
            r.tick()

    @property
    def idle(self) -> bool:
        return all(r.idle for r in self._alive())

    def start(self):
        """Threaded mode: one worker per replica."""
        self._started = True
        for r in self._alive():
            r.start()

    def stop(self):
        for r in self.replicas:
            r.stop()
        self._started = False

    # -- failure -------------------------------------------------------------
    def fail_replica(self, rid: int):
        """Kill replica ``rid`` and re-route everything it held to the
        survivors under the callers' existing handles.  Raises if it was
        the last replica alive (requests would be dropped otherwise)."""
        replica = self.replicas[rid]
        evacuated = replica.fail()
        replica.error = None             # handled; don't re-fail on tick
        m = _router_metrics()
        m["failures"].inc()
        m["alive"].set(len(self._alive()))
        if evacuated and not self._alive():
            raise RuntimeError(
                f"replica {rid} failed with {len(evacuated)} unfinished "
                "requests and no survivors to drain to")
        for req, handle in evacuated:
            self.submit(req, handle=handle)
            m["requeued"].inc()
        obs.event("router.replica_failed", rid=rid,
                  requeued=len(evacuated))
        return len(evacuated)

    # -- draining ------------------------------------------------------------
    def run(self):
        """Tick until every replica drains (sync-mode convenience)."""
        while not self.idle:
            self.tick()
