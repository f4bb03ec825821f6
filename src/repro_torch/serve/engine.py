"""Continuous-batching serving engine with chunked prefill, the port of
``repro.serve.engine``.

Architecture (DESIGN.md §9).  The engine is a slot scheduler over a
:class:`~repro_torch.serve.cache.StateCachePool`: requests move through

    QUEUED --admit--> PREFILL(chunk k/N) --commit--> DECODE --> FINISHED

``tick()`` is the scheduling quantum: it admits waiting requests into free
pool slots (``scheduler="fcfs"`` or ``"sjf"``), advances the one in-flight
prefill by at most one chunk, and runs one batched decode step for every
active slot, so a long prompt never stalls the decode batch by more than
one ``prefill_chunk`` of work.  Chunks run through ``lm_prefill_chunk``
(the boundary-seeded GSPN grid resume, or an attention chunk written
into the KV cache at its offset); prompts no longer than one chunk take
the one-shot ``lm_prefill`` inside the admission tick, and so do all
prompts of a model whose kinds have no chunked prefill (mamba, mlstm,
slstm: ``lm.supports_chunked_prefill``).  Every cache holds
``max_len`` positions a slot.  On the card every scan of both goes
through kernel #1; the decode step is plain PyTorch and launches no
scan.

Observability (DESIGN.md §13): per-request TTFT, queue delay and
inter-token latencies, a streaming ``stream(uid, token)`` callback, the
``serve_*`` counters and histograms in the ``repro_torch.obs`` registry,
and with tracing on the request lifecycle as spans (an async ``request``
span per uid around the ``serve.tick`` / ``serve.prefill`` /
``serve.prefill_chunk`` / ``serve.decode_step`` spans).

The serving tier (DESIGN.md §15): a shared ``prefix_cache``
(:class:`~repro_torch.serve.cache.PrefixStateCache`) lets a chunked
prefill resume from a cached chunk-aligned state instead of recomputing a
shared prompt prefix; ``submit(req, handle=...)``, ``pending_chunks``,
``drain()`` and the finish hook serve the router
(:mod:`repro_torch.serve.router`).  A prefix cache needs chunked prefill:
given to an engine that prefills in one shot it raises ``ValueError``.
An encoder-decoder model (``whisper-base``) raises ``ValueError`` at
construction: a request carries no audio frames, and the reference's
engine, which passes none, decodes it without cross-attention, a wrong
output that nothing reports.  ``submit`` returns a
:class:`RequestHandle`; the pre-handle ``on_finish`` callback survives as
a deprecated shim.

Streams.  On a card the engine runs every tick on a CUDA stream of its
own (``cuda_stream``, made in ``__init__``), so replicas
that share one card and one model overlap instead of queueing on one
stream; the chunk timer waits on that stream, never on the device.  The
constructor waits once for the device, so the weights and whatever else
the default stream made are finished before the engine's stream reads
them; a prefix entry made on another engine's stream is finished before
it is stored, and a resumed request marks its tensors as in use on this
stream (``record_stream``) so the allocator cannot hand their memory out
while this stream still reads it.

Sequence parallelism.  A ``ctx`` (``models.lm.Ctx``) carries the mesh that
a ``gspn_impl="sp"`` model shards its prefills' and chunks' scans over
(DESIGN.md §8); the decode step is O(W) and unsharded.  Every rank runs
the same engine over the same requests, so its collectives come in one
order on all of them.  Serving has no model axis, as in the reference: a
ctx with one, or a model sharded over one, raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import autotune
from repro_torch.models import lm as lm_mod
from repro_torch.serve.cache import StateCachePool, _leaves


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int
    max_new_tokens: int = 32


def _serve_metrics():
    """Engine metrics in the process-global registry (get-or-create per
    access, so a registry reset never strands the engine on dead
    objects)."""
    return {
        "ticks": obs.counter("serve_ticks_total", "scheduler quanta run"),
        "decode": obs.counter("serve_decode_steps_total",
                              "batched decode steps"),
        "chunks": obs.counter("serve_prefill_chunks_total",
                              "prefill chunks advanced"),
        "submitted": obs.counter("serve_requests_submitted_total",
                                 "requests accepted by submit()"),
        "finished": obs.counter("serve_requests_finished_total",
                                "requests retired (eos or length)"),
        "qdepth": obs.gauge("serve_queue_depth",
                            "admission-queue depth after the last admit"),
        "ttft": obs.histogram("serve_ttft_seconds",
                              help="submit -> first token"),
        "qdelay": obs.histogram("serve_queue_delay_seconds",
                                help="submit -> admission"),
        "itl": obs.histogram("serve_itl_seconds",
                             help="inter-token latency"),
        "qdepth_hist": obs.histogram("serve_queue_depth_ticks",
                                     buckets=obs.DEPTH_BUCKETS,
                                     help="queue depth sampled per tick"),
        "chunk_s": obs.histogram("serve_prefill_chunk_seconds",
                                 help="wall seconds per prefill chunk"),
    }


def sample_tokens(logits, generator: torch.Generator | None,
                  temperature: float, top_k: int):
    """The engine-wide logits -> token policy: greedy (``argmax``) when
    temperature <= 0, else temperature and optional top-k sampling from
    ``generator`` (on the logits' device).  logits (B, V) -> (B,) int64.
    One definition serves the batched decode step and the first token."""
    logits = logits.float()
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k:
        vals = logits.topk(top_k, dim=-1).values
        logits = torch.where(logits < vals[:, -1:], -1e30, logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def drive(engine, requests, arrivals, *, idle_sleep: float = 0.002):
    """Open-loop arrival driver: submit each request at its arrival time
    (seconds from the call), tick the engine in between, and return
    ``(elapsed_seconds, handles)`` once the engine drains, ``handles``
    parallel to ``requests``.  Arrivals never wait for completions, so
    queueing shows in the metrics instead of being hidden."""
    t0 = obs.monotonic()
    nxt = 0
    handles = []
    while nxt < len(requests) or not engine.idle:
        now = obs.monotonic() - t0
        while nxt < len(requests) and arrivals[nxt] <= now:
            handles.append(engine.submit(requests[nxt]))
            nxt += 1
        if engine.idle and nxt < len(requests):
            time.sleep(min(arrivals[nxt] - now, idle_sleep))
            continue
        engine.tick()
    return obs.monotonic() - t0, handles


@dataclasses.dataclass
class Result:
    uid: int
    tokens: list
    ttft: float = 0.0               # submit -> first token (s)
    queue_delay: float = 0.0        # submit -> admission (s)
    itl: list = dataclasses.field(default_factory=list)  # inter-token (s)
    prefill_chunks: int = 0         # 0 == one-shot prefill
    finish_reason: str = ""         # "eos" | "length"
    t_submit: float = 0.0           # obs.monotonic() at submit
    t_finish: float = 0.0           # obs.monotonic() at retirement
    cached_tokens: int = 0          # prompt tokens resumed from the
    #                                 prefix cache instead of recomputed


@dataclasses.dataclass
class RequestHandle:
    """What :meth:`ServeEngine.submit` returns: the caller's view of one
    request.  ``status`` moves queued → running → finished; ``result()``
    returns the finished :class:`Result` and raises before.  The routing
    tier re-submits a drained request under the handle the caller already
    holds, so a handle stays valid wherever the request lands;
    ``replica`` records its placement."""

    uid: int
    status: str = "queued"          # "queued" | "running" | "finished"
    replica: Optional[int] = None   # owning replica id (router tier)
    _result: Optional[Result] = dataclasses.field(default=None, repr=False)

    @property
    def done(self) -> bool:
        return self.status == "finished"

    def result(self) -> Result:
        if self._result is None:
            raise RuntimeError(f"request {self.uid} is {self.status}; "
                               "result() is only available once finished")
        return self._result

    def _finish(self, res: Result):
        self._result = res
        self.status = "finished"


def no_audio_message(name: str) -> str:
    return (f"{name} is an encoder-decoder model and the engine carries no "
            f"audio frames: its requests would decode without "
            f"cross-attention; use lm_encode, lm_prefill(enc_kv=) and "
            f"lm_decode_step(enc_kv=)")


# Warn-once latch for the deprecated ``on_finish`` callback.
_on_finish_warned = False


class ServeEngine:
    """Serve ``model`` (an :class:`~repro_torch.models.lm.LM`) on its own
    device with ``batch_size`` decode slots.  ``seed`` seeds the sampling
    generator; ``max_len`` bounds prompt plus generated tokens per
    request; ``prefill_chunk`` > 0 chunks prompts longer than it (snapped
    to the GSPN fold width); ``state_dtype`` narrows the pooled state at
    rest; ``prefix_cache`` is a shared
    :class:`~repro_torch.serve.cache.PrefixStateCache`; ``stream`` is the
    per-token callback (the engine's CUDA stream is ``cuda_stream``);
    ``ctx`` reaches the prefills and chunks."""

    def __init__(self, model, *, batch_size: int = 4, max_len: int = 512,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefill_chunk: int = 0, scheduler: str = "fcfs",
                 state_dtype=None,
                 stream: Optional[Callable[[int, int], None]] = None,
                 on_finish: Optional[Callable[[Result], None]] = None,
                 ctx=None, prefix_cache=None):
        if scheduler not in ("fcfs", "sjf"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if model.cfg.encoder_layers:
            raise ValueError(no_audio_message(model.cfg.name))
        if getattr(model, "model_axis", None) is not None or (
                ctx is not None and ctx.model_extent() > 1):
            raise NotImplementedError(
                "serving runs without a model axis, as the reference's "
                "does (its serve launcher builds a seq mesh only)")
        self.ctx = ctx
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = model.embed.device
        self.bs = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.scheduler = scheduler
        self.state_dtype = state_dtype
        self.stream = stream
        # The routing tier's finish hook (a Replica installs it), apart
        # from the deprecated user-facing ``on_finish``.
        self._finish_hook: Optional[Callable[[Result], None]] = None
        self._on_finish = None
        self.on_finish = on_finish       # property: warns once if not None
        self.prefix_cache = prefix_cache
        self._seed = seed
        if self.device.type == "cuda":
            self.cuda_stream = torch.cuda.Stream(self.device)
            # The weights (and all else the default stream made) are
            # finished before this engine's stream reads them.
            torch.cuda.synchronize(self.device)
        else:
            self.cuda_stream = None

        # Chunks snap to the GSPN fold width, so each starts on a grid-row
        # boundary (the gspn_seq_prefill_chunk contract); attention alone
        # chunks anywhere.
        if prefill_chunk > 0 and lm_mod.supports_chunked_prefill(cfg):
            align = lm_mod.prefill_chunk_alignment(cfg)
            self.prefill_chunk = max(align, (prefill_chunk // align) * align)
        else:
            self.prefill_chunk = 0
        if prefix_cache is not None and not self.prefill_chunk:
            # Prefix states are chunk boundaries: with no chunk there is
            # none to store, and the lookup's offsets would divide by 0.
            raise ValueError(
                f"a prefix cache needs chunked prefill, and {cfg.name} "
                + ("prefills in one shot (prefill_chunk=0)" if
                   lm_mod.supports_chunked_prefill(cfg) else
                   "has no chunked prefill (its recurrent mixers' prefill "
                   "starts from a zero state): it prefills in one shot"))

        self.reset()

    def _on_stream(self):
        """The engine's CUDA stream as the current stream (a no-op off the
        card): every tensor the engine makes is made there."""
        if self.cuda_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.cuda_stream)

    def _sync(self) -> None:
        """Wait for the engine's own stream (not the whole device, which
        would serialise the replicas that share it)."""
        if self.cuda_stream is not None:
            self.cuda_stream.synchronize()

    def reset(self):
        """Clear all scheduling state: a fresh pool, an empty queue, the
        sampling generator re-seeded."""
        bs = self.bs
        with self._on_stream():
            self.generator = torch.Generator(
                device=self.device).manual_seed(self._seed)
            self.pool = StateCachePool(self.cfg, bs, self.max_len,
                                       device=self.device,
                                       state_dtype=self.state_dtype)
            self.last_token = torch.zeros((bs, 1), dtype=torch.long,
                                          device=self.device)
        self.waiting: list = []              # [(Request, t_submit)]
        self._handles: dict = {}             # uid -> unfinished handle
        self._inflight = None                # chunked prefill in progress
        self.slot_req = [None] * bs
        self._slot_res: list = [None] * bs
        self._slot_t_last = [0.0] * bs
        self.active = np.zeros((bs,), bool)
        self.results: dict = {}
        self._m = {"ticks": 0, "decode_steps": 0, "prefill_chunks": 0,
                   "prefills": 0, "queue_depth_max": 0, "queue_depth_sum": 0,
                   "depth_samples": 0,
                   # bounded: a long-running server must not grow a list
                   # per request without limit
                   "admission_order": collections.deque(maxlen=1024)}

    @property
    def on_finish(self):
        """DEPRECATED result delivery: ``submit`` returns a
        :class:`RequestHandle`; read results through it.  Kept as a shim
        that warns once per process."""
        return self._on_finish

    @on_finish.setter
    def on_finish(self, fn):
        global _on_finish_warned
        if fn is not None and not _on_finish_warned:
            _on_finish_warned = True
            warnings.warn(
                "ServeEngine(on_finish=...) is deprecated; submit() "
                "returns a RequestHandle: read results through it",
                DeprecationWarning, stacklevel=3)
        self._on_finish = fn

    @property
    def metrics(self) -> dict:
        """This engine's counters (``prefills`` counts one-shot prefills),
        plus ``queue_depth_mean``; the same counts also feed the
        process-global ``serve_*`` metrics."""
        m = dict(self._m)
        m["queue_depth_mean"] = (m["queue_depth_sum"] / m["depth_samples"]
                                 if m["depth_samples"] else 0.0)
        return m

    # -- request management ------------------------------------------------
    def check_fits(self, req: Request):
        """Reject a request whose prompt and generated tokens exceed
        ``max_len`` at the door."""
        need = len(req.prompt) + max(req.max_new_tokens, 1) - 1
        if need > self.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) needs {need} positions, exceeding "
                f"max_len={self.max_len}")

    def submit(self, req: Request, *,
               handle: Optional[RequestHandle] = None) -> RequestHandle:
        """Queue a request; returns its :class:`RequestHandle`.  ``handle``
        re-submits a drained request under the handle its caller holds
        (the router's failure path)."""
        self.check_fits(req)
        if handle is None:
            handle = RequestHandle(uid=req.uid)
        handle.status = "queued"
        self._handles[req.uid] = handle
        self.waiting.append((req, obs.monotonic()))
        _serve_metrics()["submitted"].inc()
        obs.async_begin("request", req.uid, prompt_tokens=len(req.prompt),
                        max_new_tokens=req.max_new_tokens)
        obs.event("request.queued", uid=req.uid)
        return handle

    def _pop_next(self):
        if self.scheduler == "sjf":
            i = min(range(len(self.waiting)),
                    key=lambda i: len(self.waiting[i][0].prompt))
        else:
            i = 0
        return self.waiting.pop(i)

    def _sample_first(self, logits_row) -> int:
        """A request's first token, from its last prefill logits, under
        the same policy as decode."""
        return int(sample_tokens(logits_row[None], self.generator,
                                 self.temperature, self.top_k)[0])

    @property
    def idle(self) -> bool:
        """True when nothing is queued, prefilling, or decoding."""
        return (not self.waiting and self._inflight is None
                and not self.active.any())

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (the in-flight chunked prefill is
        already admitted and not counted)."""
        return len(self.waiting)

    @property
    def pending_chunks(self) -> int:
        """Prefill chunks of work ahead of a new arrival: the in-flight
        request's remaining chunks and an estimate for every waiting
        prompt.  The TTFT-predictive router policy multiplies this by the
        measured per-chunk latency (DESIGN.md §15)."""
        n = 0
        if self._inflight is not None:
            st = self._inflight
            n += -(-(len(st["toks"]) - st["off"]) // self.prefill_chunk)
        if self.prefill_chunk:
            for req, _t in self.waiting:
                n += max(-(-len(req.prompt) // self.prefill_chunk), 1)
        else:
            n += len(self.waiting)
        return n

    def drain(self) -> list:
        """Evacuate every unfinished request (the replica-failure path):
        ``[(Request, RequestHandle), ...]``, the admitted requests first,
        then the in-flight prefill, then the waiting queue, each handle
        reset to ``queued`` so the router can re-submit it to a survivor
        under the same handle.  Decode progress is discarded (restart
        semantics); the scheduling state is reset."""
        reqs = [self.slot_req[s] for s in range(self.bs) if self.active[s]]
        if self._inflight is not None:
            reqs.append(self._inflight["req"])
        reqs.extend(r for r, _t in self.waiting)
        out = []
        for req in reqs:
            h = self._handles.pop(req.uid, None)
            if h is None:
                h = RequestHandle(uid=req.uid)
            h.status = "queued"
            h._result = None
            obs.async_end("request", req.uid, finish_reason="evacuated")
            out.append((req, h))
        self._sync()
        self.reset()
        return out

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks), dtype=torch.long,
                               device=self.device)[None]

    # -- prefill -----------------------------------------------------------
    def _admit(self):
        while self.waiting:
            if self._inflight is not None:
                break                        # one chunked prefill at a time
            slot = self.pool.alloc()
            if slot is None:
                break                        # backpressure: batch is full
            req, t_submit = self._pop_next()
            t_admit = obs.monotonic()
            self._m["admission_order"].append(req.uid)
            obs.event("request.admitted", uid=req.uid, slot=slot)
            if self.prefill_chunk and len(req.prompt) > self.prefill_chunk:
                toks = np.asarray(req.prompt)
                # The prefix probe (DESIGN.md §15): a hit is the whole
                # batch-1 cache at a chunk-aligned offset, resumed through
                # the same lm_prefill_chunk a cold chain runs.
                off, cache = 0, None
                if self.prefix_cache is not None:
                    hit = self.prefix_cache.lookup(toks, self.prefill_chunk)
                    if hit is not None:
                        off, cache = hit
                        if self.cuda_stream is not None:
                            for leaf in _leaves(cache):
                                leaf.record_stream(self.cuda_stream)
                        obs.event("request.prefix_hit", uid=req.uid,
                                  cached_tokens=off)
                if cache is None:
                    # A fresh zeroed batch-1 cache per admission: a stale
                    # prev_row would corrupt the seeded scan, and a stale
                    # K/V page would outlive its request.
                    cache = lm_mod.init_lm_cache(self.cfg, 1, self.max_len,
                                                 device=self.device)
                self._inflight = {
                    "req": req, "slot": slot, "off": off, "chunks": 0,
                    "cached": off, "toks": toks, "cache": cache,
                    "t_submit": t_submit, "t_admit": t_admit,
                }
            else:
                with torch.no_grad(), obs.trace(
                        "serve.prefill", uid=req.uid,
                        prompt_tokens=len(req.prompt)):
                    logits, new_caches = lm_mod.lm_prefill(
                        self.model, self._tokens(req.prompt), self.max_len,
                        ctx=self.ctx)
                    first = self._sample_first(logits[0, -1])
                    self.pool.commit(slot, new_caches)
                self._m["prefills"] += 1
                self._activate(req, slot, first, t_submit, t_admit, 0)

    def _advance_prefill(self):
        """Run at most one prompt chunk of the in-flight prefill."""
        st = self._inflight
        if st is None:
            return
        off = st["off"]
        end = min(off + self.prefill_chunk, len(st["toks"]))
        last = end == len(st["toks"])
        t0 = obs.monotonic()
        with torch.no_grad(), obs.trace(
                "serve.prefill_chunk", uid=st["req"].uid,
                index=st["chunks"], offset=off, tokens=end - off):
            # Only the last chunk's logits feed sampling; the others skip
            # the vocabulary head.
            logits, st["cache"] = lm_mod.lm_prefill_chunk(
                self.model, self._tokens(st["toks"][off:end]), st["cache"],
                off, ctx=self.ctx, with_logits=last)
            # Wait for the engine's stream, so the chunk histogram (the
            # TTFT predictor's cost model) measures the chunk's device
            # time rather than its dispatch, and a prefix entry is
            # finished before another engine's stream can read it.
            self._sync()
        _serve_metrics()["chunk_s"].observe(obs.monotonic() - t0)
        st["off"] = end
        st["chunks"] += 1
        self._m["prefill_chunks"] += 1
        _serve_metrics()["chunks"].inc()
        if (self.prefix_cache is not None
                and end % self.prefill_chunk == 0 and end > st["cached"]):
            # Every freshly computed chunk boundary is a reusable prefix
            # state: chunks are snapped to the fold width, so ``end`` sits
            # on a grid-row boundary (the resumable-state contract).
            self.prefix_cache.insert(st["toks"][:end], st["cache"])
        if last:
            first = self._sample_first(logits[0, -1])
            self.pool.commit(st["slot"], st["cache"])
            self._activate(st["req"], st["slot"], first, st["t_submit"],
                           st["t_admit"], st["chunks"], cached=st["cached"])
            self._inflight = None

    def _activate(self, req, slot, first, t_submit, t_admit, chunks,
                  cached: int = 0):
        now = obs.monotonic()
        res = Result(uid=req.uid, tokens=[first], ttft=now - t_submit,
                     queue_delay=t_admit - t_submit, prefill_chunks=chunks,
                     t_submit=t_submit, cached_tokens=cached)
        h = self._handles.get(req.uid)
        if h is not None:
            h.status = "running"
        sm = _serve_metrics()
        sm["ttft"].observe(res.ttft)
        sm["qdelay"].observe(res.queue_delay)
        obs.event("request.first_token", uid=req.uid,
                  ttft_ms=round(res.ttft * 1e3, 3))
        self.slot_req[slot] = req
        self._slot_res[slot] = res
        self._slot_t_last[slot] = now
        self.last_token[slot, 0] = first
        self.active[slot] = True
        if self.stream:
            self.stream(req.uid, first)
        if self.eos_id is not None and first == self.eos_id:
            self._retire(slot, "eos")
        elif req.max_new_tokens <= 1:
            self._retire(slot, "length")

    # -- decode / retirement -----------------------------------------------
    def _retire(self, slot, reason: str):
        res = self._slot_res[slot]
        res.finish_reason = reason
        res.t_finish = obs.monotonic()
        _serve_metrics()["finished"].inc()
        obs.async_end("request", res.uid, finish_reason=reason,
                      tokens=len(res.tokens))
        h = self._handles.pop(res.uid, None)
        if h is not None:
            h._finish(res)
        if self._finish_hook is not None:
            # The routing tier observes the finish; the handle carries the
            # result, so nothing is kept here.
            self._finish_hook(res)
        elif self.on_finish is not None:
            self.on_finish(res)       # the deprecated callback
        else:
            self.results[res.uid] = res
        self.slot_req[slot] = None
        self._slot_res[slot] = None
        self.active[slot] = False
        self.pool.free(slot)

    def _decode_step(self):
        """One decode step for the whole batch, free slots included, as in
        the reference: a free slot decodes its stale ``last_token`` on its
        stale cache and its token is never read.  Its row still changes
        what the active slots compute under an attn_moe block, whose
        expert capacity counts every row of the call (at kimi's widths and
        4 slots, one place an expert): a stale token can take an expert's
        place and drop an active slot's choice.  So the free slots' tokens
        and caches follow the reference's exactly."""
        sm = _serve_metrics()
        with torch.no_grad(), obs.trace(
                "serve.decode_step", batch=int(self.active.sum())) as sp:
            logits, new_caches = lm_mod.lm_decode_step(
                self.model, self.last_token, self.pool.caches)
            self.pool.update(new_caches)
            nxt = sample_tokens(logits[:, 0], self.generator,
                                self.temperature, self.top_k)
            self._m["decode_steps"] += 1
            sm["decode"].inc()
            nxt_host = nxt.cpu().numpy()
            if obs.enabled():
                # the launch shapes the tuner resolved so far
                sp.set(plan=autotune.plans_summary())
            self.last_token = nxt[:, None]
            now = obs.monotonic()
            for slot in range(self.bs):
                if not self.active[slot]:
                    continue
                tok = int(nxt_host[slot])
                res = self._slot_res[slot]
                res.tokens.append(tok)
                res.itl.append(now - self._slot_t_last[slot])
                sm["itl"].observe(now - self._slot_t_last[slot])
                self._slot_t_last[slot] = now
                if self.stream:
                    self.stream(res.uid, tok)
                req = self.slot_req[slot]
                if self.eos_id is not None and tok == self.eos_id:
                    self._retire(slot, "eos")
                elif len(res.tokens) >= req.max_new_tokens:
                    self._retire(slot, "length")

    # -- main loop ---------------------------------------------------------
    def tick(self):
        """One scheduling quantum: admit, one prefill chunk, one decode
        step.  Drivers interleave ``submit``/``tick`` to model arrivals."""
        with self._on_stream(), obs.trace("serve.tick"):
            sm = _serve_metrics()
            self._m["ticks"] += 1
            sm["ticks"].inc()
            self._admit()
            # Depth is sampled after admission: what remains waiting is
            # true backpressure.
            depth = self.queue_depth
            self._m["queue_depth_max"] = max(self._m["queue_depth_max"],
                                             depth)
            self._m["queue_depth_sum"] += depth
            self._m["depth_samples"] += 1
            sm["qdepth"].set(depth)
            sm["qdepth_hist"].observe(depth)
            self._advance_prefill()
            if self.active.any():
                self._decode_step()

    def run(self):
        """Run until every submitted request completes; returns the
        results by uid."""
        while not self.idle:
            self.tick()
        return self.results
