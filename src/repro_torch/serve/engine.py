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
the one-shot ``lm_prefill`` inside the admission tick.  Every cache holds
``max_len`` positions a slot.  On the card every scan of both goes
through kernel #1; the decode step is plain PyTorch and launches no
scan.

Observability (DESIGN.md §13): per-request TTFT, queue delay and
inter-token latencies, a streaming ``stream(uid, token)`` callback, the
``serve_*`` counters and histograms in the ``repro_torch.obs`` registry,
and with tracing on the request lifecycle as spans (an async ``request``
span per uid around the ``serve.tick`` / ``serve.prefill`` /
``serve.prefill_chunk`` / ``serve.decode_step`` spans).

Not ported yet (ROADMAP.md §1 item 4): the shared prefix-state cache, the
replica/router tier (``drain``, ``pending_chunks``, the finish hook) and a
device mesh; ``prefix_cache`` and a ``ctx`` raise.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import lm as lm_mod
from repro_torch.serve.cache import StateCachePool


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


@dataclasses.dataclass
class RequestHandle:
    """What :meth:`ServeEngine.submit` returns: the caller's view of one
    request.  ``status`` moves queued → running → finished; ``result()``
    returns the finished :class:`Result` and raises before."""

    uid: int
    status: str = "queued"          # "queued" | "running" | "finished"
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Serve ``model`` (an :class:`~repro_torch.models.lm.LM`) on its own
    device with ``batch_size`` decode slots.  ``seed`` seeds the sampling
    generator; ``max_len`` bounds prompt plus generated tokens per
    request; ``prefill_chunk`` > 0 chunks prompts longer than it (snapped
    to the GSPN fold width); ``state_dtype`` narrows the pooled state at
    rest."""

    def __init__(self, model, *, batch_size: int = 4, max_len: int = 512,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefill_chunk: int = 0, scheduler: str = "fcfs",
                 state_dtype=None,
                 stream: Optional[Callable[[int, int], None]] = None,
                 ctx=None, prefix_cache=None):
        if scheduler not in ("fcfs", "sjf"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if prefix_cache is not None:
            raise NotImplementedError(
                "the prefix-state cache is not in the port yet; ROADMAP.md "
                "§1 item 4.1 brings it")
        if ctx is not None:
            raise NotImplementedError(
                "the engine runs on one device; a ctx (device mesh) comes "
                "with ROADMAP.md §1 item 6")
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
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # Chunks snap to the GSPN fold width, so each starts on a grid-row
        # boundary (the gspn_seq_prefill_chunk contract); attention alone
        # chunks anywhere.
        if prefill_chunk > 0 and lm_mod.supports_chunked_prefill(cfg):
            align = lm_mod.prefill_chunk_alignment(cfg)
            self.prefill_chunk = max(align, (prefill_chunk // align) * align)
        else:
            self.prefill_chunk = 0

        self.pool = StateCachePool(cfg, batch_size, max_len,
                                   device=self.device,
                                   state_dtype=state_dtype)
        self.waiting: list = []              # [(Request, t_submit)]
        self._handles: dict = {}             # uid -> unfinished handle
        self._inflight = None                # chunked prefill in progress
        self.slot_req = [None] * batch_size
        self._slot_res: list = [None] * batch_size
        self._slot_t_last = [0.0] * batch_size
        self.last_token = torch.zeros((batch_size, 1), dtype=torch.long,
                                      device=self.device)
        self.active = np.zeros((batch_size,), bool)
        self.results: dict = {}
        self._m = {"ticks": 0, "decode_steps": 0, "prefill_chunks": 0,
                   "prefills": 0, "queue_depth_max": 0, "queue_depth_sum": 0,
                   "depth_samples": 0,
                   # bounded: a long-running server must not grow a list
                   # per request without limit
                   "admission_order": collections.deque(maxlen=1024)}

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

    def submit(self, req: Request) -> RequestHandle:
        """Queue a request; returns its :class:`RequestHandle`."""
        self.check_fits(req)
        handle = RequestHandle(uid=req.uid)
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
                # A fresh zeroed batch-1 cache per admission: a stale
                # prev_row would corrupt the seeded scan, and a stale K/V
                # page would outlive its request.
                self._inflight = {
                    "req": req, "slot": slot, "off": 0, "chunks": 0,
                    "toks": np.asarray(req.prompt),
                    "cache": lm_mod.init_lm_cache(self.cfg, 1, self.max_len,
                                                  device=self.device),
                    "t_submit": t_submit, "t_admit": t_admit,
                }
            else:
                with torch.no_grad(), obs.trace(
                        "serve.prefill", uid=req.uid,
                        prompt_tokens=len(req.prompt)):
                    logits, new_caches = lm_mod.lm_prefill(
                        self.model, self._tokens(req.prompt), self.max_len)
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
                off, with_logits=last)
            # Wait for the card, so the chunk histogram measures the
            # chunk's device time rather than its dispatch.
            _sync(self.device)
        _serve_metrics()["chunk_s"].observe(obs.monotonic() - t0)
        st["off"] = end
        st["chunks"] += 1
        self._m["prefill_chunks"] += 1
        _serve_metrics()["chunks"].inc()
        if last:
            first = self._sample_first(logits[0, -1])
            self.pool.commit(st["slot"], st["cache"])
            self._activate(st["req"], st["slot"], first, st["t_submit"],
                           st["t_admit"], st["chunks"])
            self._inflight = None

    def _activate(self, req, slot, first, t_submit, t_admit, chunks):
        now = obs.monotonic()
        res = Result(uid=req.uid, tokens=[first], ttft=now - t_submit,
                     queue_delay=t_admit - t_submit, prefill_chunks=chunks,
                     t_submit=t_submit)
        self._handles[req.uid].status = "running"
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
        self._handles.pop(res.uid)._finish(res)
        self.results[res.uid] = res
        self.slot_req[slot] = None
        self._slot_res[slot] = None
        self.active[slot] = False
        self.pool.free(slot)

    def _decode_step(self):
        """One decode step for the whole batch (free slots included: their
        rows compute on stale state and are never read)."""
        sm = _serve_metrics()
        with torch.no_grad(), obs.trace(
                "serve.decode_step", batch=int(self.active.sum())):
            logits, new_caches = lm_mod.lm_decode_step(
                self.model, self.last_token, self.pool.caches)
            self.pool.update(new_caches)
            nxt = sample_tokens(logits[:, 0], self.generator,
                                self.temperature, self.top_k)
            self._m["decode_steps"] += 1
            sm["decode"].inc()
            nxt_host = nxt.cpu().numpy()
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
        with obs.trace("serve.tick"):
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
