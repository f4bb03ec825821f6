"""Empirical launch-shape tuner with a persistent cache (DESIGN.md §11),
the port of ``repro.kernels.autotune`` retargeted to the Hopper kernels.

The reference tunes a Pallas row tile and pipeline depth against a VMEM
budget.  The port's kernels (``csrc/gspn_pair.cu``) have launch shapes
instead (:class:`~repro_torch.kernels.gspn_scan.PairLaunch`): planes per
CTA, warps, the CTAs a weight group splits over, the shared-memory ring's
batches, and for the single adjoint at wide rows its bands or direct
windows.  :mod:`~repro_torch.kernels.tuning` says which shapes a kernel
can run; this module enumerates them, times them on the card, and keeps
the winner in a JSON cache keyed by everything that changes the optimum::

    device | g | h | w | cpw | spec.canonical()

(schema 3: the device from ``torch.cuda.get_device_name()``, lower case
with dashes, or ``cpu``; the shape legs; then the spec's canonical
serialization, :func:`~repro_torch.kernels.spec.canonical_key`).

Resolution order at every launch (:func:`plan_for_spec`, called by
``gspn_scan.launch`` and ``launch_bwd``):

1. an explicit launch shape always wins;
2. a cache hit, checked against the shape first: the global cache is the
   seed file measured on the H100 (``tune_cache_h100.json`` beside this
   module), overlaid by the file ``GSPN_TUNE_CACHE`` names and by the
   launchers' ``--tune-cache`` (:func:`load_cache`).  An entry that is
   present but cannot run at its key counts ``autotune_cache_rejects_total``,
   emits ``autotune.cache_reject`` with its reason, and falls through;
3. the static heuristic ``gspn_scan.pair_launch_shape``: a cache miss
   gives exactly the shape the port launched before the tuner.

A resolution through the global cache is remembered per (device, shape,
spec) until that cache changes, so a launch costs one dict lookup; the
first resolution of each key emits ``kernel.plan``.

Measurement (:func:`autotune_key`): every candidate of
:func:`enumerate_candidates` is first held against the kernel's plain
version on the same operands (1e-5 of the largest magnitude, 1e-2 for a
bfloat16 forward's output) and then timed as CUDA-graph replays of 10
launches, 20 replays timed by CUDA events (:func:`measure`).  A shape
other than the heuristic's is stored only where it beats the
heuristic's median by more than the spread (p90 − p10) of its own
replays, in the sweep and again in each of ``CONFIRM`` alternating
rounds of the two; otherwise the heuristic's shape is stored, so a
committed cache cannot slow a path.

CLI (card only)::

    PYTHONPATH=src python -m repro_torch.kernels.autotune warm --out tune.json
    PYTHONPATH=src python -m repro_torch.kernels.autotune show
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import statistics
import sys
import threading

import torch

from repro_torch import obs
from repro_torch.kernels import gspn_multidir as mk
from repro_torch.kernels import gspn_scan as gs
from repro_torch.kernels import tuning
from repro_torch.kernels.spec import BOUNDARIES, ScanSpec, canonical_key

ENV_CACHE_PATH = "GSPN_TUNE_CACHE"
SEED_CACHE_PATH = pathlib.Path(__file__).with_name("tune_cache_h100.json")
SCHEMA_VERSION = 3

# Each direction's kernel: the template (forward or adjoint) and its D.
GEOMETRY = {d: kind_ndir for kind_ndir, d in gs.DIRECTION.items()}

# Graph replays per timing, and launches per graph; alternating rounds
# that confirm a winner other than the heuristic.
REPLAYS, PER_GRAPH = 20, 10
CONFIRM = 3

_LOCK = threading.Lock()
# Every (key -> plan) resolution this process has made, bounded; the
# serving engine annotates its decode-step spans with them (DESIGN.md §13).
_RESOLVED_CAP = 256
_RESOLVED: dict[str, tuple] = {}
# Global-cache resolutions by (device, g, h, w, cpw, dtype, direction,
# boundary), dropped whenever the global cache changes.
_MEMO: dict[tuple, object] = {}


@functools.lru_cache(maxsize=16)
def _device_name(index: int) -> str:
    return torch.cuda.get_device_name(index).lower().replace(" ", "-")


def device_kind(device=None) -> str:
    """The cache key's device: the CUDA card's name, lower case with
    dashes (``nvidia-h100-80gb-hbm3``), or ``cpu``."""
    if device is None:
        return "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _device_name(index)


@dataclasses.dataclass(frozen=True)
class ScanKey:
    """Everything that changes the best launch shape of one scan launch."""
    device: str
    g: int                       # planes (G)
    h: int                       # rows of the walk
    w: int                       # columns
    cpw: int                     # planes per weight group
    direction: str               # fwd | bwd | pair_fwd | pair_bwd | quad
    dtype: str = "float32"       # streamed operands
    impl: str = "cuda"
    carry_dtype: str = "float32"
    boundary: str = "one_shot"   # one_shot | chunk_resume | sp_block_local

    def __post_init__(self):
        if self.direction not in GEOMETRY:
            raise ValueError(f"unknown direction {self.direction!r}; "
                             f"expected one of {tuple(GEOMETRY)}")
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"unknown boundary {self.boundary!r}; "
                             f"expected one of {BOUNDARIES}")

    @classmethod
    def from_spec(cls, spec: ScanSpec, g: int, h: int, w: int,
                  device: str) -> "ScanKey":
        return cls(device, g, h, w, spec.channels_per_weight, spec.direction,
                   spec.stream_dtype, "cuda", spec.carry_dtype, spec.boundary)

    @classmethod
    def decode(cls, enc: str) -> "ScanKey":
        """The key :meth:`encode` wrote; raises ValueError on another
        string."""
        try:
            dev, g, h, w, cpw, d, impl, dt, carry, cs, bnd = enc.split("|")
            key = cls(dev, int(g.removeprefix("g")), int(h.removeprefix("h")),
                      int(w.removeprefix("w")), int(cpw.removeprefix("cpw")),
                      d, dt, impl, carry.removeprefix("carry-"),
                      bnd.removeprefix("bnd-"))
        except (TypeError, ValueError) as exc:
            raise ValueError(f"not a schema-3 key: {enc!r}") from exc
        if key.encode() != enc:
            raise ValueError(f"not a schema-3 key: {enc!r}")
        return key

    def encode(self) -> str:
        """The schema-3 key: device and shape legs, then the spec's
        canonical serialization."""
        return (f"{self.device}|g{self.g}|h{self.h}|w{self.w}|cpw{self.cpw}|"
                + canonical_key(self.direction, self.impl, self.dtype,
                                self.carry_dtype, self.cpw > 1,
                                self.boundary))

    @property
    def kind(self) -> str:
        return GEOMETRY[self.direction][0]

    @property
    def ndir(self) -> int:
        return GEOMETRY[self.direction][1]

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """The free fields of a launch shape; :meth:`shape` derives the rest
    (``tuning.launch_shape``)."""
    planes: int
    warps: int
    splits: int
    batch: int
    nbuf: int
    bands: int = 1
    direct: bool = False
    window_k: int = 0

    @classmethod
    def of(cls, s) -> "Candidate":
        """The candidate of a PairLaunch."""
        return cls(s.planes, s.warps, s.splits, s.batch, s.nbuf, s.bands,
                   bool(s.direct), s.k if s.direct else 0)

    @classmethod
    def from_entry(cls, entry: dict) -> "Candidate":
        """The candidate a cache entry names; raises on a malformed one."""
        ints = {f: entry[f] for f in ("planes", "warps", "splits", "batch",
                                      "nbuf", "bands", "window_k")}
        for f, v in ints.items():
            if not isinstance(v, int) or isinstance(v, bool):
                raise ValueError(f"{f}={v!r} is not an integer")
        if not isinstance(entry["direct"], bool):
            raise ValueError(f"direct={entry['direct']!r} is not a bool")
        return cls(direct=entry["direct"], **ints)

    def shape(self, key: ScanKey):
        return tuning.launch_shape(
            key.g, key.h, key.w, key.cpw, key.torch_dtype, key.kind,
            key.ndir, planes=self.planes, warps=self.warps,
            splits=self.splits, batch=self.batch, nbuf=self.nbuf,
            bands=self.bands, direct=self.direct, window_k=self.window_k)

    def label(self) -> str:
        lay = (f"-win{self.window_k}x{self.bands}" if self.direct
               else f"-bands{self.bands}" if self.bands > 1 else "")
        return (f"p{self.planes}w{self.warps}s{self.splits}"
                f"b{self.batch}x{self.nbuf}{lay}")


def heuristic(key: ScanKey):
    """``pair_launch_shape``'s shape for ``key``: the static fallback."""
    return gs.pair_launch_shape(key.g, key.h, key.w, key.cpw,
                                key.torch_dtype, key.kind, key.ndir)


def admit(key: ScanKey, s) -> str | None:
    """``tuning.admit`` at ``key``: None, or why ``s`` cannot run."""
    return tuning.admit(key.g, key.h, key.w, key.cpw, key.torch_dtype,
                        key.kind, key.ndir, s)


def _ring_options(h: int) -> list[tuple[int, int]]:
    """(batch, nbuf): the whole plane in one batch, and rings of 64, 32 or
    16 rows (or the plane) cut into 2, 4 or 8 batches."""
    opts = [(h, 1)]
    for rows in sorted({min(h, r) for r in (64, 32, 16)}, reverse=True):
        for nb in (2, 4, 8):
            batch = -(-rows // nb)
            nbuf = rows // batch
            if nbuf > 1 and batch < h:
                opts.append((batch, nbuf))
    return list(dict.fromkeys(opts))


def enumerate_candidates(key: ScanKey) -> list[Candidate]:
    """Every shape the tuner may time, and so emit, for ``key``, each one
    admitted by ``tuning``: for every split of the weight group into CTAs
    (planes per CTA, the last CTA taking the rest), warps of one per plane
    (and band) or at least the heuristic's eight copy-issuing warps, the
    rings of :func:`_ring_options`, and for the single adjoint at rows of
    more than 128 columns its bands (2 to 32 warps a row) and its direct
    windows (32, 64 or 128 columns; 1, 2, 4, 8 or 16 windows a CTA).
    The heuristic's shape comes first, and always."""
    k0 = 1 << max(0, -(-key.w // 32) - 1).bit_length()
    single_bwd = key.kind == "bwd" and key.ndir == 1
    layouts = [(1, False, 0)]
    if single_bwd and k0 >= 8:
        layouts += [(b, False, 0) for b in (2, 4, 8, 16, 32)
                    if 1 <= k0 // b <= 4]
        for wk in (1, 2, 4):
            tile = 32 * wk - 2 * key.h
            if tile >= 1:
                windows = -(-key.w // tile)
                layouts += [(b, True, wk) for b in (1, 2, 4, 8, 16)
                            if b <= windows]
    splits = sorted({-(-key.cpw // p) for p in range(1, key.cpw + 1)})
    out = [Candidate.of(heuristic(key))]
    for bands, direct, wk in layouts:
        k = wk if direct else k0 // bands
        maxw = gs._MAX_WARPS.get(k, 0)
        rings = [(key.h, 1)] if direct else _ring_options(key.h)
        for s in splits:
            p = -(-key.cpw // s)
            warps = {p * bands} if direct else \
                {p * bands, max(p * bands, min(gs.COPY_WARPS, maxw))}
            for nw in sorted(warps):
                for batch, nbuf in rings:
                    cand = Candidate(p, nw, s, batch, nbuf, bands, direct,
                                     wk)
                    try:
                        ok = admit(key, cand.shape(key)) is None
                    except ValueError:
                        ok = False
                    if ok:
                        out.append(cand)
    return list(dict.fromkeys(out))


# ---------------------------------------------------------------------------
# Persistent cache.
# ---------------------------------------------------------------------------

class TuningCache:
    """JSON-backed ``key.encode() -> entry`` map, schema 3.  An entry is a
    plain dict: a :class:`Candidate`'s fields, ``us``, ``heuristic_us``,
    ``spread_us`` and ``source`` ("measured" or "heuristic").  ``meta``
    holds the file's other top-level fields (the card's name and power
    limit).  A corrupt or missing file loads as an empty cache: the tuner
    must never take the serving path down."""

    def __init__(self, entries: dict | None = None, path=None,
                 meta: dict | None = None):
        self.entries: dict[str, dict] = dict(entries or {})
        self.path = pathlib.Path(path) if path else None
        self.meta = dict(meta or {})

    @classmethod
    def load(cls, path) -> "TuningCache":
        path = pathlib.Path(path)
        try:
            payload = json.loads(path.read_text())
            entries = payload.get("entries", {})
            if not isinstance(entries, dict):
                raise ValueError("entries is not a mapping")
        except (OSError, ValueError, AttributeError) as exc:
            print(f"[autotune] ignoring unreadable cache {path}: {exc!r}",
                  file=sys.stderr)
            payload, entries = {}, {}
        meta = {k: v for k, v in payload.items()
                if k not in ("schema", "entries")}
        return cls(entries, path=path, meta=meta)

    def save(self, path=None) -> pathlib.Path:
        path = pathlib.Path(path) if path else self.path
        if path is None:
            raise ValueError("no cache path to save to")
        payload = {"schema": SCHEMA_VERSION, **self.meta,
                   "entries": self.entries}
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
        self.path = path
        return path

    def lookup(self, key: ScanKey) -> dict | None:
        return self.entries.get(key.encode())

    def store(self, key: ScanKey, entry: dict):
        self.entries[key.encode()] = dict(entry)

    def merge(self, other: "TuningCache"):
        self.entries.update(other.entries)

    def __len__(self):
        return len(self.entries)


_CACHE: TuningCache | None = None


def _changed():
    with _LOCK:
        _MEMO.clear()


def get_cache(reload: bool = False) -> TuningCache:
    """The process-global cache: the committed seed file, overlaid
    (entries win) by the file ``GSPN_TUNE_CACHE`` names."""
    global _CACHE
    if _CACHE is None or reload:
        cache = (TuningCache.load(SEED_CACHE_PATH)
                 if SEED_CACHE_PATH.exists() else TuningCache())
        env = os.environ.get(ENV_CACHE_PATH)
        if env:
            cache.merge(TuningCache.load(env))
            cache.path = pathlib.Path(env)
        _CACHE = cache
        _changed()
    return _CACHE


def load_cache(path) -> int:
    """Layer a cache file over the global cache (the launchers'
    ``--tune-cache``).  Returns the number of entries loaded."""
    extra = TuningCache.load(path)
    cache = get_cache()
    cache.merge(extra)
    cache.path = extra.path
    _changed()
    return len(extra)


def entry_invalid_reason(key: ScanKey, entry) -> str | None:
    """Why a cache entry cannot be honoured at ``key``, or None: its fields
    must name a shape that ``tuning`` admits at the key's operands."""
    if not isinstance(entry, dict):
        return f"entry {entry!r} is not a mapping"
    try:
        cand = Candidate.from_entry(entry)
        s = cand.shape(key)
    except (KeyError, TypeError, ValueError) as exc:
        return f"malformed entry: {exc!r}"
    return admit(key, s)


def _record_plan(key: ScanKey, s, source: str):
    enc = key.encode()
    with _LOCK:
        if enc not in _RESOLVED and len(_RESOLVED) >= _RESOLVED_CAP:
            return
        prev = _RESOLVED.get(enc)
        _RESOLVED[enc] = (Candidate.of(s), source)
    if prev is None:
        obs.event("kernel.plan", key=enc, plan=Candidate.of(s).label(),
                  source=source)


def resolved_plans() -> dict:
    """``key.encode() -> (Candidate, source)`` for every resolution so
    far."""
    with _LOCK:
        return dict(_RESOLVED)


def plans_summary() -> str:
    """One line: ``g|h|w|cpw|direction:plan`` per resolved key (the
    decode-step span annotation)."""
    parts = []
    for enc, (cand, _src) in sorted(resolved_plans().items()):
        seg = enc.split("|")
        parts.append(f"{'|'.join(seg[1:6])}:{cand.label()}")
    return " ".join(parts)


def _resolve(key: ScanKey, cache: TuningCache):
    entry = cache.lookup(key)
    if entry is not None:
        reason = entry_invalid_reason(key, entry)
        if reason is None:
            return Candidate.from_entry(entry).shape(key), "cache"
        obs.counter("autotune_cache_rejects_total",
                    "tuning-cache entries refused at their key").inc()
        obs.event("autotune.cache_reject", key=key.encode(), reason=reason)
    return heuristic(key), "heuristic"


def plan_for_spec(spec: ScanSpec, g: int, h: int, w: int, *,
                  device: str = "cpu", cache: TuningCache | None = None,
                  launch=None):
    """THE launch-site planning entry point: the launch shape (a
    PairLaunch) of the scan ``spec`` describes on (g, h, w) planes on
    ``device`` (a :func:`device_kind` string).  ``launch``, an explicit
    shape, always wins; then a valid entry of ``cache`` (the global cache
    by default); then ``pair_launch_shape``."""
    key = ScanKey.from_spec(spec, g, h, w, device)
    if launch is not None:
        _record_plan(key, launch, "explicit")
        return launch
    if cache is not None:
        s, source = _resolve(key, cache)
        _record_plan(key, s, source)
        return s
    memo = (device, g, h, w, spec.channels_per_weight, spec.stream_dtype,
            spec.direction, spec.boundary)
    s = _MEMO.get(memo)
    if s is None:
        s, source = _resolve(key, get_cache())
        _record_plan(key, s, source)
        with _LOCK:
            _MEMO[memo] = s
    return s


# ---------------------------------------------------------------------------
# Measurement (card only).
# ---------------------------------------------------------------------------

def measure(fn, *, per_graph: int = PER_GRAPH, replays: int = REPLAYS):
    """(median µs, spread µs) of one launch of ``fn``: ``per_graph`` calls
    captured in a CUDA graph after three warm-up calls on a side stream,
    ``replays`` replays each timed by CUDA events and divided by
    ``per_graph``; the spread is p90 − p10 of those replays."""
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
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / per_graph)
    del graph
    times.sort()
    q = statistics.quantiles(times, n=10)
    return statistics.median(times), q[-1] - q[0]


def operands(key: ScanKey, *, device="cuda", seed: int = 0):
    """Seeded operands of ``key``'s kernel: (x, wl, wc, wr, lam) for a
    forward, (dy, wl, wc, wr) for an adjoint; taps a softmax over three,
    lam in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lead = () if key.ndir == 1 else (key.ndir,)
    shape = (key.g, key.h, key.w)
    taps = torch.softmax(torch.randn(lead + (key.g // key.cpw, key.h, key.w,
                                             3), generator=gen,
                                     device=device), dim=-1)
    taps = [taps[..., i] for i in range(3)]
    if key.kind == "bwd":
        ops = [torch.randn(lead + shape, generator=gen, device=device),
               *taps]
    else:
        ops = [torch.randn(shape, generator=gen, device=device), *taps,
               torch.rand(lead + shape, generator=gen, device=device)]
    return tuple(t.to(key.torch_dtype).contiguous() for t in ops)


def tolerance(key: ScanKey) -> float:
    """Agreement with the plain version, relative to its largest
    magnitude: 1e-5, or 1e-2 for a bfloat16 forward's output."""
    return 1e-2 if key.kind == "fwd" and key.dtype == "bfloat16" else 1e-5


def kernel_runner(key: ScanKey, args):
    """``run(s)``: one launch of ``key``'s kernel at launch shape ``s`` on
    ``args``; and ``plain()``: its plain version on the same operands."""
    names = {"fwd": gs.KERNEL, "pair_fwd": mk.KERNEL, "quad": mk.KERNEL_QUAD,
             "bwd": gs.KERNEL_BWD, "pair_bwd": mk.KERNEL_BWD}
    plains = {"fwd": gs.gspn_scan_fwd_torch,
              "pair_fwd": mk.gspn_scan_bidir_torch,
              "quad": mk.gspn_scan_quad_torch,
              "bwd": gs.gspn_scan_bwd_torch,
              "pair_bwd": mk.gspn_scan_bidir_bwd_torch}
    name, plain = names[key.direction], plains[key.direction]
    launch = gs.launch if key.kind == "fwd" else gs.launch_bwd

    def run(s):
        return launch(key.ndir, name, *args, None, boundary=key.boundary,
                      shape=s)

    return run, lambda: plain(*args)


def check_candidates(key: ScanKey, cands, args=None):
    """Each candidate's output against the plain version on the same
    seeded operands: ``[(Candidate, max_abs_err, tolerance)]``."""
    args = args if args is not None else operands(key)
    run, plain = kernel_runner(key, args)
    want = plain().float()
    tol = tolerance(key) * want.abs().max().item()
    out = []
    for cand in cands:
        got = run(cand.shape(key)).float()
        out.append((cand, (got - want).abs().max().item(), tol))
    return out


def autotune_key(key: ScanKey, *, candidates=None,
                 cache: TuningCache | None = None, measure_fn=None,
                 runner=None) -> dict:
    """Time every candidate for ``key`` and store the entry.

    ``runner(cand) -> zero-argument launch`` and ``measure_fn(fn) ->
    (median µs, spread µs)`` are injectable (the tests drive the decision
    with fakes); by default each candidate is first held against the
    plain version (:func:`check_candidates`; a disagreeing one is refused
    and never timed) and timed by :func:`measure`.  The heuristic's shape
    is timed too; another shape is stored only where it beats the
    heuristic by more than its own spread in the sweep and in each of
    ``CONFIRM`` alternating rounds, else the heuristic's shape."""
    cands = list(candidates if candidates is not None
                 else enumerate_candidates(key))
    heur = Candidate.of(heuristic(key))
    if heur not in cands:
        cands.insert(0, heur)
    cache = cache if cache is not None else get_cache()
    measure_fn = measure_fn or measure
    if runner is None:
        args = operands(key)
        checked = check_candidates(key, cands, args)
        bad = [(c, e) for c, e, tol in checked if not e <= tol]
        for cand, err in bad:
            obs.event("autotune.disagree", key=key.encode(),
                      plan=cand.label(), max_abs_err=err)
            print(f"[autotune] {key.encode()} {cand.label()} disagrees "
                  f"with the plain version: {err}", file=sys.stderr)
        if heur in {c for c, _ in bad}:
            raise AssertionError(f"{key.encode()}: the heuristic's shape "
                                 f"disagrees with the plain version")
        cands = [c for c, e, tol in checked if e <= tol]
        run, _ = kernel_runner(key, args)

        def runner(cand):
            s = cand.shape(key)
            return lambda: run(s)

    timed = {}
    with obs.trace("autotune.key", key=key.encode(),
                   n_candidates=len(cands)):
        for cand in cands:
            with obs.trace("autotune.measure", plan=cand.label()):
                us, spread = measure_fn(runner(cand))
            obs.event("autotune.candidate", key=key.encode(),
                      plan=cand.label(), us=round(us, 3))
            timed[cand] = (us, spread)
    obs.counter("autotune_keys_measured_total", "keys timed").inc()
    obs.counter("autotune_candidates_timed_total",
                "candidate shapes timed").inc(len(timed))
    heur_us = timed[heur][0]
    best = min(timed, key=lambda c: timed[c][0])
    chosen, source = heur, "heuristic"
    us, spread = timed[heur]
    if best != heur and heur_us - timed[best][0] > timed[best][1]:
        # A sweep's winner by noise rarely wins every one of CONFIRM
        # alternating rounds (the heuristic, then the winner).
        rounds = [(measure_fn(runner(heur)), measure_fn(runner(best)))
                  for _ in range(CONFIRM)]
        if all(h[0] - b[0] > b[1] for h, b in rounds):
            chosen, source = best, "measured"
            us = statistics.median(b[0] for _, b in rounds)
            spread = max(b[1] for _, b in rounds)
            heur_us = statistics.median(h[0] for h, _ in rounds)
    entry = {**dataclasses.asdict(chosen), "us": round(us, 3),
             "heuristic_us": round(heur_us, 3), "spread_us": round(spread, 3),
             "n_candidates": len(timed), "source": source}
    cache.store(key, entry)
    if cache is _CACHE:
        _changed()
    return entry


# ---------------------------------------------------------------------------
# Warm list + CLI.
# ---------------------------------------------------------------------------

# (g, h, w, cpw, direction, boundary): the shapes the main paths launch,
# each in float32 and bfloat16.
WARM_SHAPES = (
    # the vision path's pair and its adjoint, and the ladder's quad, at
    # GSPN-2-T's stage widths, batch 64
    *[(128, n, n, 2, d, "one_shot") for d in ("pair_fwd", "pair_bwd", "quad")
      for n in (56, 28, 14, 7)],
    # #1 on the LM serving path (one request, C_proxy 8): the T→B pass of
    # a one-shot prefill and of a seeded chunk, the within-row pass of both
    (8, 1, 1024, 8, "fwd", "one_shot"),
    (8, 2, 1024, 8, "fwd", "chunk_resume"),
    (8, 1024, 1, 8, "fwd", "one_shot"),
    (8, 1024, 1, 8, "fwd", "chunk_resume"),
    # #1 and #2 on the LM training step at 2 × 4096
    *[(16, h, w, 8, d, "one_shot") for d in ("fwd", "bwd")
      for h, w in ((4, 1024), (1024, 4))],
)


def warm_keys(device: str) -> list[ScanKey]:
    return [ScanKey(device, g, h, w, cpw, d, dtype, boundary=b)
            for g, h, w, cpw, d, b in WARM_SHAPES
            for dtype in ("float32", "bfloat16")]


def warm(keys=None, *, cache: TuningCache | None = None,
         verbose: bool = True) -> TuningCache:
    """Tune every key (the warm list on this card by default) and return
    the cache."""
    cache = cache if cache is not None else get_cache()
    for key in keys or warm_keys(device_kind("cuda")):
        entry = autotune_key(key, cache=cache)
        if verbose:
            print(f"[autotune] {key.encode()} -> "
                  f"{Candidate.from_entry(entry).label()} {entry['source']} "
                  f"{entry['us']} us (heuristic {entry['heuristic_us']}, "
                  f"spread {entry['spread_us']}, {entry['n_candidates']} "
                  f"candidates)", flush=True)
    return cache


def main(argv=None) -> int:
    import argparse
    import subprocess

    ap = argparse.ArgumentParser(prog="repro_torch.kernels.autotune")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_warm = sub.add_parser("warm", help="measure the warm list on the card")
    ap_warm.add_argument("--out", default="",
                         help="write the cache here (default: the seed path)")
    sub.add_parser("show", help="print the resolved cache")
    args = ap.parse_args(argv)

    if args.cmd == "warm":
        if not torch.cuda.is_available():
            print("[autotune] warm measures on a CUDA card; none is "
                  "available", file=sys.stderr)
            return 1
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        # A fresh cache: the file holds this card's measurements only.
        cache = TuningCache(meta={
            "device": torch.cuda.get_device_name(0), "power_limit": limit,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "measured_by": "python -m repro_torch.kernels.autotune warm"})
        warm(cache=cache)
        path = cache.save(args.out or SEED_CACHE_PATH)
        print(f"[autotune] wrote {len(cache)} entries to {path}")
        return 0
    cache = get_cache(reload=True)
    print(json.dumps({"schema": SCHEMA_VERSION, **cache.meta,
                      "entries": cache.entries}, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
