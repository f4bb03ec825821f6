"""The port's launch-shape tuner on the CPU (``kernels/tuning.py``,
``kernels/autotune.py``, ``spec.canonical_key``): the cache key against
the reference's, the resolution order (explicit, then a valid cache
entry, then ``pair_launch_shape``), a miss giving exactly the heuristic's
shape at every shape ``chip_smoke.py`` and the LM paths launch, the
admission model against the C side's ``check_shape``, rejected entries,
the cache file's round trips and its ``GSPN_TUNE_CACHE`` layering, the
measurement's store decision, the committed H100 seed file, and the
kernel layer's counters and library load under threads.  The timings
themselves come only from the card (``python -m
repro_torch.kernels.autotune warm``).
"""

import ctypes
import importlib.util
import json
import pathlib
import threading
import time

import pytest
import torch

from repro.kernels import spec as jspec
from repro_torch import obs
from repro_torch.kernels import autotune, cuda_lib, gspn_scan, tuning
from repro_torch.kernels.gspn_scan import pair_launch_shape
from repro_torch.kernels.spec import ScanSpec, canonical_key, enumerate_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_shapes():
    """(g, h, w, cpw, chunk, direction) of every kernel row of
    ``chip_smoke.py`` and of the LM paths."""
    m = _smoke()
    out = []
    for n in m.MAIN_WIDTHS:
        out += [(2 * m.BATCH, n, n, 2, None, d)
                for d in ("fwd", "bwd", "pair_fwd", "pair_bwd", "quad")]
    out += [(32, 256, 256, 2, None, d)
            for d in ("fwd", "bwd", "pair_fwd", "pair_bwd", "quad")]
    for g, h, w, cpw, chunk in ((8, 19, 37, 1, None), (8, 19, 37, 4, None),
                                (8, 38, 37, 4, 19)):
        out += [(g, h, w, cpw, chunk, d)
                for d in ("fwd", "bwd", "pair_fwd", "pair_bwd")]
    out += [(8, 19, 19, cpw, None, "quad") for cpw in (1, 4)]
    for g, h, w, cpw, chunk in m.LM_SHAPES + m.SERVE_SHAPES + m.TRAIN_SHAPES:
        out += [(g, h, w, cpw, chunk, d) for d in ("fwd", "bwd")]
    return out


SHAPES = _smoke_shapes()
DTYPES = (torch.float32, torch.bfloat16)


def _spec(direction, cpw, dtype, boundary="one_shot"):
    return ScanSpec(direction=direction, impl="cuda", channels_per_weight=cpw,
                    stream_dtype=dtype, boundary=boundary)


@pytest.fixture
def fresh_cache(monkeypatch):
    """The global cache rebuilt from the seed alone, and rebuilt again
    after the test."""
    monkeypatch.delenv(autotune.ENV_CACHE_PATH, raising=False)
    autotune.get_cache(reload=True)
    yield
    monkeypatch.delenv(autotune.ENV_CACHE_PATH, raising=False)
    autotune.get_cache(reload=True)


# ---------------------------------------------------------------------------
# The key.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "spec", enumerate_specs(boundaries=("one_shot", "chunk_resume")),
    ids=lambda s: f"{s.canonical()}|cpw{s.channels_per_weight}")
def test_canonical_key_equals_the_reference(spec):
    """The same legs give the reference's string, and the spec's canonical
    string is the reference spec's with the kernel legs renamed."""
    legs = (spec.direction, spec.impl, spec.stream_dtype, spec.carry_dtype,
            spec.channel_shared, spec.boundary)
    assert canonical_key(*legs) == jspec.canonical_key(*legs)
    assert spec.canonical() == canonical_key(*legs)
    ref_impl = {"torch": "xla", "cuda": ("pallas" if spec.direction == "fwd"
                                         else "multidir")}[spec.impl]
    ref = jspec.ScanSpec(direction=spec.direction, impl=ref_impl,
                         channels_per_weight=spec.channels_per_weight,
                         stream_dtype=spec.stream_dtype,
                         boundary=spec.boundary)
    assert spec.canonical().replace(f"|{spec.impl}|", f"|{ref_impl}|") == \
        ref.canonical()


def test_scan_key_encodes_device_shape_and_spec():
    spec = _spec("fwd", 8, torch.bfloat16, "chunk_resume")
    key = autotune.ScanKey.from_spec(spec, 8, 2, 1024, "nvidia-h100")
    assert key.encode() == ("nvidia-h100|g8|h2|w1024|cpw8|" +
                            spec.canonical())
    assert autotune.ScanKey.decode(key.encode()) == key
    with pytest.raises(ValueError):
        autotune.ScanKey.decode("cpu|h8|w8|c8|fwd|pallas|float32|"
                                "carry-float32|cs1|bnd-one_shot")
    assert autotune.device_kind("cpu") == "cpu"
    assert autotune.device_kind(None) == "cpu"


# ---------------------------------------------------------------------------
# Resolution.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_a_miss_gives_the_heuristic_shape(shape, dtype, fresh_cache):
    """Field for field, through the global cache (CPU key: the seed holds
    none) and through an empty one, at every shape the smoke and the LM
    paths launch."""
    g, h, w, cpw, _chunk, direction = shape
    kind, ndir = autotune.GEOMETRY[direction]
    want = pair_launch_shape(g, h, w, cpw, dtype, kind, ndir)
    spec = _spec(direction, cpw, dtype)
    assert autotune.plan_for_spec(spec, g, h, w) == want
    assert autotune.plan_for_spec(spec, g, h, w, device="nvidia-h100-x",
                                  cache=autotune.TuningCache()) == want
    assert gspn_scan.plan(kind, ndir, g, h, w, cpw, dtype, "cpu") == want


def _other_candidate(key):
    heur = autotune.Candidate.of(autotune.heuristic(key))
    return next(c for c in autotune.enumerate_candidates(key) if c != heur)


def test_resolution_order_explicit_then_cache_then_heuristic():
    spec = _spec("fwd", 8, torch.float32)
    key = autotune.ScanKey.from_spec(spec, 8, 1024, 1, "dev")
    heur = autotune.heuristic(key)
    other = _other_candidate(key)
    cache = autotune.TuningCache()
    assert autotune.plan_for_spec(spec, 8, 1024, 1, device="dev",
                                  cache=cache) == heur
    cache.store(key, {**vars(other), "us": 1.0, "source": "measured"})
    assert autotune.plan_for_spec(spec, 8, 1024, 1, device="dev",
                                  cache=cache) == other.shape(key)
    explicit = autotune.enumerate_candidates(key)[-1].shape(key)
    assert autotune.plan_for_spec(spec, 8, 1024, 1, device="dev",
                                  cache=cache, launch=explicit) == explicit
    # another device or another boundary is another key
    assert autotune.plan_for_spec(spec, 8, 1024, 1, device="dev2",
                                  cache=cache) == heur
    assert autotune.plan_for_spec(spec.with_(boundary="chunk_resume"), 8,
                                  1024, 1, device="dev",
                                  cache=cache) == heur


@pytest.mark.parametrize("direction,g,h,w,cpw", [
    ("fwd", 16, 1024, 4, 8), ("bwd", 16, 1024, 4, 8),
    ("pair_fwd", 128, 28, 56, 2), ("pair_bwd", 128, 28, 56, 2)])
def test_sp_block_local_keys_plan_the_heuristic(fresh_cache, direction, g, h,
                                                w, cpw):
    """A block-local launch of the sequence-parallel scan has a key of its
    own (``bnd-sp_block_local``) that the seed does not hold: it plans the
    heuristic's shape, as a key without a boundary leg does."""
    spec = _spec(direction, cpw, torch.float32, "sp_block_local")
    dev = "nvidia-h100-80gb-hbm3"
    key = autotune.ScanKey.from_spec(spec, g, h, w, dev)
    assert key.encode().endswith("|bnd-sp_block_local")
    assert autotune.ScanKey.decode(key.encode()) == key
    assert autotune.get_cache().lookup(key) is None
    assert autotune.plan_for_spec(spec, g, h, w, device=dev) == \
        autotune.heuristic(key)


def test_global_cache_hit_is_remembered_until_the_cache_changes(
        tmp_path, fresh_cache):
    spec = _spec("fwd", 8, torch.float32)
    key = autotune.ScanKey.from_spec(spec, 8, 1024, 1, "dev-g")
    other = _other_candidate(key)
    assert autotune.plan_for_spec(spec, 8, 1024, 1, device="dev-g") == \
        autotune.heuristic(key)
    extra = autotune.TuningCache()
    extra.store(key, {**vars(other), "source": "measured"})
    path = extra.save(tmp_path / "t.json")
    assert autotune.load_cache(path) == 1
    assert autotune.plan_for_spec(spec, 8, 1024, 1, device="dev-g") == \
        other.shape(key)
    src = autotune.resolved_plans()[key.encode()][1]
    assert src == "cache"
    assert "g8|h1024|w1|cpw8|fwd:" + other.label() in \
        autotune.plans_summary()


def test_kernel_plan_event_names_the_source():
    obs.clear()
    obs.enable()
    try:
        spec = _spec("pair_fwd", 2, torch.float32)
        autotune.plan_for_spec(spec, 6, 5, 7, device="dev-ev",
                               cache=autotune.TuningCache())
    finally:
        obs.disable()
    ev = [r for r in obs.records() if r.name == "kernel.plan"]
    assert ev and ev[-1].args["source"] == "heuristic"
    assert ev[-1].args["key"].startswith("dev-ev|g6|h5|w7|cpw2|pair_fwd")


# ---------------------------------------------------------------------------
# Admission.
# ---------------------------------------------------------------------------

def _keys():
    out = autotune.warm_keys("dev")
    for g, h, w, cpw, _chunk, d in SHAPES:
        out += [autotune.ScanKey("dev", g, h, w, cpw, d, str(dt)[6:])
                for dt in DTYPES]
    return out


@pytest.mark.parametrize("key", _keys(), ids=lambda k: k.encode())
def test_every_candidate_is_admitted_and_the_heuristic_is_first(key):
    heur = autotune.heuristic(key)
    cands = autotune.enumerate_candidates(key)
    assert cands[0] == autotune.Candidate.of(heur)
    assert len(set(cands)) == len(cands)
    item = tuning.item_bytes(key.torch_dtype)
    for cand in cands:
        s = cand.shape(key)
        assert autotune.admit(key, s) is None, cand
        assert tuning.refusal(key.kind, key.ndir, key.g, key.h, key.w,
                              key.cpw, item, s) is None
        assert s.smem_bytes <= gspn_scan.SMEM_MAX
        assert s.warps <= gspn_scan._MAX_WARPS[s.k]
        assert autotune.Candidate.of(s) == cand


def test_check_shape_mirror_refuses_what_the_source_refuses():
    """Each clause of the source's check_shape, one shape each."""
    ok = dict(g=8, h=16, w=64, cpw=4, planes=4, warps=8, k=2, splits=1,
              batch=16, nbuf=1, smem=100_000, stage_bytes=10_000)
    assert tuning.check_shape(**ok) is None
    for change, word in [
            (dict(k=3), "power of two"), (dict(bands=3), "bands"),
            (dict(bands=2, k=8), "bands"), (dict(w=65), "columns < W"),
            (dict(g=9), "operands"), (dict(warps=3), "warps for"),
            (dict(warps=17), "registers allow"),
            (dict(splits=2), "do not cover"), (dict(planes=3), "do not cover"),
            (dict(nbuf=9), "nbuf"), (dict(batch=8), "does not hold"),
            (dict(smem=9_999), "the ring needs"),
            (dict(smem=300_000), "exceeds"),
            (dict(direct=True, k=8), "direct windows"),
            (dict(direct=True, h=64), "direct windows")]:
        reason = tuning.check_shape(**{**ok, **change})
        assert reason is not None and word in reason, (change, reason)


def test_admission_refuses_shapes_the_fields_do_not_describe():
    key = autotune.ScanKey("dev", 128, 56, 56, 2, "pair_fwd")
    s = autotune.heuristic(key)
    assert autotune.admit(key, s) is None
    assert "derived" in autotune.admit(
        key, s._replace(smem_bytes=s.smem_bytes + 16))
    assert "derived" in autotune.admit(key, s._replace(grid=(1, 1, 2)))
    wide = autotune.ScanKey("dev", 128, 56, 1024, 2, "pair_fwd")
    whole = autotune.Candidate(2, 4, 1, 56, 1).shape(wide)
    assert whole.smem_bytes > tuning.SMEM_MAX
    assert "exceeds" in autotune.admit(wide, whole)
    assert "longer than the plane" in autotune.admit(
        key, s._replace(batch=57))
    assert "registers allow" in autotune.admit(key, s._replace(warps=17))
    quad = autotune.ScanKey("dev", 128, 56, 56, 2, "quad")
    assert "pitch" in tuning.refusal(
        "fwd", 4, 128, 56, 56, 2, 4,
        autotune.heuristic(quad)._replace(xpitch=1))


# ---------------------------------------------------------------------------
# Rejected entries.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry, word", [
    ("not a dict", "not a mapping"),
    ({"planes": 2}, "malformed"),
    ({"planes": 2.5, "warps": 8, "splits": 1, "batch": 56, "nbuf": 1,
      "bands": 1, "direct": False, "window_k": 0}, "malformed"),
    ({"planes": 1, "warps": 8, "splits": 1, "batch": 56, "nbuf": 1,
      "bands": 1, "direct": False, "window_k": 0}, "do not cover"),
    ({"planes": 2, "warps": 64, "splits": 1, "batch": 56, "nbuf": 1,
      "bands": 1, "direct": False, "window_k": 0}, "registers allow"),
    ({"planes": 2, "warps": 8, "splits": 1, "batch": 64, "nbuf": 1,
      "bands": 1, "direct": False, "window_k": 0}, "longer than the plane"),
    ({"planes": 2, "warps": 8, "splits": 1, "batch": 56, "nbuf": 1,
      "bands": 2, "direct": False, "window_k": 0}, "bands"),
])
def test_corrupt_or_stale_entry_is_rejected_with_a_counted_reason(entry,
                                                                  word):
    spec = _spec("pair_fwd", 2, torch.float32)
    key = autotune.ScanKey.from_spec(spec, 128, 56, 56, "dev-rej")
    cache = autotune.TuningCache({key.encode(): entry})
    before = obs.counter("autotune_cache_rejects_total").value
    obs.clear()
    obs.enable()
    try:
        got = autotune.plan_for_spec(spec, 128, 56, 56, device="dev-rej",
                                     cache=cache)
    finally:
        obs.disable()
    assert got == autotune.heuristic(key)
    assert obs.counter("autotune_cache_rejects_total").value == before + 1
    ev = [r for r in obs.records() if r.name == "autotune.cache_reject"]
    assert ev and word in ev[-1].args["reason"], ev[-1].args["reason"]


# ---------------------------------------------------------------------------
# The cache file.
# ---------------------------------------------------------------------------

def test_save_load_merge_round_trip(tmp_path):
    key = autotune.ScanKey("dev", 8, 1024, 1, 8, "fwd")
    entry = {**vars(_other_candidate(key)), "us": 1.5, "source": "measured"}
    cache = autotune.TuningCache(meta={"device": "card", "power_limit": "1 W"})
    cache.store(key, entry)
    path = cache.save(tmp_path / "c.json")
    payload = json.loads(path.read_text())
    assert payload["schema"] == autotune.SCHEMA_VERSION == 3
    back = autotune.TuningCache.load(path)
    assert back.lookup(key) == entry and back.meta == cache.meta
    other = autotune.TuningCache()
    key2 = autotune.ScanKey("dev", 8, 1, 1024, 8, "fwd")
    other.store(key2, {"x": 1})
    back.merge(other)
    assert len(back) == 2 and back.lookup(key2) == {"x": 1}
    (tmp_path / "bad.json").write_text("{not json")
    assert len(autotune.TuningCache.load(tmp_path / "bad.json")) == 0
    assert len(autotune.TuningCache.load(tmp_path / "missing.json")) == 0


def test_env_cache_layers_over_the_seed(tmp_path, monkeypatch, fresh_cache):
    seed = autotune.TuningCache.load(autotune.SEED_CACHE_PATH)
    key = autotune.ScanKey("dev-env", 8, 1024, 1, 8, "fwd")
    layer = autotune.TuningCache()
    layer.store(key, {**vars(_other_candidate(key)), "source": "measured"})
    monkeypatch.setenv(autotune.ENV_CACHE_PATH,
                       str(layer.save(tmp_path / "env.json")))
    cache = autotune.get_cache(reload=True)
    assert len(cache) == len(seed) + 1
    assert cache.lookup(key) == layer.lookup(key)
    assert all(cache.entries[k] == v for k, v in seed.entries.items())
    spec = _spec("fwd", 8, torch.float32)
    assert autotune.plan_for_spec(spec, 8, 1024, 1, device="dev-env") == \
        _other_candidate(key).shape(key)


def test_committed_seed_names_the_card_and_every_entry_runs():
    """The seed was measured on the H100 (its name and power limit are in
    the file), holds the warm list in both dtypes, and every entry is
    admissible at its key; a measured entry beat the heuristic by more
    than its spread."""
    seed = autotune.TuningCache.load(autotune.SEED_CACHE_PATH)
    assert "H100" in seed.meta["device"]
    assert seed.meta["power_limit"].endswith("W")
    device = autotune.ScanKey.decode(next(iter(seed.entries))).device
    assert set(seed.entries) == {k.encode()
                                 for k in autotune.warm_keys(device)}
    for enc, entry in seed.entries.items():
        key = autotune.ScanKey.decode(enc)
        assert autotune.entry_invalid_reason(key, entry) is None, enc
        assert entry["source"] in ("measured", "heuristic")
        heur = autotune.Candidate.of(autotune.heuristic(key))
        if entry["source"] == "heuristic":
            assert autotune.Candidate.from_entry(entry) == heur
        else:
            assert entry["heuristic_us"] - entry["us"] > entry["spread_us"]


# ---------------------------------------------------------------------------
# The measurement's decision.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gain, spread, confirm, stored", [
    (2.0, 0.5, (2.0,) * 3, "measured"), (0.4, 0.5, (), "heuristic"),
    (-1.0, 0.1, (), "heuristic"), (2.0, 0.5, (2.0, 0.3, 2.0), "heuristic"),
])
def test_autotune_key_stores_a_winner_only_past_its_spread(gain, spread,
                                                           confirm, stored):
    """The sweep's winner must beat the heuristic by more than its spread,
    then again in each confirming round (``confirm``: its gains there)."""
    key = autotune.ScanKey("dev-fake", 8, 1024, 1, 8, "fwd")
    cands = autotune.enumerate_candidates(key)[:4]
    heur, best = cands[0], cands[2]
    times = {c: [(10.0, 0.2)] for c in cands}
    times[best] = [(10.0 - g, spread) for g in (gain, *confirm)]
    calls = {c: 0 for c in cands}

    def fake(c):
        calls[c] += 1
        runs = times[c]
        return runs[min(calls[c], len(runs)) - 1]

    cache = autotune.TuningCache()
    obs.clear()
    obs.enable()
    try:
        entry = autotune.autotune_key(key, candidates=cands, cache=cache,
                                      runner=lambda c: c, measure_fn=fake)
    finally:
        obs.disable()
    assert calls[best] == 1 + len(confirm)
    assert entry["source"] == stored
    chosen = best if stored == "measured" else heur
    assert autotune.Candidate.from_entry(entry) == chosen
    assert entry["heuristic_us"] == 10.0 and entry["n_candidates"] == 4
    assert cache.lookup(key) == entry
    names = {r.name for r in obs.records()}
    assert {"autotune.key", "autotune.measure",
            "autotune.candidate"} <= names


def test_warm_list_covers_the_main_paths():
    keys = autotune.warm_keys("d")
    assert len(keys) == 40
    dirs = {(k.direction, k.g, k.h, k.w, k.boundary) for k in keys}
    assert ("fwd", 8, 2, 1024, "chunk_resume") in dirs
    assert ("fwd", 8, 1024, 1, "one_shot") in dirs
    assert ("bwd", 16, 1024, 4, "one_shot") in dirs
    assert {("quad", 128, n, n, "one_shot") for n in (56, 28, 14, 7)} <= dirs


def test_warm_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: warm would measure on it")
    assert autotune.main(["warm"]) == 1


# ---------------------------------------------------------------------------
# The kernel layer under threads.
# ---------------------------------------------------------------------------

def test_launch_counters_are_exact_under_threads():
    cuda_lib.clear_counts()

    def work():
        for _ in range(2000):
            gspn_scan._count("k", 1, 2, 3, torch.float32)
            cuda_lib.count(cuda_lib.plain_calls, "p")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert cuda_lib.launch_counts["k"] == 16000
    assert cuda_lib.launch_shapes[("k", 1, 2, 3, "float32")] == 16000
    assert cuda_lib.plain_calls["p"] == 16000
    cuda_lib.clear_counts()


def test_a_library_is_built_and_loaded_once_under_threads(monkeypatch,
                                                          tmp_path):
    builds = []

    def fake_build(names):
        builds.append(names)
        time.sleep(0.05)
        return {n: tmp_path / f"{n}.so" for n in names}

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    monkeypatch.setattr(cuda_lib, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(cuda_lib, "_LIBS", {})
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(cuda_lib.library("gspn_pair")))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(builds) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)
