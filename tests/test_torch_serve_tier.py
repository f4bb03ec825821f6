"""The port's serving tier on the CPU (DESIGN.md §15): the shared
prefix-state cache, the engine's tier surface (handles, ``drain``,
``pending_chunks``, the finish hook, the deprecated ``on_finish``),
replicas and the router, held against the JAX package's tier from
converted parameters; the twins of ``tests/test_serve_router.py`` and of
the prefix cases of ``tests/test_prefill_resume.py``.  On the reduced
``qwen2-1.5b-gspn`` (2 gspn layers, row width 8) and the reduced
``qwen2-1.5b`` (2 attn layers, its KV cache in every entry), f32 policy.
Every wait on a thread is bounded by a timeout.
"""

import functools
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import base as jbase
from repro.configs import qwen2_1_5b as jqa
from repro.configs import qwen2_1_5b_gspn as jq
from repro.models import lm as jlm
from repro.serve import cache as jcache
from repro.serve import engine as jengine
from repro.serve import router as jrouter
from repro_torch import obs
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen2_1_5b as tqa
from repro_torch.configs import qwen2_1_5b_gspn as tq
from repro_torch.kernels import cuda_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.cache import PrefixStateCache
from repro_torch.serve.engine import Request, ServeEngine, drive
from repro_torch.serve.router import POLICIES, Router

pytestmark = pytest.mark.serve

LOGITS_TOL = 1e-5
CHUNK = 8           # the reduced configs' fold width
TIMEOUT = 60.0      # seconds any wait on a thread may take
ARCHS = {"gspn": (jq, tq), "attn": (jqa, tqa)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _pair(kind):
    """(JAX params, JAX config, the port's LM from the converted
    parameters) of the reduced architecture, f32 policy."""
    jmod, tmod = ARCHS[kind]
    cj = jbase.with_precision(jmod.reduced(), "f32")
    params = jlm.init_lm(jax.random.PRNGKey(0), cj)
    model = lm.LM(tbase.with_precision(tmod.reduced(), "f32"), device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, cj, model


def _engine(model, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", CHUNK)
    return ServeEngine(model, **kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n)


def _shared(suffixes, seed=11, prefix_len=3 * CHUNK):
    head = _prompt(prefix_len, seed)
    return [np.concatenate([head, _prompt(n, seed + 1 + i)])
            for i, n in enumerate(suffixes)]


def _bounded(fn, timeout=TIMEOUT):
    """Run ``fn`` on a thread; fail if it has not returned in time."""
    out, err = [], []

    def body():
        try:
            out.append(fn())
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            err.append(exc)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"did not finish within {timeout} s"
    if err:
        raise err[0]
    return out[0]


# ---------------------------------------------------------------------------
# The prefix-state cache at the LM level.
# ---------------------------------------------------------------------------

def _close(got, want, tol=LOGITS_TOL):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("kind", ARCHS)
def test_prefix_hit_logits_equal_the_cold_chunk_chain(kind):
    """Chain a prompt's chunks; store the cache at 3 chunks; a lookup for
    the whole prompt probes 5 and 4 chunks (misses) and resumes at 3: its
    chunks' logits and final cache equal the cold chain's, and the last
    logits the one-shot prefill's, at 1e-5."""
    _, _, model = _pair(kind)
    total, k = 5 * CHUNK + 3, 3 * CHUNK
    prompt = _prompt(total, 5)
    toks = torch.from_numpy(prompt)[None].long()
    pfx = PrefixStateCache()
    with torch.no_grad():
        cache = lm.init_lm_cache(model.cfg, 1, 64, device="cpu")
        cold = []
        for off in range(0, total, CHUNK):
            logits, cache = lm.lm_prefill_chunk(
                model, toks[:, off:off + CHUNK], cache, off)
            cold.append(logits)
            if off + CHUNK == k:
                pfx.insert(prompt[:k], cache)
        hit = pfx.lookup(prompt, CHUNK)
        assert hit is not None and hit[0] == k
        warm, c2 = [], hit[1]
        for off in range(k, total, CHUNK):
            logits, c2 = lm.lm_prefill_chunk(
                model, toks[:, off:off + CHUNK], c2, off)
            warm.append(logits)
        one_shot, _ = lm.lm_prefill(model, toks, 64)
    _close(torch.cat(warm, 1), torch.cat(cold[k // CHUNK:], 1))
    _close(warm[-1][:, -1], one_shot[:, -1])
    for key, sub in cache.items():
        for name, leaf in sub.items():
            if leaf.is_floating_point():
                _close(c2[key][name], leaf)
            else:
                assert torch.equal(c2[key][name], leaf)


def _margins_ok(model, prompt, tokens):
    """Every generated token's top-two logit margin exceeds 10x the
    logits tolerance (a near tie would make equal tokens say nothing)."""
    seq = np.concatenate([prompt, tokens[:-1]])
    with torch.no_grad():
        logits = lm.apply_lm(model, torch.from_numpy(seq)[None].long())
    steps = logits[0, len(prompt) - 1:]
    tol = 1e-4 * logits.abs().max().item()
    top2 = steps.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    assert min(margins) >= 10 * tol, (margins, tol)
    assert steps.argmax(-1).tolist() == tokens


@pytest.mark.parametrize("kind", ARCHS)
def test_prefix_hit_tokens_equal_cold_and_the_jax_engine(kind):
    """Three prompts sharing 3 chunks: the port's engine with a prefix
    cache against itself without one and against the JAX engine with its
    cache (same converted parameters): equal greedy tokens and equal
    cached-token counts."""
    params, cj, model = _pair(kind)
    prompts = _shared((5, 11, 3))
    n_new = 6

    def port(cache):
        eng = _engine(model, prefix_cache=cache)
        hs = [eng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new))
              for i, p in enumerate(prompts)]
        eng.run()
        return [h.result() for h in hs]

    cold = port(None)
    warm = port(PrefixStateCache())
    jeng = jengine.ServeEngine(params, cj, batch_size=2, max_len=64,
                               prefill_chunk=CHUNK,
                               prefix_cache=jcache.PrefixStateCache())
    jh = [jeng.submit(jengine.Request(uid=i, prompt=p,
                                      max_new_tokens=n_new))
          for i, p in enumerate(prompts)]
    jeng.run()
    ref = [h.result() for h in jh]
    for p, r in zip(prompts, warm):
        _margins_ok(model, p, r.tokens)
    assert [r.tokens for r in warm] == [r.tokens for r in cold] == \
        [r.tokens for r in ref]
    assert [r.cached_tokens for r in warm] == \
        [r.cached_tokens for r in ref] == [0, 3 * CHUNK, 3 * CHUNK]
    assert [r.cached_tokens for r in cold] == [0, 0, 0]


@pytest.mark.parametrize("kind", ARCHS)
def test_stored_entry_is_unchanged_after_two_resumes(kind):
    """The cache shares its tensors with the prefill that stored them
    (no clone): after two requests resumed from an entry, every stored
    tensor is bit for bit what it was."""
    _, _, model = _pair(kind)
    pfx = PrefixStateCache()
    prompts = _shared((5, 6, 7), seed=21)
    eng = _engine(model, prefix_cache=pfx)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=3))
    eng.run()
    before = {key: [t.clone() for t in lm_leaves(tree)]
              for key, (_, tree) in pfx._entries.items()}
    assert len(before) == 3
    hits0 = obs.counter("serve_prefix_hits_total").value
    for uid in (1, 2):
        eng.submit(Request(uid=uid, prompt=prompts[uid], max_new_tokens=3))
    eng.run()
    assert obs.counter("serve_prefix_hits_total").value == hits0 + 2
    assert [eng.results[u].cached_tokens for u in (1, 2)] == [24, 24]
    for key, leaves in before.items():
        now = list(lm_leaves(pfx._entries[key][1]))
        assert all(torch.equal(a, b) for a, b in zip(now, leaves))


def lm_leaves(tree):
    for sub in tree.values():
        yield from sub.values()


# ---------------------------------------------------------------------------
# PrefixStateCache alone.
# ---------------------------------------------------------------------------

def test_prefix_cache_alignment_and_proper_prefix_cap():
    """Only chunk-aligned offsets, strictly below the prompt's length (the
    last chunk must give the first token's logits)."""
    tree = {"s": {"a": torch.zeros((1, 2))}}
    pfx = PrefixStateCache()
    toks = np.arange(64, dtype=np.int32)
    for k in (16, 32, 48, 64):
        pfx.insert(toks[:k], tree)
    assert pfx.lookup(toks, chunk=16)[0] == 48
    assert pfx.lookup(toks[:33], chunk=16)[0] == 32
    assert pfx.lookup(toks[:15], chunk=16) is None
    assert pfx.lookup(np.arange(100, 140, dtype=np.int32), 16) is None
    k, got = pfx.lookup(toks, chunk=16)
    assert got is not tree and got["s"] is not tree["s"]
    assert got["s"]["a"] is tree["s"]["a"]
    assert pfx.nbytes == 4 * 8


def test_prefix_cache_lru_eviction_and_refresh():
    tree = {"s": {"a": torch.zeros(())}}
    pfx = PrefixStateCache(capacity=2)
    a, b, c = (np.full(8, i, np.int32) for i in range(3))
    evicted = obs.counter("serve_prefix_evictions_total").value
    pfx.insert(a, tree)
    pfx.insert(b, tree)
    pfx.insert(a, tree)                  # refresh: a is the newest
    pfx.insert(c, tree)                  # evicts b, the oldest
    assert len(pfx) == 2
    assert obs.counter("serve_prefix_evictions_total").value == evicted + 1
    assert pfx.lookup(np.concatenate([b, b[:1]]), 8) is None
    assert pfx.lookup(np.concatenate([a, a[:1]]), 8)[0] == 8
    pfx.lookup(np.concatenate([a, a[:1]]), 8)   # a refreshed by a hit
    pfx.insert(b, tree)                          # evicts c
    assert pfx.lookup(np.concatenate([c, c[:1]]), 8) is None


def test_prefix_cache_verifies_tokens_not_just_hash():
    """A poisoned entry (right key, wrong tokens: a hash collision) is a
    miss, never wrong state."""
    pfx = PrefixStateCache()
    good = np.arange(8, dtype=np.int32)
    pfx.insert(good, {"s": {"a": torch.ones(())}})
    other = np.arange(100, 109, dtype=np.int32)
    pfx._entries[pfx._key(other[:8])] = (good, {"s": {"a": torch.ones(())}})
    misses = obs.counter("serve_prefix_misses_total").value
    assert pfx.lookup(other, 8) is None
    assert obs.counter("serve_prefix_misses_total").value == misses + 1


def test_prefix_cache_is_safe_under_threads():
    pfx = PrefixStateCache(capacity=16)
    tree = {"s": {"a": torch.zeros(4)}}

    def work(i):
        for j in range(200):
            toks = np.full(8, (i * 7 + j) % 40, np.int32)
            pfx.insert(toks, tree)
            pfx.lookup(np.concatenate([toks, toks[:1]]), 8)
            _ = pfx.nbytes

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert len(pfx) == 16


# ---------------------------------------------------------------------------
# Handles and the legacy delivery shims.
# ---------------------------------------------------------------------------

def test_handle_lifecycle_and_legacy_results_dict():
    _, _, model = _pair("gspn")
    eng = _engine(model, max_len=32)
    h = eng.submit(Request(uid=9, prompt=np.arange(6), max_new_tokens=4))
    assert h.status == "queued" and not h.done and h.replica is None
    with pytest.raises(RuntimeError, match="queued"):
        h.result()
    eng.run()
    assert h.done and h.result().uid == 9 and len(h.result().tokens) == 4
    assert h.result().t_finish >= h.result().t_submit > 0.0
    assert h.result().cached_tokens == 0
    assert eng.results[9] is h.result()     # hookless: the results dict


def test_on_finish_shim_warns_once_and_delivers(monkeypatch):
    monkeypatch.setattr(engine_mod, "_on_finish_warned", False)
    _, _, model = _pair("gspn")
    got = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = _engine(model, max_len=32, on_finish=got.append)
        _engine(model, max_len=32, on_finish=lambda r: None)
        deprecations = [x for x in w
                        if issubclass(x.category, DeprecationWarning)
                        and "on_finish" in str(x.message)]
    assert len(deprecations) == 1
    h = eng.submit(Request(uid=1, prompt=np.arange(5), max_new_tokens=3))
    eng.run()
    assert [r.uid for r in got] == [1]
    assert not eng.results and h.result() is got[0]


def test_pending_chunks_and_drain():
    """``pending_chunks`` counts the in-flight prefill's remaining chunks
    and every waiting prompt's; ``drain`` hands back every unfinished
    request under its handle, reset to queued, and leaves a clean engine."""
    _, _, model = _pair("gspn")
    eng = _engine(model, batch_size=2)
    hs = [eng.submit(Request(uid=i, prompt=_prompt(n, i), max_new_tokens=4))
          for i, n in enumerate((30, 5, 17))]
    assert eng.pending_chunks == 4 + 1 + 3
    eng.tick()                            # admits uid 0, runs its chunk 1
    assert eng.pending_chunks == 3 + 1 + 3
    drained = eng.drain()
    assert [r.uid for r, _ in drained] == [0, 1, 2]
    assert [h for _, h in drained] == hs
    assert all(h.status == "queued" and not h.done for h in hs)
    assert eng.idle and eng.pending_chunks == 0 and eng.pool.n_free == 2
    for req, h in drained:                # re-submitted under the handles
        assert eng.submit(req, handle=h) is h
    eng.run()
    assert all(h.done for h in hs)


# ---------------------------------------------------------------------------
# The router against the reference's.
# ---------------------------------------------------------------------------

def _routers(n, policy, **kw):
    params, cj, model = _pair("gspn")
    jr = jrouter.Router([jengine.ServeEngine(params, cj, batch_size=2,
                                             max_len=64, prefill_chunk=CHUNK,
                                             seed=i) for i in range(n)],
                        policy=policy, **kw)
    tr = Router([_engine(model, seed=i) for i in range(n)], policy=policy,
                **kw)
    return jr, tr


LENGTHS = (40, 3, 9, 17, 5, 33, 2, 24, 8, 16)


def _inject_chunk_cost(seconds):
    """The same per-chunk prefill cost in both registries, so wall time
    cannot decide a placement."""
    for mod in (obs, jobs):
        mod.REGISTRY.reset()
        mod.histogram("serve_prefill_chunk_seconds").observe(seconds)


@pytest.mark.parametrize("policy", ["least_loaded", "ttft"])
@pytest.mark.parametrize("n", [2, 3])
def test_placement_equals_the_reference_router(policy, n):
    _inject_chunk_cost(0.01)
    jr, tr = _routers(n, policy, slo_ttft=0.05)
    got = [tr.submit(Request(uid=i, prompt=_prompt(m, i),
                             max_new_tokens=4)).replica
           for i, m in enumerate(LENGTHS)]
    want = [jr.submit(jengine.Request(uid=i, prompt=_prompt(m, i),
                                      max_new_tokens=4)).replica
            for i, m in enumerate(LENGTHS)]
    assert got == want
    assert len(set(got)) == n
    risk = obs.counter("router_slo_at_risk_total").value
    assert risk == jobs.counter("router_slo_at_risk_total").value
    assert (risk > 0) == (policy == "ttft")
    assert obs.histogram("router_predicted_ttft_seconds").count == \
        (len(LENGTHS) if policy == "ttft" else 0)


def test_ttft_policy_routes_around_queued_work():
    """A 48-token (6-chunk) prompt on replica 0: the next short prompts go
    to replica 1 until its work ahead catches up, where least_loaded would
    alternate."""
    _inject_chunk_cost(0.01)
    _, _, model = _pair("gspn")
    tr = Router([_engine(model, seed=i) for i in range(2)], policy="ttft")
    big = tr.submit(Request(uid=100, prompt=np.arange(48) % 512,
                            max_new_tokens=4))
    assert big.replica == 0
    small = [tr.submit(Request(uid=i, prompt=_prompt(8, i), max_new_tokens=4))
             for i in range(3)]
    assert [h.replica for h in small] == [1, 1, 1]
    _bounded(tr.run)
    assert all(h.done for h in small) and big.done


def test_slo_risk_is_counted_and_an_unknown_policy_rejected():
    _inject_chunk_cost(0.01)
    _, _, model = _pair("gspn")
    router = Router([_engine(model)], policy="ttft", slo_ttft=0.0)
    h = router.submit(Request(uid=1, prompt=np.arange(40) % 512,
                              max_new_tokens=2))
    assert obs.counter("router_slo_at_risk_total").value == 1
    _bounded(router.run)                  # at-risk admissions still serve
    assert h.done
    with pytest.raises(ValueError, match="unknown router policy"):
        Router([_engine(model)], policy="round_robin")
    with pytest.raises(ValueError, match="at least one engine"):
        Router([])
    assert set(POLICIES) == {"least_loaded", "ttft"}
    custom = Router([_engine(model), _engine(model)],
                    policy=lambda req, reps: (reps[-1], None))
    assert custom.submit(Request(uid=2, prompt=np.arange(4),
                                 max_new_tokens=1)).replica == 1


# ---------------------------------------------------------------------------
# Failure and threads.
# ---------------------------------------------------------------------------

def _single_engine_tokens(model, reqs):
    eng = _engine(model)
    for r in reqs:
        eng.submit(Request(uid=r.uid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens))
    return {u: r.tokens for u, r in eng.run().items()}


def _reqs(n, plen, max_new=5, seed=2):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 512, plen),
                    max_new_tokens=max_new) for i in range(n)]


def test_failed_replica_drains_to_survivor_same_handles():
    _, _, model = _pair("gspn")
    reqs = _reqs(6, plen=24)
    want = _single_engine_tokens(model, reqs)
    router = Router([_engine(model, seed=i) for i in range(2)])
    handles = [router.submit(r) for r in reqs]
    for _ in range(3):
        router.tick()
    assert any(h.replica == 0 for h in handles)
    assert router.fail_replica(0) > 0
    assert obs.gauge("router_replicas_alive").value == 1
    _bounded(router.run)
    assert all(h.done and h.replica == 1 for h in handles)
    assert {h.uid: h.result().tokens for h in handles} == want


def test_last_replica_failure_refuses_to_drop_work():
    _, _, model = _pair("gspn")
    router = Router([_engine(model)])
    router.submit(_reqs(1, plen=8)[0])
    with pytest.raises(RuntimeError, match="no survivors"):
        router.fail_replica(0)
    with pytest.raises(RuntimeError, match="no alive replicas"):
        router.submit(_reqs(1, plen=8, seed=3)[0])


def test_threaded_router_completes_under_drive():
    """Two replicas on worker threads, one shared model and prefix cache:
    every request finishes with the single engine's tokens."""
    _, _, model = _pair("gspn")
    reqs = _reqs(6, plen=20, max_new=4, seed=4)
    want = _single_engine_tokens(model, reqs)
    pfx = PrefixStateCache()
    router = Router([_engine(model, seed=i, prefix_cache=pfx)
                     for i in range(2)], threaded=True)
    router.start()
    try:
        _dt, handles = _bounded(
            lambda: drive(router, reqs, np.zeros(len(reqs))))
    finally:
        router.stop()
    assert len(handles) == 6 and all(h.done for h in handles)
    assert {h.uid: h.result().tokens for h in handles} == want
    assert {h.replica for h in handles} == {0, 1}


def test_worker_error_fails_the_replica_over_to_the_survivor():
    """An exception inside a worker's tick marks the replica dead; the
    router's next tick drains it to the survivor."""
    _, _, model = _pair("gspn")
    reqs = _reqs(4, plen=12, max_new=3, seed=6)
    want = _single_engine_tokens(model, reqs)
    router = Router([_engine(model, seed=i) for i in range(2)],
                    threaded=True)
    bad = router.replicas[0].engine

    def boom():
        raise RuntimeError("injected")

    bad.tick = boom
    handles = [router.submit(r) for r in reqs]
    router.start()
    try:
        _bounded(lambda: drive(router, [], []))
    finally:
        router.stop()
    assert not router.replicas[0].alive
    assert all(h.done and h.replica == 1 for h in handles)
    assert {h.uid: h.result().tokens for h in handles} == want


# ---------------------------------------------------------------------------
# Launchers and the example.
# ---------------------------------------------------------------------------

def test_serve_launcher_runs_the_tier(capsys):
    cuda_lib.clear_counts()
    launch_serve.main(["--arch", "qwen2-1.5b-gspn", "--reduced", "--device",
                       "cpu", "--requests", "4", "--prefill-chunk", "16",
                       "--max-len", "64", "--max-new", "3", "--replicas", "2",
                       "--router", "ttft", "--prefix-cache", "8",
                       "--slo-ttft", "0.5"])
    out = capsys.readouterr().out
    assert "router: 2 replicas, policy=ttft, slo_ttft=500 ms, prefix " \
           "cache 8 entries" in out
    assert "4 requests, 12 tokens" in out and "prefix-cached" in out
    assert "placement: [" in out and "admissions predicted past SLO" in out


def test_train_then_serve_from_its_checkpoint_with_a_tune_cache(
        tmp_path, capsys):
    from repro_torch.kernels import autotune
    tune = autotune.TuningCache()
    tune.store(autotune.ScanKey("cpu", 8, 2, 8, 4, "fwd"),
               {"source": "heuristic"})
    path = tune.save(tmp_path / "tune.json")
    try:
        launch_train.main(["--arch", "qwen2-1.5b-gspn", "--reduced",
                           "--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
                           "--ckpt-every", "2", "--tune-cache", str(path)])
        launch_serve.main(["--arch", "qwen2-1.5b-gspn", "--reduced",
                           "--device", "cpu", "--requests", "2",
                           "--max-len", "64", "--max-new", "2",
                           "--ckpt-dir", str(tmp_path / "ck"),
                           "--tune-cache", str(path)])
    finally:
        autotune.get_cache(reload=True)
    out = capsys.readouterr().out
    assert f"[train] tuning cache: 1 entries from {path}" in out
    assert f"[serve] tuning cache: 1 entries from {path}" in out
    assert "[serve] restored checkpoint step 2" in out
    assert "2 requests, 4 tokens" in out


def test_serve_launcher_still_refuses_seq_parallel(capsys):
    """``--seq-parallel N`` runs as N ranks started as torchrun starts
    them: without WORLD_SIZE = N it refuses, and so it does with
    replicas; ``--help`` documents it."""
    for extra in ([], ["--replicas", "2"]):
        with pytest.raises(SystemExit):
            launch_serve.main(["--arch", "qwen2-1.5b-gspn", "--device",
                               "cpu", "--seq-parallel", "2", *extra])
    with pytest.raises(SystemExit):
        launch_serve.main(["--help"])
    out = capsys.readouterr()
    assert "--seq-parallel SEQ_PARALLEL" in out.out
    assert "one process a rank" in out.err


def test_example_serves_a_shared_prefix_through_replicas(capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--requests", "4", "--rate", "0",
                    "--max-new", "3", "--prefill-chunk", "32",
                    "--prefix-cache", "4", "--replicas", "2"])
    assert sorted(res) == [0, 1, 2, 3]
    assert sum(r.cached_tokens for r in res.values()) >= 96
    out = capsys.readouterr().out
    assert "prompt tokens served from cached state" in out
    assert "placement: [2, 2]" in out
