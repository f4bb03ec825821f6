"""The port's serving stack on the CPU: the state-cache pool, the
continuous-batching engine's scheduling (admission under a full batch,
sjf order, EOS against length retirement, per-request metrics and
streaming, clean slot reuse, chunked ≡ one-shot tokens), greedy tokens
equal to the JAX engine's from converted parameters at f32, the launcher
and the example.  On the ``reduced()`` config of ``qwen2-1.5b-gspn`` (2
layers, d 48, vocab 512, row width 8), or its f32 policy; and on the
reduced ``qwen2-1.5b`` (the attn kind, its KV cache in the pool).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import qwen2_1_5b as jqa
from repro.configs import qwen2_1_5b_gspn as jq
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch import obs
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen2_1_5b as tqa
from repro_torch.configs import qwen2_1_5b_gspn as tq
from repro_torch.kernels import cuda_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.serve.cache import StateCachePool, update_cache_slots
from repro_torch.serve.engine import (Request, ServeEngine, drive,
                                      sample_tokens)

pytestmark = pytest.mark.serve

LOGITS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return dataclasses.replace(tbase.with_precision(tq.reduced(), "f32"),
                               **kw)


@pytest.fixture(scope="module")
def model():
    return lm.LM(_cfg(), device="cpu",
                 generator=torch.Generator().manual_seed(0))


def _engine(model, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("prefill_chunk", 16)
    return ServeEngine(model, **kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n)


# ---------------------------------------------------------------------------
# State-cache pool.
# ---------------------------------------------------------------------------

def test_cache_pool_alloc_free_reuse():
    pool = StateCachePool(_cfg(), 2, 16, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {0, 1}
    assert pool.alloc() is None               # exhaustion, not an exception
    pool.free(a)
    assert pool.n_free == 1
    assert pool.alloc() == a                  # LIFO reuse of the freed page
    pool.free(b)
    with pytest.raises(ValueError):
        pool.free(b)                          # double free is a bug
    assert pool.n_used == 1


def test_cache_pool_commit_writes_only_its_slot():
    """On a gspn prelude (batch axis 1) and a repeated gspn unit (batch
    axis 2)."""
    cfg = _cfg(prelude=(("gspn", 1),), unit=(("gspn", 1),), n_units=2)
    pool = StateCachePool(cfg, 4, 16, device="cpu")
    for sub in pool.caches.values():
        for leaf in sub.values():
            leaf.fill_(7)
    new = lm.init_lm_cache(cfg, 1, 16, device="cpu")
    for sub in new.values():
        for leaf in sub.values():
            leaf.fill_(-3)
    slot = pool.alloc()
    pool.commit(slot, new)
    for key, sub in pool.caches.items():
        axis = 1 if key == "s0_gspn" else 2
        for leaf in sub.values():
            got = leaf.movedim(axis, 0).float()
            assert torch.all(got[slot] == -3)
            others = [s for s in range(4) if s != slot]
            assert torch.all(got[others] == 7)
    big = lm.init_lm_cache(cfg, 3, 16, device="cpu")
    assert update_cache_slots(cfg, big, new, [2]) is big


def test_state_pool_bf16_halves_bytes_and_stays_bf16(model):
    f32 = StateCachePool(model.cfg, 2, 16, device="cpu")
    bf16 = StateCachePool(model.cfg, 2, 16, device="cpu",
                          state_dtype=torch.bfloat16)
    assert f32.nbytes / bf16.nbytes >= 1.9
    eng = _engine(model, state_dtype=torch.bfloat16)
    eng.submit(Request(uid=0, prompt=_prompt(20), max_new_tokens=4))
    eng.run()
    for sub in eng.pool.caches.values():
        assert sub["prev_row"].dtype == torch.bfloat16
        assert sub["pos"].dtype == torch.int32


# ---------------------------------------------------------------------------
# Scheduling.
# ---------------------------------------------------------------------------

def test_admission_under_full_batch(model):
    """More requests than slots: the pool backpressures, everything still
    completes, and concurrency never exceeds the slot count."""
    eng = _engine(model)
    for i in range(5):
        eng.submit(Request(uid=i, prompt=(np.arange(12) + i) % 512,
                           max_new_tokens=4))
    res = eng.run()
    assert sorted(res) == list(range(5))
    assert eng.metrics["queue_depth_max"] >= 3
    assert eng.pool.n_free == 2 and eng.pool.n_used == 0


def test_sjf_admits_shortest_prompt_first(model):
    def order(sched):
        eng = _engine(model, batch_size=1, scheduler=sched)
        for i, n in enumerate([40, 6, 24]):
            eng.submit(Request(uid=i, prompt=np.arange(n) % 512,
                               max_new_tokens=3))
        eng.run()
        return list(eng.metrics["admission_order"])

    assert order("fcfs") == [0, 1, 2]
    assert order("sjf") == [1, 2, 0]
    with pytest.raises(ValueError):
        _engine(model, scheduler="lifo")


def test_retirement_eos_vs_max_tokens(model):
    prompt = np.arange(12) % 512
    ref = _engine(model, batch_size=1)
    ref.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    eos = ref.run()[0].tokens[2]      # the 3rd generated token as EOS

    eng = _engine(model, batch_size=1, eos_id=eos)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    eng.submit(Request(uid=1, prompt=prompt[:5], max_new_tokens=2))
    res = eng.run()
    assert res[0].finish_reason == "eos"
    assert res[0].tokens[-1] == eos and len(res[0].tokens) <= 3
    assert res[1].finish_reason == "length"
    assert len(res[1].tokens) == 2


def test_request_metrics_streaming_and_spans(model):
    """Per-request metrics, the streaming callback (every token, in
    order), the handles, the serve_* metrics and, with tracing on, the
    serve.* spans."""
    seen = {}
    eng = _engine(model, stream=lambda uid, tok: seen.setdefault(
        uid, []).append(tok))
    before = obs.snapshot()["counters"].get("serve_decode_steps_total", 0)
    obs.clear()
    obs.enable()
    try:
        handles = [eng.submit(Request(uid=i, prompt=np.arange(20) % 512,
                                      max_new_tokens=4)) for i in range(3)]
        assert [h.status for h in handles] == ["queued"] * 3
        with pytest.raises(RuntimeError):
            handles[0].result()
        res = eng.run()
    finally:
        obs.disable()
    assert all(h.done for h in handles)
    assert {u: r.tokens for u, r in res.items()} == seen
    for r in res.values():
        assert r.ttft > 0.0 and r.queue_delay >= 0.0
        assert r.prefill_chunks == 2          # 20 tokens in chunks of 16
        assert len(r.itl) == len(r.tokens) - 1
        assert r.finish_reason == "length"
    names = {s.name for s in obs.spans()}
    assert {"serve.tick", "serve.prefill_chunk",
            "serve.decode_step"} <= names
    after = obs.snapshot()["counters"]["serve_decode_steps_total"]
    assert after - before == eng.metrics["decode_steps"]
    assert eng.metrics["prefill_chunks"] == 6


def test_cache_pool_reuse_after_free_is_clean(model):
    """A request decoded in a reused slot matches a fresh engine: the
    chunked prefill overwrites the previous occupant's page."""
    prompt = np.arange(23) % 512
    fresh = _engine(model, batch_size=1)
    fresh.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    expect = fresh.run()[0].tokens

    eng = _engine(model, batch_size=1)
    eng.submit(Request(uid=0, prompt=np.arange(40) % 512, max_new_tokens=9))
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=5))
    assert eng.run()[1].tokens == expect


def test_engine_chunked_equals_one_shot_tokens(model):
    prompts = [_prompt(n, seed=n) for n in (40, 7, 24)]

    def run(chunk):
        eng = _engine(model, prefill_chunk=chunk)
        for i, pr in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=pr, max_new_tokens=5))
        res = eng.run()
        return {u: res[u].tokens for u in res}, eng

    one_shot, eng0 = run(0)
    chunked, eng = run(16)
    assert one_shot == chunked
    assert eng0.metrics["prefills"] == 3
    assert eng.metrics["prefill_chunks"] == 3 + 2


def test_chunk_snapping_capacity_and_unported_arguments(model):
    eng = _engine(model, batch_size=1, max_len=64, prefill_chunk=13)
    assert eng.prefill_chunk == 8            # snapped down to the fold width
    with pytest.raises(ValueError):          # rejected at submit
        eng.submit(Request(uid=0, prompt=np.arange(65) % 512,
                           max_new_tokens=1))
    with pytest.raises(ValueError):          # prompt + generated must fit
        eng.submit(Request(uid=0, prompt=np.arange(60) % 512,
                           max_new_tokens=10))
    with pytest.raises(NotImplementedError, match="item 4.1"):
        _engine(model, prefix_cache=object())
    with pytest.raises(NotImplementedError, match="item 6"):
        _engine(model, ctx=lm.Ctx())
    free_fold = lm.LM(_cfg(gspn_row_width=0), device="cpu")
    assert ServeEngine(free_fold, prefill_chunk=16).prefill_chunk == 0


def test_sample_tokens():
    logits = torch.tensor([[0.1, 3.0, -1.0, 2.9], [5.0, 0.0, 0.0, 0.0]])
    assert sample_tokens(logits, None, 0.0, 0).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    draws = {tuple(sample_tokens(logits, gen, 1.0, 2).tolist())
             for _ in range(50)}
    assert all(a in (1, 3) and b in (0, 1, 2, 3) for a, b in draws)
    assert len({a for a, _ in draws}) == 2     # top-k 2 keeps both


def test_drive_open_loop(model):
    eng = _engine(model)
    reqs = [Request(uid=i, prompt=_prompt(10, i), max_new_tokens=3)
            for i in range(3)]
    dt, handles = drive(eng, reqs, [0.0, 0.0, 0.01])
    assert dt > 0 and [h.uid for h in handles] == [0, 1, 2]
    assert all(len(h.result().tokens) == 3 for h in handles)


# ---------------------------------------------------------------------------
# Against the JAX engine.
# ---------------------------------------------------------------------------

def _greedy_against_jax(cj, ct, prefill_chunk):
    """The same requests through both engines from converted parameters:
    (port tokens, reference tokens).  Every generated position's top-two
    logit margin (the port's forward over prompt and tokens) must exceed
    10× the logits tolerance, else the test fails naming that margin: a
    near tie would make the comparison say nothing."""
    params = jlm.init_lm(jax.random.PRNGKey(0), cj)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    prompts = [_prompt(n, seed=n) for n in (27, 9, 16)]
    n_new = 6

    jeng = jengine.ServeEngine(params, cj, batch_size=2, max_len=64,
                               prefill_chunk=prefill_chunk)
    eng = _engine(model, max_len=64, prefill_chunk=prefill_chunk)
    for i, pr in enumerate(prompts):
        jeng.submit(jengine.Request(uid=i, prompt=pr, max_new_tokens=n_new))
        eng.submit(Request(uid=i, prompt=pr, max_new_tokens=n_new))
    want = {u: r.tokens for u, r in jeng.run().items()}
    got = {u: r.tokens for u, r in eng.run().items()}

    for i, pr in enumerate(prompts):
        seq = np.concatenate([pr, got[i][:-1]])
        with torch.no_grad():
            logits = lm.apply_lm(model, torch.from_numpy(seq)[None].long())
        steps = logits[0, len(pr) - 1:]
        tol = LOGITS_TOL * logits.abs().max().item()
        top2 = steps.topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        for k, m in enumerate(margins):
            assert m >= 10 * tol, (
                f"request {i} token {k}: top-two logit margin {m:.3e} is "
                f"under 10x the logits tolerance ({10 * tol:.3e})")
        assert steps.argmax(-1).tolist() == got[i]
    return got, want, eng


def test_greedy_tokens_equal_the_jax_engine():
    """qwen2-1.5b-gspn's reduced config at f32, chunked prefill: equal
    greedy tokens."""
    got, want, _ = _greedy_against_jax(
        jbase.with_precision(jq.reduced(), "f32"), _cfg(), 8)
    assert got == want


@pytest.mark.parametrize("chunk", [0, 8, 5])
def test_attention_lm_greedy_tokens_equal_the_jax_engine(chunk):
    """The reduced qwen2-1.5b (the attn kind, GQA groups of 3, qkv bias)
    at f32, one-shot (chunk 0) and chunked prefill (chunks of 8 and, as
    attention alone chunks anywhere, of 5): equal greedy tokens."""
    ct = tbase.with_precision(tqa.reduced(), "f32")
    got, want, eng = _greedy_against_jax(
        jbase.with_precision(jqa.reduced(), "f32"), ct, chunk)
    assert eng.prefill_chunk == chunk
    assert got == want


def _attn_model():
    return lm.LM(tbase.with_precision(tqa.reduced(), "f32"), device="cpu",
                 generator=torch.Generator().manual_seed(1))


def test_attention_slot_reuse_leaves_no_stale_kv():
    """A short request in the slot a long one held: its commit zeroes the
    page past its own prompt, and its tokens equal a fresh engine's."""
    model = _attn_model()
    prompt = _prompt(9, seed=3)
    fresh = _engine(model, batch_size=1, max_len=48)
    fresh.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    expect = fresh.run()[0].tokens

    eng = _engine(model, batch_size=1, max_len=48)
    eng.submit(Request(uid=0, prompt=_prompt(40, seed=4), max_new_tokens=8))
    eng.run()
    k = eng.pool.caches["s0_attn"]["k"]
    assert k[:, :, 0, 40:47].abs().sum() > 0       # the long request's K
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=1))
    eng.run()
    k = eng.pool.caches["s0_attn"]["k"]
    assert k[:, :, 0, 9:].abs().sum() == 0         # nothing stale past it
    assert eng.pool.caches["s0_attn"]["length"].tolist() == [[[9], [9]]]
    eng.submit(Request(uid=2, prompt=prompt, max_new_tokens=5))
    assert eng.run()[2].tokens == expect


def test_attention_pool_holds_a_kv_page_per_slot():
    """The pool's KV pages: at full width qwen2-1.5b keeps 28 layers × 2 ×
    2 kv heads × 128 × 2 bytes = 28 672 bytes a token a slot in bf16,
    472 MB for 4 slots of 4112 (sized on the meta device); the int32
    lengths pass through the bf16 narrowing."""
    full = tqa.full()
    pool = StateCachePool(full, 4, 4112, device="meta")
    assert pool.nbytes == 4 * 4112 * 28672 + 4 * 28 * 4
    small = StateCachePool(tbase.with_precision(tqa.reduced(), "f32"), 2, 8,
                           device="cpu", state_dtype=torch.bfloat16)
    sub = small.caches["s0_attn"]
    assert sub["k"].dtype == torch.bfloat16
    assert sub["length"].dtype == torch.int32
    assert ServeEngine(_attn_model(), prefill_chunk=13).prefill_chunk == 13


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def test_launcher_serves_on_the_cpu_when_asked(capsys):
    cuda_lib.clear_counts()
    launch_serve.main(["--arch", "qwen2-1.5b-gspn", "--reduced",
                       "--device", "cpu", "--requests", "3",
                       "--prefill-chunk", "16", "--max-len", "64",
                       "--max-new", "3", "--precision", "f32",
                       "--scheduler", "sjf", "--state-dtype", "bf16"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "2 one-shot prefills, 3 prefill chunks" in out
    assert not cuda_lib.launch_counts


def test_launcher_serves_the_attention_arch_with_no_code_of_its_own(capsys):
    """--arch qwen2-1.5b goes through get_arch, the engine and its KV
    pool like the gspn arch; no scan runs."""
    cuda_lib.clear_counts()
    launch_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--prefill-chunk", "16",
                       "--max-len", "64", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "qwen2-reduced on cpu: 74128 parameters" in out
    assert "3 requests, 9 tokens" in out
    assert "2 one-shot prefills, 3 prefill chunks" in out
    assert not cuda_lib.launch_counts and not cuda_lib.plain_calls


@pytest.mark.parametrize("flag", [
    ["--replicas", "2"], ["--router", "ttft"], ["--prefix-cache", "4"],
    ["--slo-ttft", "0.5"], ["--seq-parallel", "2"], ["--ckpt-dir", "x"],
    ["--tune-cache", "x.json"], ["--impl", "pallas"]])
def test_launcher_refuses_flags_of_later_slices(flag):
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "qwen2-1.5b-gspn", "--device", "cpu",
                           *flag])


def test_launcher_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2-1.5b-gspn", "--reduced"])


def test_example_serves_on_the_cpu():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--requests", "3", "--rate", "0",
                    "--max-new", "4", "--prefill-chunk", "32"])
    assert sorted(res) == [0, 1, 2]
    assert all(4 <= len(r.tokens) <= 4 for r in res.values())


def test_example_serves_the_attention_mixer_on_the_cpu(capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--requests", "3", "--rate", "0",
                    "--max-new", "4", "--prefill-chunk", "20",
                    "--mixer", "attn"])
    assert sorted(res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in res.values())
    assert "mixer=attn" in capsys.readouterr().out
