"""The port's attention (``repro_torch.models.attention``) and rope against
the JAX reference package: ``full_attention``, ``chunked_attention`` (its
forward and its hand-written two-sweep adjoint against ``jax.grad``
through the reference's ``custom_vjp``), ``chunk_prefill_attention``,
``decode_attention``, ``apply_rope`` and the ``Attention`` layer, from the
same numpy inputs; and the places where a port can drift without an
error: GQA grouping (query head h reads kv head h // G), where each path
applies the 1/√D scale, the halving of ``block_k``, the -1e30 mask, the
decode write past the cache's end; and the ``attention.*`` spans that a
profile reads attention's time from.

Tolerances: 1e-5 of the largest magnitude in f32, forward and gradients;
the layer under its config's own policy (bf16 products) 1e-2 in relative
L2.  Small shapes on the CPU.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as attn
from repro_torch.models import layers

TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=TOL, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _qkv(seed, b=2, sq=12, sk=12, hkv=2, g=3, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    ct = rng.standard_normal((b, sq, hkv * g, d)).astype(np.float32)
    return q, k, v, ct


def _grads_port(fn, q, k, v, ct):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(ct))
    return out, grads


def _grads_jax(fn, q, k, v, ct):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(ct))


# ---------------------------------------------------------------------------
# The four functions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,s", [(1, 12), (3, 12), (6, 12), (6, 9), (3, 5)])
def test_full_attention_matches_jax(g, s):
    """Forward and the gradients of q, k and v (plain autograd on both
    sides) at GQA groups of 1 (MHA), 3 and 6, causal from position 0 (the
    port's one use; the reference's defaults)."""
    q, k, v, ct = _qkv(g + s, sq=s, sk=s, g=g)
    out, grads = _grads_port(attn.full_attention, q, k, v, ct)
    jout, jgrads = _grads_jax(jattn.full_attention, q, k, v, ct)
    _close(out, jout, what="out")
    for name, a, b in zip("qkv", grads, jgrads):
        _close(a, b, what=f"d{name}")


@pytest.mark.parametrize("g,sk,block_k", [
    (1, 32, 8),                # four blocks
    (3, 32, 8),
    (6, 32, 8),
    (6, 40, 16),               # 16 does not divide 40: halves to 8
    (3, 24, 16),               # halves to 8: three blocks
    (1, 36, 8),                # halves to 4: nine blocks
])
def test_chunked_attention_matches_jax(g, sk, block_k):
    """The online-softmax forward and the two-sweep adjoint against the
    reference's custom_vjp (``jax.vjp`` runs its ``_flash_bwd``)."""
    q, k, v, ct = _qkv(10 + g, sq=sk, sk=sk, g=g)
    out, grads = _grads_port(
        lambda *a: attn.chunked_attention(*a, block_k=block_k), q, k, v, ct)
    jout, jgrads = _grads_jax(
        lambda *a: jattn.chunked_attention(*a, block_k=block_k), q, k, v, ct)
    _close(out, jout, what="out")
    for name, a, b in zip("qkv", grads, jgrads):
        _close(a, b, what=f"d{name}")
    # The port's own invariant: the blockwise path equals the dense one.
    dense, dgrads = _grads_port(attn.full_attention, q, k, v, ct)
    _close(out, dense)
    for a, b in zip(grads, dgrads):
        _close(a, b)


def test_chunked_backward_saves_only_q_k_v_and_lse():
    q, k, v, _ = _qkv(3, sq=16, sk=16)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attn.chunked_attention(*ts, block_k=4)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4
    for s, t in zip(saved, ts):
        assert s.data_ptr() == t.data_ptr()
    assert saved[3].shape == (2, 2, 3, 16)            # lse (B, Hkv, G, Sq)


@pytest.mark.parametrize("sk,block_k,blocks", [(1000, 512, 125), (40, 16, 5),
                                               (64, 512, 1), (96, 32, 3)])
def test_block_size_halves_until_it_divides_sk(monkeypatch, sk, block_k,
                                               blocks):
    """A 1000-token prompt runs 125 blocks of 8."""
    seen = []
    real = attn._fwd_blocks

    def spy(qh, kh, vh, bk):
        seen.append(bk)
        return real(qh, kh, vh, bk)

    monkeypatch.setattr(attn, "_fwd_blocks", spy)
    q, k, v, _ = _qkv(4, b=1, sq=sk, sk=sk, hkv=1, g=2, d=4)
    attn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                           block_k=block_k)
    assert seen == [sk // blocks]


@pytest.mark.parametrize("g", [1, 3, 6])
@pytest.mark.parametrize("off", [0, 5, 13])
def test_chunk_prefill_attention_matches_jax(g, off):
    """A chunk of 7 queries at offset ``off`` against a padded cache of 24
    positions (junk past off + 7, which the mask must hide)."""
    q, k, v, _ = _qkv(20 + g + off, sq=7, sk=24, g=g)
    got = attn.chunk_prefill_attention(*map(torch.from_numpy, (q, k, v)),
                                       off)
    want = jattn.chunk_prefill_attention(*map(jnp.asarray, (q, k, v)), off)
    _close(got, want)
    # Equal to the last 7 rows of causal attention over the valid prefix,
    # whatever the queries before the chunk.
    valid = off + 7
    before = np.random.default_rng(off).standard_normal(
        (q.shape[0], off) + q.shape[2:]).astype(np.float32)
    dense = attn.full_attention(
        torch.from_numpy(np.concatenate([before, q], 1)),
        torch.from_numpy(k[:, :valid]), torch.from_numpy(v[:, :valid]))
    _close(got, dense[:, off:])


@pytest.mark.parametrize("g", [1, 3, 6])
def test_decode_attention_matches_jax(g):
    """Per-sequence lengths, one of them the full cache; and a scalar
    length."""
    q, k, v, _ = _qkv(30 + g, b=3, sq=1, sk=16, g=g)
    lens = np.array([5, 16, 1], np.int32)
    got = attn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(lens))
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(lens))
    _close(got, want)
    got = attn.decode_attention(*map(torch.from_numpy, (q, k, v)), 9)
    _close(got, jattn.decode_attention(*map(jnp.asarray, (q, k, v)), 9))


# ---------------------------------------------------------------------------
# Where a port drifts without an error.
# ---------------------------------------------------------------------------

def test_gqa_query_head_h_reads_kv_head_h_div_g():
    """Each kv head's values are its own index: query head h must read kv
    head h // G (the reference's (Hkv, G) reshape), which a
    repeat_interleave of k and v reproduces and a tile (h % Hkv) does
    not."""
    b, s, hkv, g, d = 1, 4, 3, 2, 4
    q = torch.randn(b, s, hkv * g, d)
    k = torch.randn(b, s, hkv, d)
    v = torch.arange(hkv, dtype=torch.float32)[None, None, :, None].expand(
        b, s, hkv, d).contiguous()
    for fn in (attn.full_attention,
               lambda *a: attn.chunked_attention(*a, block_k=2)):
        out = fn(q, k, v)
        heads = out[0, :, :, 0].round()
        assert heads.tolist() == [[h // g for h in range(hkv * g)]] * s
    mha = attn.full_attention(q, k.repeat_interleave(g, 2),
                              v.repeat_interleave(g, 2))
    _close(attn.full_attention(q, k, v), mha)
    tiled = attn.full_attention(q, k.repeat(1, 1, g, 1), v.repeat(1, 1, g, 1))
    assert not torch.allclose(tiled, mha)


def test_scale_is_applied_where_each_path_applies_it():
    """full_attention divides the logits by √D after the product; the
    blockwise, chunk and decode paths divide q before it.  With integer
    q and k and D = 3 the products are exact in any order, the two
    placements round differently, and each path equals its own placement
    bit for bit."""
    rng = np.random.default_rng(0)
    d = 3
    q = torch.from_numpy(rng.integers(-4, 5, (1, 6, 2, d)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-4, 5, (1, 6, 2, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 6, 2, d)).astype(np.float32))
    after = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    before = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(d), k)
    assert not torch.equal(after, before)       # the placements differ

    def dense(logits, rows):
        p = torch.softmax(torch.where(rows, logits, attn.NEG_INF), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    causal = torch.ones(6, 6, dtype=torch.bool).tril()
    torch.testing.assert_close(attn.full_attention(q, k, v),
                               dense(after, causal), rtol=0, atol=0)
    torch.testing.assert_close(attn.chunk_prefill_attention(q, k, v, 0),
                               dense(before, causal), rtol=0, atol=0)
    last = torch.ones(1, 6, dtype=torch.bool)
    torch.testing.assert_close(attn.decode_attention(q[:, 5:], k, v, 6),
                               dense(before[:, :, 5:], last), rtol=0, atol=0)
    # The blockwise path's logits are those of q / √D.
    qh = attn._heads_q(q, 2) / math.sqrt(d)
    got = attn._block_logits(qh, attn._heads_kv(k), 0, torch.arange(6))
    torch.testing.assert_close(got[:, :, 0],
                               torch.where(causal, before, attn.NEG_INF),
                               rtol=0, atol=0)


def test_masked_logits_are_minus_1e30_not_minus_inf():
    """A decode row with no valid key (length 0) averages v over the whole
    cache, as the reference's -1e30 does; -inf would give NaN."""
    assert attn.NEG_INF == jattn.NEG_INF == -1e30
    q, k, v, _ = _qkv(7, b=1, sq=1, sk=5)
    got = attn.decode_attention(*map(torch.from_numpy, (q, k, v)), 0)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)), 0)
    assert torch.isfinite(got).all()
    _close(got, want)
    _close(got[0, 0, 0], v[0, :, 0].mean(0))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_frequencies_match_jax(theta):
    """f32 powers: within one ulp of the reference's at every config's
    head width (PyTorch's vectorised power and XLA's differ in the last
    bit at one of 64 frequencies of head_dim 128, theta 1e6, which moves
    the angle at position 4096 by ~1e-7 of a radian)."""
    for d in (8, 12, 16, 64, 128, 256):
        got = layers.rope_freqs(d, theta)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jlayers.rope_freqs(d, theta)),
                                   rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("d", [16, 128])
def test_apply_rope_matches_jax(theta, d):
    """Split halves rotated at positions up to 4096, in f32; and a bf16
    input (angles in f32, the result cast back)."""
    rng = np.random.default_rng(int(theta) % 97 + d)
    x = rng.standard_normal((2, 6, 3, d)).astype(np.float32)
    pos = np.stack([np.arange(6), [0, 1, 511, 2048, 4095, 4096]]).astype(
        np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want)
    got = layers.apply_rope(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(pos), theta)
    want = jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                              theta)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, want) <= BF16_TOL
    # Split halves, not interleaved pairs: position 1 at theta's first
    # frequency (1 rad) rotates element i with element i + d/2.
    one = torch.zeros(1, 2, 1, d)
    one[0, 1, 0, 0] = 1.0
    out = layers.apply_rope(one, torch.tensor([[0, 1]]), theta)[0, 1, 0]
    assert out[0].item() == pytest.approx(math.cos(1.0))
    assert out[d // 2].item() == pytest.approx(math.sin(1.0))
    assert out[1].item() == 0.0


# ---------------------------------------------------------------------------
# The layer.
# ---------------------------------------------------------------------------

def _layer(qkv_bias, policy, seed=0, dim=24, heads=6, kv_heads=2,
           block_k=512):
    jcfg = jattn.AttentionConfig(dim=dim, n_heads=heads, n_kv_heads=kv_heads,
                                 qkv_bias=qkv_bias, rope_theta=1e6,
                                 block_k=block_k)
    params = jattn.init_attention(jax.random.PRNGKey(seed), jcfg)
    if qkv_bias:            # the initialiser's biases are zero
        rng = np.random.default_rng(seed)
        params = {n: (jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
                      if n.startswith("b") else p) for n, p in params.items()}
    tcfg = attn.AttentionConfig(dim=dim, n_heads=heads, n_kv_heads=kv_heads,
                                qkv_bias=qkv_bias, rope_theta=1e6,
                                block_k=block_k)
    layer = attn.Attention(tcfg, policy, generator=None, device="meta")
    layer.load_state_dict({n: torch.from_numpy(np.array(p))
                           for n, p in params.items()}, assign=True)
    return jcfg, params, layer


POLICIES = {"f32": (layers.DTypePolicy(compute_dtype=torch.float32),
                    jlayers.DTypePolicy(compute_dtype=jnp.float32)),
            "bf16": (layers.DTypePolicy(), jlayers.DTypePolicy())}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("block_k", [512, 4])
def test_attention_layer_matches_jax(policy, qkv_bias, block_k):
    """``apply_attention`` with rope at positions arange(S) (dense, and
    blockwise at block_k 4), its input gradient, and five decode steps
    against ``apply_attention_decode`` from a cache of the first tokens:
    1e-5 under f32, 1e-2 relative L2 under bf16 products."""
    tpol, jpol = POLICIES[policy]
    jcfg, params, layer = _layer(qkv_bias, tpol)
    assert sorted(n for n, _ in layer.named_parameters()) == sorted(params)
    jcfg = dataclasses.replace(jcfg, block_k=block_k)
    layer.cfg = dataclasses.replace(layer.cfg, block_k=block_k)
    x = np.random.default_rng(1).standard_normal((2, 13, 24)).astype(
        np.float32)
    pos = np.tile(np.arange(13, dtype=np.int32), (2, 1))
    xt = torch.from_numpy(x).requires_grad_()
    got = layer(xt, torch.from_numpy(pos))
    (dx,) = torch.autograd.grad(got.sum(), xt)
    want, jvjp = jax.vjp(lambda a: jattn.apply_attention(
        params, a, jcfg, positions=jnp.asarray(pos), policy=jpol),
        jnp.asarray(x))
    (jdx,) = jvjp(jnp.ones_like(want))
    check = (lambda a, b, w: _close(a, b, what=w)) if policy == "f32" else \
        (lambda a, b, w: _rel_l2(a, b) <= BF16_TOL or pytest.fail(w))
    check(got, want, "forward")
    check(dx, jdx, "input gradient")

    cd = tpol.compute_dtype
    cache = attn.init_kv_cache(2, 16, layer.cfg, cd, device="cpu")
    jcache = jattn.init_kv_cache(2, 16, jcfg, jpol.compute_dtype)
    with torch.no_grad():
        q, k, v = layer.project_qkv(torch.from_numpy(x[:, :8]))
        _, k = layer.apply_positions(q, k, torch.from_numpy(pos[:, :8]))
    jk = jnp.asarray(_np(k)).astype(jpol.compute_dtype)
    jv = jnp.asarray(_np(v)).astype(jpol.compute_dtype)
    cache["k"][:, :8], cache["v"][:, :8] = k, v
    cache["length"][:] = torch.tensor([8, 6], dtype=torch.int32)
    jcache = {"k": jcache["k"].at[:, :8].set(jk),
              "v": jcache["v"].at[:, :8].set(jv),
              "length": jnp.asarray([8, 6], jnp.int32)}
    with torch.no_grad():
        for i in range(8, 13):
            tok = x[:, i:i + 1]
            y, cache = layer.decode(torch.from_numpy(tok), cache)
            jy, jcache = jattn.apply_attention_decode(
                params, jnp.asarray(tok), jcfg, jcache, policy=jpol)
            check(y, jy, f"decode {i}")
            for n in ("k", "v"):
                assert cache[n].dtype == cd
                check(cache[n], jcache[n], f"decode {i} cache {n}")
            assert cache["length"].tolist() == np.asarray(
                jcache["length"]).tolist()


def test_decode_write_past_the_end_writes_nothing():
    """The reference's one-hot blend drops a write at or past the cache's
    end (an engine's free slot decodes on); the port's index write does
    the same."""
    jcfg, params, layer = _layer(True, POLICIES["f32"][0])
    cache = attn.init_kv_cache(2, 4, layer.cfg, torch.float32, device="cpu")
    cache["k"].normal_()
    cache["v"].normal_()
    cache["length"][:] = torch.tensor([4, 2], dtype=torch.int32)
    x = np.random.default_rng(2).standard_normal((2, 1, 24)).astype(
        np.float32)
    with torch.no_grad():
        y, new = layer.decode(torch.from_numpy(x), cache)
    jcache = {n: jnp.asarray(_np(t)) if n != "length"
              else jnp.asarray(t.numpy()) for n, t in cache.items()}
    jy, jnew = jattn.apply_attention_decode(params, jnp.asarray(x), jcfg,
                                            jcache, policy=POLICIES["f32"][1])
    _close(y, jy)
    assert torch.equal(new["k"][0], cache["k"][0])      # slot 0: no write
    assert not torch.equal(new["k"][1, 2], cache["k"][1, 2])
    for n in ("k", "v"):
        _close(new[n], jnew[n])
    assert new["length"].tolist() == [5, 3]


def test_attention_config_is_the_reference_causal_self_attention():
    """The port's fields and defaults are the reference's, less the
    options with one value in the port (causal, blockwise, no M-RoPE)."""
    ref = {f.name: f.default for f in dataclasses.fields(jattn.AttentionConfig)}
    port = {f.name: f.default for f in dataclasses.fields(attn.AttentionConfig)}
    assert ref.pop("causal") is True and ref.pop("use_chunked") is True
    assert ref.pop("mrope_sections") is None
    assert port == ref


@pytest.mark.parametrize("path", ["blockwise", "dense", "chunk", "decode"])
def test_each_attention_path_enters_its_profiler_span(path):
    """With tracing on, each path's products run inside its
    ``attention.*`` ``record_function`` range (the blockwise backward in
    its own), so a profile's device time under the span is attention's;
    with tracing off no range is entered."""
    from torch.profiler import profile

    from repro_torch import obs

    q, k, v, ct = map(torch.from_numpy, _qkv(8, sq=8, sk=8))
    calls = {"blockwise": lambda *a: attn.chunked_attention(*a, block_k=4),
             "dense": attn.full_attention,
             "chunk": lambda *a: attn.chunk_prefill_attention(*a, 0),
             "decode": lambda q_, k_, v_: attn.decode_attention(
                 q_[:, :1], k_, v_, 8)}
    q.requires_grad_()

    def run():
        out = calls[path](q, k, v)
        if path == "blockwise":
            torch.autograd.grad(out, q, ct)

    obs.clear()
    obs.enable()
    try:
        with profile() as prof:
            run()
    finally:
        obs.disable()
    names = {"blockwise": ["attention.blockwise", "attention.blockwise_bwd"]
             }.get(path, [f"attention.{path}"])
    events = prof.events()
    for name in names:
        (span,) = [e for e in events if e.name == name]
        ops = [c.name for c in span.cpu_children]
        assert any(o in ("aten::matmul", "aten::einsum") for o in ops), ops
        assert len(obs.spans(name)) == 1
    with profile() as prof:
        run()
    assert not [e for e in prof.events() if e.name.startswith("attention.")]
