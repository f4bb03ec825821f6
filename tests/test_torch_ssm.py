"""The port's SSM family against the JAX reference package:
``models/ssm.py`` (``chunked_gla``, ``gla_decode_step``, the Mamba-2
mixer), the causal conv of ``models/layers.py``, the ``mamba`` block kind
with the weight-shared attention block, and ``zamba2-2.7b``.

On ``zamba2-reduced``, from ``lm_state_from_jax`` of parameters in the
reference's pytree (drawn as its ``init_lm`` draws them, the
zero-initialised biases and the unit skip at random so that they count):
``apply_lm`` logits, ``lm_prefill`` and every cache leaf, a decode chain,
``lm_loss`` and its gradients, one ``build_train_step`` step; the serve
engine's greedy tokens against the reference engine's; the three serving
repairs (the shared block's slot axis, the chunked-prefill rule, the
prefix cache's refusal); the full config on ``meta``; the serve launcher.

Tolerances: f32 1e-5 of the largest magnitude, logits and gradients 1e-4,
a loss 1e-5 relative, 1e-2 relative L2 under the bf16 policy.  On the
CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import zamba2_2_7b as jz
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.serve import engine as jengine
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs import zamba2_2_7b as tz
from repro_torch.launch import serve as lserve
from repro_torch.models import layers, lm, ssm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig, decays
from repro_torch.serve import cache as tcache
from repro_torch.serve.cache import PrefixStateCache
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import step as tstep

TOL = 1e-5
LOGITS_TOL = 1e-4
BF16_TOL = 1e-2
MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _check(got, want, precision, what, tol=TOL):
    if precision == "f32":
        _close(got, want, tol, what)
    else:
        assert _rel_l2(got, want) <= BF16_TOL, what


def _jit(fn):
    """``jax.jit`` of a reference function, compiled at XLA's backend
    optimisation level 0: the same program in under half the compile
    time of the default level, which is most of this file's time."""
    def run(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})(*args)
    return run


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# chunked_gla, gla_decode_step and the causal conv.
# ---------------------------------------------------------------------------

# (S, chunk, the log decay's scale): three chunks of 16; 24 tokens, where
# 16 halves to 8; and a strongly negative decay, whose exp(cum) underflows
# to 0 within a chunk.
GLA_CASES = {"s64_c16": (64, 16, 1.0), "s24_halves_to_8": (24, 16, 1.0),
             "strong_decay": (32, 16, 40.0)}


def _gla_inputs(s, scale, b=2, h=3, dk=4, dv=5, seed=0):
    return (_rand(seed, b, s, h, dk), _rand(seed + 1, b, s, h, dk),
            _rand(seed + 2, b, s, h, dv),
            -np.abs(_rand(seed + 3, b, s, h, scale=scale)))


@pytest.mark.parametrize("case", sorted(GLA_CASES))
def test_chunked_gla_matches_jax(case):
    """Output, final state and the gradients of q, k, v and the log decay
    against ``repro.models.ssm.chunked_gla`` (1e-5, gradients 1e-4), all
    finite."""
    s, chunk, scale = GLA_CASES[case]
    ins = _gla_inputs(s, scale)
    gy, gs = _rand(7, 2, s, 3, 5), _rand(8, 2, 3, 4, 5)

    @_jit
    def reference(ins, cts):
        out, vjp = jax.vjp(lambda *a: jssm.chunked_gla(*a, chunk=chunk),
                           *ins)
        return out, vjp(cts)

    (y, st), want_g = reference(tuple(map(jnp.asarray, ins)),
                                (jnp.asarray(gy), jnp.asarray(gs)))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    ty, tst = ssm.chunked_gla(*ts, chunk=chunk)
    _close(ty, y, TOL, "y")
    _close(tst, st, TOL, "state")
    grads = torch.autograd.grad(
        (ty * torch.from_numpy(gy)).sum() + (tst * torch.from_numpy(gs)).sum(),
        ts)
    for name, g, w in zip(("q", "k", "v", "log_decay"), grads, want_g):
        assert torch.isfinite(g).all(), name
        _close(g, w, LOGITS_TOL, name)
    assert ssm.gla_chunk_len(s, chunk) == (8 if s == 24 else chunk)


def test_chunked_gla_sums_segments_without_cancellation():
    """The one rounding the port changes on purpose.  Under Mamba-2's
    decays (a in 1..16 times a softplus dt) the reference's cum_i - cum_j
    in f32 loses |cum| * eps: with chunks of 256 its output sits 3.0e-5 of
    the largest magnitude from the f64 recurrence (8.9e-7 with chunks of
    16), the port's direct segment sums 1.1e-7 at both, so the port no
    longer depends on the chunk length; port and reference differ by no
    more than their two errors."""
    rng = np.random.default_rng(0)
    b, s, h, d = 1, 512, 4, 16
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32) / 4
            for _ in range(2))
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ld = -(rng.uniform(1, 16, (h,)) * np.log1p(np.exp(
        rng.standard_normal((b, s, h))))).astype(np.float32)
    state, ys = np.zeros((b, h, d, d)), []
    for t in range(s):
        state = state * np.exp(ld[:, t].astype(np.float64))[..., None, None] \
            + np.einsum("bhd,bhe->bhde", k[:, t].astype(np.float64),
                        v[:, t].astype(np.float64))
        ys.append(np.einsum("bhd,bhde->bhe", q[:, t].astype(np.float64),
                            state))
    exact = np.stack(ys, 1)

    def err(got):
        return np.abs(np.asarray(got, np.float64) - exact).max() \
            / np.abs(exact).max()

    port = {}
    for chunk in (256, 16):
        y, _ = _jit(lambda *a: jssm.chunked_gla(*a, chunk=chunk))(
            q, k, v, ld)
        ty, _ = ssm.chunked_gla(*map(torch.from_numpy, (q, k, v, ld)),
                                chunk=chunk)
        port[chunk] = ty.numpy()
        assert err(ty) < 2e-7, chunk
        assert np.abs(port[chunk] - np.asarray(y)).max() / \
            np.abs(exact).max() <= err(y) + err(ty)
        if chunk == 256:
            assert err(y) > 1e-5
        else:
            assert err(y) < 1e-6
    np.testing.assert_allclose(port[256], port[16], rtol=0,
                               atol=2e-7 * np.abs(exact).max())


def test_chunked_gla_equals_its_recurrence_and_decode_matches_jax():
    """A loop of ``gla_decode_step`` over the tokens gives chunked_gla's
    outputs and final state (1e-5), including 23 tokens, which run as 23
    chunks of one; one step against the reference's."""
    for s in (24, 23):
        q, k, v, ld = map(torch.from_numpy, _gla_inputs(s, 1.0, seed=3))
        y, st = ssm.chunked_gla(q, k, v, ld, chunk=8)
        state = torch.zeros(2, 3, 4, 5)
        ys = []
        for t in range(s):
            yt, state = ssm.gla_decode_step(state, q[:, t], k[:, t], v[:, t],
                                            ld[:, t])
            ys.append(yt)
        _close(torch.stack(ys, 1), y, TOL, f"y at {s}")
        _close(state, st, TOL, f"state at {s}")
    st0 = _rand(4, 2, 3, 4, 5)
    args = (st0, _rand(5, 2, 3, 4), _rand(6, 2, 3, 4), _rand(7, 2, 3, 5),
            -np.abs(_rand(8, 2, 3)))
    want = jssm.gla_decode_step(*map(jnp.asarray, args))
    got = ssm.gla_decode_step(*map(torch.from_numpy, args))
    for g, w, what in zip(got, want, ("y", "state")):
        _close(g, w, TOL, what)


def test_causal_conv1d_full_and_streaming():
    """The (k, 1, C) weight transposed to (C, 1, k): the full pass and a
    token-by-token stream against the reference's ``apply_causal_conv1d``
    (1e-5), the stream equal to the full pass bit for bit, and its state
    the last k - 1 raw inputs."""
    c, k, s = 6, 4, 9
    w, b = _rand(0, k, 1, c), _rand(1, c)
    x = _rand(2, 2, s, c)
    conv = layers.CausalConv1d(c, k, generator=None, device="meta")
    conv.load_state_dict({"w": torch.from_numpy(w.transpose(2, 1, 0).copy()),
                          "b": torch.from_numpy(b)}, assign=True)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want, _ = jlayers.apply_causal_conv1d(jp, jnp.asarray(x))
    with torch.no_grad():
        full, none = conv(torch.from_numpy(x))
        assert none is None
        _close(full, want, TOL, "full")
        state = torch.zeros(2, k - 1, c)
        jstate = jnp.zeros((2, k - 1, c))
        steps = []
        for t in range(s):
            xt = torch.from_numpy(x[:, t:t + 1])
            yt, state = conv(xt, state)
            jy, jstate = jlayers.apply_causal_conv1d(jp, jnp.asarray(xt),
                                                     jstate)
            _close(yt, jy, TOL, f"stream {t}")
            steps.append(yt)
        assert torch.equal(torch.cat(steps, 1), full)
        assert torch.equal(state, torch.from_numpy(x[:, s - k + 1:]))
        np.testing.assert_array_equal(_np(state), np.asarray(jstate))


# ---------------------------------------------------------------------------
# The Mamba-2 mixer.
# ---------------------------------------------------------------------------

POLICIES = {
    "f32": (jlayers.DTypePolicy(jnp.float32, jnp.float32, jnp.float32),
            layers.DTypePolicy(torch.float32, torch.float32, torch.float32)),
    "own": (jlayers.DTypePolicy(), layers.DTypePolicy()),
}


def _mixer_state(params):
    """The reference mixer's leaves in the port's names and layout."""
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        name = ".".join(str(p.key) for p in path)
        a = np.asarray(a)
        out[name] = torch.from_numpy(
            a.transpose(2, 1, 0).copy() if name == "conv.w" else a.copy())
    return out


def _perturbed(params, seed):
    """Zero biases and the unit skip drawn at random, so that they count."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = "/".join(str(p.key) for p in path[-2:])
        if name.endswith(("conv/b", "dt_bias", "mix/b", "bq", "bk", "bv")) \
                or name == "b":
            return jnp.asarray(rng.standard_normal(a.shape) * 0.5, a.dtype)
        if name.endswith("d_skip"):
            return jnp.asarray(1 + rng.standard_normal(a.shape) * 0.5,
                               a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _reference_mamba2(params, x, s, cfg, policy):
    """The reference's apply_mamba2 and apply_mamba2_prefill over x[:, :s]
    and apply_mamba2_decode over each token after, as one program."""
    @_jit
    def run(params, x):
        fwd = jssm.apply_mamba2(params, x[:, :s], cfg, policy)
        out, cache = jssm.apply_mamba2_prefill(params, x[:, :s], cfg, policy)
        pcache, steps = cache, []
        for t in range(s, x.shape[1]):
            y, cache = jssm.apply_mamba2_decode(params, x[:, t:t + 1], cfg,
                                                cache, policy)
            steps.append((y, cache))
        return fwd, out, pcache, steps

    return run(params, jnp.asarray(x))


@pytest.mark.parametrize("s", [20, 2])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_mamba2_matches_jax(policy, s):
    """Forward, prefill (output, conv tail, SSM state) and three decode
    steps against ``apply_mamba2``, ``apply_mamba2_prefill`` and
    ``apply_mamba2_decode``: 20 tokens (chunks of 8 halve to 4) and 2,
    fewer than the conv's k - 1 (the tail zero-padded)."""
    jpol, tpol = POLICIES[policy]
    jcfg = jssm.Mamba2Config(dim=32, d_state=8, head_dim=8, chunk=8)
    tcfg = ssm.Mamba2Config(dim=32, d_state=8, head_dim=8, chunk=8)
    params = _perturbed(jssm.init_mamba2(jax.random.PRNGKey(1), jcfg), 1)
    mix = ssm.Mamba2(tcfg, tpol, generator=None, device="meta")
    mix.load_state_dict(_mixer_state(params), assign=True)
    x = _rand(3, 2, s + 3, 32)
    jfwd, jout, jc, jsteps = _reference_mamba2(params, x, s, jcfg, jpol)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        _check(mix(tx[:, :s]), jfwd, policy, "forward")
        out, cache = mix.prefill(tx[:, :s])
        _check(out, jout, policy, "prefill")
        assert sorted(cache) == sorted(jc) == ["conv", "ssm"]
        for name in cache:
            assert cache[name].dtype == torch.float32, name
            _check(cache[name], jc[name], policy, f"prefill {name}")
        for t, (jout, jc) in zip(range(s, s + 3), jsteps):
            out, cache = mix.decode(tx[:, t:t + 1], cache)
            _check(out, jout, policy, f"decode {t}")
            for name in cache:
                _check(cache[name], jc[name], policy, f"decode {t} {name}")


# ---------------------------------------------------------------------------
# The LM: zamba2-reduced.
# ---------------------------------------------------------------------------

def _pair(precision=None, **kw):
    cj, ct = jz.reduced(), tz.reduced()
    if precision == "f32":
        cj = jbase.with_precision(cj, "f32")
        ct = tbase.with_precision(ct, "f32")
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _truncated_normal(rng, shape):
    """Standard normal truncated to [-2, 2], as ``dense_init`` and
    ``embed_init`` draw."""
    n = rng.standard_normal(shape)
    while (bad := np.abs(n) > 2).any():
        n[bad] = rng.standard_normal(int(bad.sum()))
    return n


def _draw(path, a, rng):
    """A value for a reference leaf drawn as its initialiser draws it
    (norm scales 1, ``a_log`` the log of 1..16 over the heads, dense and
    embedding weights truncated normal, the conv and the sLSTM's
    recurrence normal, each at its initialiser's scale), except that the
    zero biases and the unit skip are drawn at random so that they
    count."""
    name = "/".join(str(p.key) for p in path)
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "scale":
        v = np.ones(a.shape)
    elif leaf == "a_log":
        v = np.broadcast_to(np.log(np.linspace(1.0, 16.0, a.shape[-1])),
                            a.shape)
    elif leaf == "d_skip":
        v = 1 + 0.5 * rng.standard_normal(a.shape)
    elif leaf in ("b", "dt_bias"):
        v = 0.5 * rng.standard_normal(a.shape)
    elif name == "embed":
        v = 0.02 * _truncated_normal(rng, a.shape)
    elif name.endswith("conv/w"):
        v = rng.standard_normal(a.shape) / np.sqrt(a.shape[-3])
    elif leaf == "r":
        v = rng.standard_normal(a.shape) / np.sqrt(a.shape[-1])
    else:                                   # a dense (d_in, d_out) weight
        v = _truncated_normal(rng, a.shape) / np.sqrt(a.shape[-2])
    return jnp.asarray(v, a.dtype)


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    """Parameters in the reference's pytree for zamba2-reduced (f32 under
    both policies the tests use), drawn with numpy into the shapes of
    ``jax.eval_shape`` of ``init_lm``, which compiles nothing."""
    cj = _pair("f32")[0]
    assert cj.param_dtype == _pair()[0].param_dtype == jnp.float32
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jlm.init_lm(k, cj),
                            jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(
        lambda p, a: _draw(p, a, rng), shapes)


def _lm(cj, ct, seed=0):
    params = _params(seed)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, model


def _tokens(seed, batch, length, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int32)


def _reference_lm(cj, params, toks, decode_steps):
    """The reference's apply_lm, lm_prefill and a greedy decode chain from
    the prefill, compiled as one program: (logits, prefill logits, prefill
    caches, decode logits, decode caches, the decode steps' input
    tokens)."""
    @_jit
    def run(params, toks):
        logits = jlm.apply_lm(params, cj, toks)[0]
        plogits, caches, _ = jlm.lm_prefill(params, cj, toks, MAX_LEN)
        tok = jnp.argmax(plogits[:, -1:].astype(jnp.float32), -1)

        def step(carry, _):
            tok, caches = carry
            lg, caches = jlm.lm_decode_step(params, cj, tok, caches)
            nxt = jnp.argmax(lg.astype(jnp.float32), -1).astype(jnp.int32)
            return (nxt, caches), (lg[:, 0], tok[:, 0])

        (_, dcaches), (steps, fed) = jax.lax.scan(
            step, (tok.astype(jnp.int32), caches), None, length=decode_steps)
        return (logits, plogits, caches, jnp.moveaxis(steps, 0, 1), dcaches,
                jnp.moveaxis(fed, 0, 1))

    return run(params, jnp.asarray(toks))


def _both_sides(cj, ct, toks, decode_steps=3):
    """apply_lm, lm_prefill and a decode chain on both sides: {what:
    (port, reference)}."""
    params, model = _lm(cj, ct)
    (jlogits, jplogits, jpcaches, jsteps, jcaches,
     fed) = _reference_lm(cj, params, toks, decode_steps)
    t = torch.from_numpy(toks).long()
    out = {"apply_lm": (lm.apply_lm(model, t), jlogits)}
    logits, caches = lm.lm_prefill(model, t, MAX_LEN)
    out["lm_prefill"] = (logits, jplogits)
    out["lm_prefill caches"] = (caches, jpcaches)
    fed = torch.from_numpy(np.array(fed)).long()
    steps = []
    for i in range(decode_steps):
        lg, caches = lm.lm_decode_step(model, fed[:, i:i + 1], caches)
        steps.append(lg)
    out["lm_decode_step"] = (torch.cat(steps, 1), jsteps)
    out["lm_decode_step caches"] = (caches, jcaches)
    return out


def _cache_leaves(got, want):
    """(name, port leaf, reference leaf) of every cache leaf; the
    reference nests an attn cache's leaves under "attn"."""
    assert sorted(got) == sorted(want)
    for key in want:
        ref = want[key]["attn"] if key.endswith("attn") else want[key]
        assert sorted(got[key]) == sorted(ref), key
        for name in ref:
            yield f"{key}/{name}", got[key][name], ref[name]


@pytest.fixture(scope="module")
def lm_runs():
    """The reduced zamba2 on both sides under the f32 policy and its own
    (bf16 products over f32 parameters), 2 x 18 tokens: {precision: (ct,
    {what: (port, reference)})}."""
    runs = {}
    for precision in ("f32", "own"):
        cj, ct = _pair(precision)
        with torch.no_grad():
            runs[precision] = ct, _both_sides(cj, ct, _tokens(0, 2, 18))
    return runs


@pytest.fixture(params=["f32", "own"])
def lm_run(request, lm_runs):
    return (request.param, *lm_runs[request.param])


def test_bf16_logits_are_as_far_from_f32_as_the_references(lm_runs):
    """What the 1e-2 relative-L2 bar measures under the config's own
    policy: the port's and the reference's bf16 logits each sit about 2%
    from the f32 logits (relative L2; 0.9% apart), and the port's distance
    is the reference's within 5%.  Across parameter draws the two bf16
    paths stay 0.8-0.95% apart on the forward, and the decode chain,
    which compounds the caches' rounding, 0.8-1.3%."""
    truth = lm_runs["f32"][1]
    out = lm_runs["own"][1]
    for what in ("apply_lm", "lm_prefill"):
        port, ref = out[what]
        mine, theirs = _rel_l2(port, truth[what][1]), \
            _rel_l2(ref, truth[what][1])
        assert 0.005 < theirs < 0.05, (what, theirs)
        assert mine <= 1.05 * theirs, (what, mine, theirs)


@pytest.mark.parametrize("what", ["apply_lm", "lm_prefill",
                                  "lm_decode_step"])
def test_lm_logits_match_jax(lm_run, what):
    """Logits 1e-4 of the largest magnitude in f32, 1e-2 relative L2
    under the config's own policy."""
    precision, ct, out = lm_run
    got, want = out[what]
    assert got.shape[-1] == 512 and got.dtype == ct.compute_dtype
    _check(got, want, precision, what, LOGITS_TOL)


@pytest.mark.parametrize("what", ["lm_prefill caches",
                                  "lm_decode_step caches"])
def test_lm_cache_leaves_match_jax(lm_run, what):
    """Every cache leaf, the shared block's KV caches (one per
    application, here two) included: f32 1e-5, 1e-2 relative L2 under
    bf16; the conv
    tail and SSM state in f32, the KV cache in the compute dtype."""
    precision, ct, out = lm_run
    got, want = out[what]
    assert set(got) == {"s0_mamba", "shared_attn"}
    assert got["shared_attn"]["k"].shape[:2] == (ct.n_units, 2)
    for leaf, g, w in _cache_leaves(got, want):
        if leaf.endswith("length"):
            assert g.tolist() == np.asarray(w).tolist(), leaf
            continue
        assert g.dtype == (ct.compute_dtype if "shared_attn" in leaf
                           else torch.float32), leaf
        _check(g, w, precision, f"{what} {leaf}")


def test_lm_walk_applies_the_shared_block_after_every_unit():
    """One ``shared_attn`` module (one weight set in the state dict), walked
    as ("shared_attn", (u,)) after unit u's stages; 6 blocks applied."""
    _, ct = _pair()
    model = lm.LM(ct, device="meta")
    walk = [(key, idx) for key, idx, _ in model.walk()]
    assert walk == [("s0_mamba", (0, 0)), ("s0_mamba", (0, 1)),
                    ("shared_attn", (0,)), ("s0_mamba", (1, 0)),
                    ("s0_mamba", (1, 1)), ("shared_attn", (1,))]
    assert ct.layer_count() == len(walk) == _pair()[0].layer_count()
    blocks = [b for key, _, b in model.walk() if key == "shared_attn"]
    assert blocks[0] is blocks[1] is model.shared_attn
    names = [n for n, _ in model.named_parameters() if "shared_attn" in n]
    assert len(names) == 9 and all(n.startswith("shared_attn.")
                                   for n in names)
    assert not any("ln2" in n or "ffn" in n
                   for n, _ in model.named_parameters()
                   if n.startswith("stages."))


def _batch(seed, n=2, seq=16):
    toks = _tokens(seed, n, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _loss_and_grads(model, batch):
    loss, parts = lm.lm_loss(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), parts, {n: g for (n, _), g in zip(named, grads)}


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def grads_run():
    """f32: the reference's loss and gradients, and one step of its
    ``build_train_step`` from the same parameters and batch, compiled as
    one program."""
    cj, ct = _pair("f32")
    params, model = _lm(cj, ct)
    b = _batch(2)
    step = jstep.build_train_step(cj, jadamw.AdamWConfig(**OPT))

    @_jit
    def reference(params, jb):
        loss_grads = jax.value_and_grad(
            lambda p: jlm.lm_loss(p, cj, jb)[0])(params)
        state = {"params": params,
                 "opt": jadamw.adamw_init(jadamw.AdamWConfig(**OPT), params)}
        return loss_grads, step(state, jb)

    (want, want_g), (jstate, jmetrics) = reference(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    return (cj, ct, params, model, b, want,
            lm_state_from_jax(jax.tree.map(np.asarray, want_g)),
            jstate, jmetrics)


@pytest.mark.parametrize("remat", ["none", "unit"])
def test_lm_loss_and_gradients_match_jax(grads_run, remat):
    """f32: the loss within 1e-5 relative, every gradient within 1e-4 of
    its leaf's largest magnitude, finite and nonzero, the shared block's
    (the sum over its applications) included; under remat "unit" each
    block, each application of the shared one too, runs again in the
    backward with the same result."""
    _, ct, _, model, b, want, want_g, _, _ = grads_run
    model.cfg = dataclasses.replace(ct, remat=remat)
    try:
        loss, parts, grads = _loss_and_grads(model, b)
    finally:
        model.cfg = ct
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(parts["aux"]) == 0.0
    assert grads.keys() == want_g.keys()
    assert any(n.startswith("shared_attn.") for n in grads)
    for n, w in want_g.items():
        assert torch.isfinite(grads[n]).all() and grads[n].abs().max() > 0, n
        _close(grads[n], w, LOGITS_TOL, n)


def _reference_path(name):
    """The reference's pytree path of a port parameter: the block indices
    after a stage key are its stacking axes."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _first_step_direction(g, norm, cfg):
    g = g.astype(np.float64) * min(cfg.grad_clip / float(norm), 1.0)
    return g / (np.abs(g) + cfg.eps)


def test_train_step_matches_jax(grads_run):
    """One ``build_train_step`` step against the reference's, AdamW
    decaying exactly the leaves the reference's mask and rank rule decay
    (``conv.b`` among them, stacked (n_units, n, C) there): loss 1e-5
    relative, grad_norm and lr 1e-6, each parameter within 1e-5 of its
    leaf's largest plus twice the step noise its two gradients predict
    (tests/test_torch_lm_attn.py)."""
    cj, ct, params, _, b, _, gj, jstate, want = grads_run
    _, model = _lm(cj, ct)
    want_decay = {
        "/".join(str(p.key) for p in path):
            jadamw._decay_mask(path) and a.ndim >= 2
        for path, a in jax.tree_util.tree_leaves_with_path(params)}
    got_decay = {_reference_path(n): decays(n, p)
                 for n, p in model.named_parameters()}
    assert got_decay == want_decay
    assert got_decay["stages/s0_mamba/mix/conv/b"]
    assert not got_decay["stages/s0_mamba/mix/dt_bias"]

    ocfg = AdamWConfig(**OPT)
    gt = _loss_and_grads(model, b)[2]
    state = tstep.init_train_state(model, ocfg)
    state, got = tstep.build_train_step(model, ocfg)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-6), ("lr", 1e-6)):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol,
                                   err_msg=k)
    assert got["step"] == int(want["step"]) == 1
    lr = float(want["lr"])
    for n, w in lm_state_from_jax(jax.tree.map(
            np.asarray, jstate["params"])).items():
        w = _np(w)
        noise = lr * np.abs(
            _first_step_direction(_np(gt[n]), got["grad_norm"], ocfg)
            - _first_step_direction(_np(gj[n]), want["grad_norm"], ocfg))
        diff = np.abs(_np(state["params"][n]) - w)
        assert (diff <= 1e-5 * np.abs(w).max() + 2 * noise).all(), n


# ---------------------------------------------------------------------------
# Parameters, configs and the registry.
# ---------------------------------------------------------------------------

def test_lm_state_from_jax_maps_every_leaf_once():
    """Every reference leaf, ``shared_attn`` included, lands in exactly one
    port parameter of the right shape (the conv weight transposed); a
    missing leaf raises KeyError and a leaf left over ValueError."""
    params = jax.tree.map(np.asarray, _params())
    state = lm_state_from_jax(params)
    n_leaves = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(t.numel() for t in state.values()) == n_leaves
    model = lm.LM(_pair()[1], device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(t.shape) for n, t in state.items()} == shapes
    conv = params["stages"]["s0_mamba"]["mix"]["conv"]["w"]
    np.testing.assert_array_equal(
        state["stages.s0_mamba.1.0.mix.conv.w"].numpy(),
        conv[1, 0].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["shared_attn.attn.wq"].numpy(),
                                  params["shared_attn"]["attn"]["wq"])
    missing = jax.tree.map(lambda a: a, params)
    del missing["shared_attn"]["ffn"]["gate"]
    with pytest.raises(KeyError, match="shared_attn/ffn/gate"):
        lm_state_from_jax(missing)
    extra = jax.tree.map(lambda a: a, params)
    extra["stages"]["s0_mamba"]["mix"]["extra"] = conv
    with pytest.raises(ValueError, match="extra"):
        lm_state_from_jax(extra)


def test_config_and_entry_match_the_reference():
    for make in ("full", "reduced"):
        mine, theirs = getattr(tz, make)(), getattr(jz, make)()
        for f in dataclasses.fields(mine):
            if f.name == "gspn_impl":
                continue
            want, got = getattr(theirs, f.name), getattr(mine, f.name)
            if isinstance(got, torch.dtype):
                want = getattr(torch, str(jnp.dtype(want)))
            assert got == want, (make, f.name)
    mine, theirs = tbase.get_arch("zamba2-2.7b"), jbase.get_arch("zamba2-2.7b")
    assert (mine.name, mine.family, mine.skip_shapes, mine.source) == \
        (theirs.name, theirs.family, theirs.skip_shapes, theirs.source)
    assert "zamba2-2.7b" in tbase.list_archs()
    assert "mamba" in lm.KINDS


def test_full_config_on_meta_has_the_reference_counts():
    """2 422 670 240 parameters (the reference's, from jax.eval_shape of
    init_lm), 63 blocks applied (54 mamba + 9 of the shared block), and
    the reference's count_active_params."""
    cfg = tz.full()
    model = lm.LM(cfg, device="meta")
    assert lm.count_params(model) == 2_422_670_240
    assert cfg.layer_count() == 63 == jz.full().layer_count()
    assert lm.count_active_params(cfg) == jlm.count_active_params(jz.full())
    assert lm.count_active_params(tz.reduced()) == \
        jlm.count_active_params(jz.reduced())


# ---------------------------------------------------------------------------
# Serving: the engine, the repairs, the launcher.
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_equal_the_jax_engine():
    """zamba2-reduced at f32, 2 slots, asked for chunks of 8: both engines
    prefill in one shot, and their greedy tokens are equal.  Every
    generated position's top-two logit margin (the port's forward over
    prompt and tokens) exceeds 10x the logits tolerance."""
    cj, ct = _pair("f32")
    params, model = _lm(cj, ct)
    prompts = [np.random.default_rng(i).integers(0, 512, 11)
               for i in range(3)]
    jeng = jengine.ServeEngine(params, cj, batch_size=2, max_len=MAX_LEN,
                               prefill_chunk=8)
    eng = ServeEngine(model, batch_size=2, max_len=MAX_LEN, prefill_chunk=8)
    assert jeng.prefill_chunk == eng.prefill_chunk == 0
    for i, pr in enumerate(prompts):
        jeng.submit(jengine.Request(uid=i, prompt=pr, max_new_tokens=5))
        eng.submit(Request(uid=i, prompt=pr, max_new_tokens=5))
    want = {u: r.tokens for u, r in jeng.run().items()}
    got = {u: r.tokens for u, r in eng.run().items()}
    assert eng.metrics["prefills"] == 3 and eng.metrics["prefill_chunks"] == 0
    for i, pr in enumerate(prompts):
        seq = np.concatenate([pr, got[i][:-1]])
        with torch.no_grad():
            logits = lm.apply_lm(model, torch.from_numpy(seq)[None].long())
        steps = logits[0, len(pr) - 1:]
        top2 = steps.topk(2, dim=-1).values
        tol = LOGITS_TOL * logits.abs().max().item()
        assert ((top2[:, 0] - top2[:, 1]) >= 10 * tol).all(), i
        assert steps.argmax(-1).tolist() == got[i]
    assert got == want


def test_shared_attn_cache_scatters_along_its_batch_axis():
    """The shared block's caches stack only (n_units,) before the batch,
    so a slot's rows sit on axis 1 there (axis 2 in a unit stage), as the
    reference's ``update_cache_slots`` has it: a committed batch-1 cache
    lands in its slot of every leaf and nowhere else."""
    _, ct = _pair("f32")
    big = lm.init_lm_cache(ct, 3, MAX_LEN, device="cpu")
    one = lm.init_lm_cache(ct, 1, MAX_LEN, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for sub in list(big.values()) + list(one.values()):
        for v in sub.values():
            v.copy_(torch.randint(1, 9, v.shape, generator=gen).to(v.dtype))
    before = {k: {n: v.clone() for n, v in sub.items()}
              for k, sub in big.items()}
    got = tcache.update_cache_slots(ct, big, one, [1])
    assert got is big
    for key, sub in got.items():
        axis = 1 if key == "shared_attn" else 2
        for name, v in sub.items():
            v, old, new = (t.movedim(axis, 0) for t in
                           (v, before[key][name], one[key][name]))
            assert torch.equal(v[1], new[0]), (key, name)
            assert torch.equal(v[0], old[0]) and torch.equal(v[2], old[2])
    assert got["shared_attn"]["k"].shape[:2] == (ct.n_units, 3)


def test_recurrent_kinds_prefill_in_one_shot():
    """The reference's rule: chunked prefill only when every kind, the
    shared block's attn included, has a chunk path; mamba has none, so
    zamba2 prefills in one shot (a gspn unit with a mamba stage too), and
    ``lm_prefill_chunk`` refuses it."""
    cj, ct = _pair()
    assert not lm.supports_chunked_prefill(ct)
    assert not jlm.supports_chunked_prefill(cj)
    mixed = dataclasses.replace(ct, unit=(("gspn", 1), ("mamba", 1)),
                                shared_attn=False)
    assert not lm.supports_chunked_prefill(mixed)
    assert lm.supports_chunked_prefill(
        dataclasses.replace(mixed, unit=(("gspn", 1),)))
    assert lm.supports_chunked_prefill(
        dataclasses.replace(ct, unit=(("attn", 1),)))
    model = lm.LM(ct, device="cpu")
    with pytest.raises(ValueError, match="mamba kind has no chunked"):
        lm.lm_prefill_chunk(model, torch.zeros((1, 4), dtype=torch.long),
                            lm.init_lm_cache(ct, 1, 8, device="cpu"), 0)


def test_prefix_cache_is_refused_without_chunked_prefill(capsys):
    """A prefix cache stores chunk-boundary states: an engine that
    prefills in one shot (zamba2, or any model at prefill_chunk 0) refuses
    one at construction, and the serve launcher refuses --prefix-cache
    for zamba2 and without --prefill-chunk."""
    _, ct = _pair()
    model = lm.LM(ct, device="cpu")
    with pytest.raises(ValueError, match="prefills in one shot"):
        ServeEngine(model, prefill_chunk=16, prefix_cache=PrefixStateCache())
    assert ServeEngine(model, prefill_chunk=16).prefill_chunk == 0
    for argv in (["--arch", "zamba2-2.7b", "--reduced", "--prefill-chunk",
                  "16", "--prefix-cache", "4"],
                 ["--arch", "qwen2-1.5b", "--reduced", "--prefix-cache",
                  "4"]):
        with pytest.raises(SystemExit):
            lserve.main(argv + ["--device", "cpu"])
        assert "--prefix-cache needs chunked prefill" in \
            capsys.readouterr().err


def test_serve_launcher_serves_zamba2_on_the_cpu(capsys):
    """``launch/serve.py --arch zamba2-2.7b --reduced --device cpu``: every
    request finishes with its tokens through one-shot prefills."""
    results = lserve.main(["--arch", "zamba2-2.7b", "--reduced", "--device",
                           "cpu", "--requests", "3", "--max-new", "3",
                           "--prefill-chunk", "16", "--max-len", "48"])
    out = capsys.readouterr().out
    assert [len(r.tokens) for r in results] == [3, 3, 3]
    assert "prefill chunk 0" in out and "3 one-shot prefills" in out
