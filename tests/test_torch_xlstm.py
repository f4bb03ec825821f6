"""The port's xLSTM family against the JAX reference package:
``models/xlstm.py`` (the mLSTM over ``chunked_gla`` with the ones column,
the sLSTM with the exact stabilised exponential gating), the ``mlstm``
and ``slstm`` block kinds and ``xlstm-1.3b``.

The mixers against ``apply_{mlstm,slstm}{,_prefill,_decode}`` under the
f32 policy and the default one (bf16 products); on ``xlstm-reduced``,
from ``lm_state_from_jax`` of parameters in the reference's pytree
(drawn as its ``init_lm`` draws them, the sLSTM's zero bias at random so
that it counts): ``apply_lm`` logits, ``lm_prefill`` and every cache leaf,
a decode chain, ``lm_loss`` and its gradients, one ``build_train_step``
step with the reference's decay mask; the full config on ``meta``; the
engine's one-shot prefill; the train launcher.

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
from repro.configs import xlstm_1_3b as jx
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import xlstm as jxl
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs import xlstm_1_3b as tx
from repro_torch.launch import train as ltrain
from repro_torch.models import layers, lm, xlstm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig, decays
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
# The mLSTM and sLSTM mixers.
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


def _perturbed(params, seed):
    """The sLSTM's zero bias drawn at random, so that it counts."""
    rng = np.random.default_rng(seed)
    if "b" in params:
        params = dict(params, b=jnp.asarray(
            rng.standard_normal(params["b"].shape) * 0.5, jnp.float32))
    return params


def _reference_mixer(apply, prefill, decode, params, x, s, cfg, policy):
    """The reference mixer's forward and prefill over x[:, :s] and its
    decode over each token after, as one program."""
    @_jit
    def run(params, x):
        fwd = apply(params, x[:, :s], cfg, policy)
        out, cache = prefill(params, x[:, :s], cfg, policy)
        pcache, steps = cache, []
        for t in range(s, x.shape[1]):
            y, cache = decode(params, x[:, t:t + 1], cfg, cache, policy)
            steps.append((y, cache))
        return fwd, out, pcache, steps

    return run(params, jnp.asarray(x))


def _mixer_against_jax(kind, policy, s):
    """Forward, prefill (output and every cache leaf) and three decode
    steps of the ``kind`` mixer against the reference's."""
    jpol, tpol = POLICIES[policy]
    if kind == "mlstm":
        jcfg = jxl.MLSTMConfig(dim=32, n_heads=4, chunk=8)
        tcfg = xlstm.MLSTMConfig(dim=32, n_heads=4, chunk=8)
        params = jxl.init_mlstm(jax.random.PRNGKey(1), jcfg)
        mix = xlstm.MLSTM(tcfg, tpol, generator=None, device="meta")
        fns = (jxl.apply_mlstm, jxl.apply_mlstm_prefill,
               jxl.apply_mlstm_decode)
    else:
        jcfg = jxl.SLSTMConfig(dim=32, n_heads=4)
        tcfg = xlstm.SLSTMConfig(dim=32, n_heads=4)
        params = _perturbed(jxl.init_slstm(jax.random.PRNGKey(1), jcfg), 1)
        mix = xlstm.SLSTM(tcfg, tpol, generator=None, device="meta")
        fns = (jxl.apply_slstm, jxl.apply_slstm_prefill,
               jxl.apply_slstm_decode)
    mix.load_state_dict(_mixer_state(params), assign=True)
    x = _rand(3, 2, s + 3, 32)
    jfwd, jout, jc, jsteps = _reference_mixer(*fns, params, x, s, jcfg, jpol)
    with torch.no_grad():
        tx_ = torch.from_numpy(x)
        _check(mix(tx_[:, :s]), jfwd, policy, "forward")
        out, cache = mix.prefill(tx_[:, :s])
        _check(out, jout, policy, "prefill")
        assert sorted(cache) == sorted(jc)
        for name in cache:
            assert cache[name].dtype == torch.float32, name
            _check(cache[name], jc[name], policy, f"prefill {name}")
        for t, (jout, jc) in zip(range(s, s + 3), jsteps):
            out, cache = mix.decode(tx_[:, t:t + 1], cache)
            _check(out, jout, policy, f"decode {t}")
            for name in cache:
                _check(cache[name], jc[name], policy, f"decode {t} {name}")
    return cache


@pytest.mark.parametrize("s", [20, 1])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_mlstm_matches_jax(policy, s):
    """20 tokens (chunks of 8 halve to 4) and a prompt of one token; the
    state is (B, H, hd, hd + 1), the normaliser in the last column."""
    cache = _mixer_against_jax("mlstm", policy, s)
    assert cache["state"].shape == (2, 4, 16, 17)


@pytest.mark.parametrize("s", [12, 1])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_slstm_matches_jax(policy, s):
    """The token loop's outputs and (h, c, n, m) after a prompt of 12
    tokens and of 1."""
    cache = _mixer_against_jax("slstm", policy, s)
    assert sorted(cache) == ["c", "h", "m", "n"]


def test_slstm_gradients_match_jax_and_stay_finite():
    """The stabiliser starts at -1e30, not -inf: the backward through
    exp(log_f + m_prev - m_t) is finite; every gradient, the recurrence's
    and the bias's included, within 1e-4 of its largest magnitude."""
    jcfg = jxl.SLSTMConfig(dim=32, n_heads=4)
    pol = POLICIES["f32"]
    params = _perturbed(jxl.init_slstm(jax.random.PRNGKey(2), jcfg), 2)
    x, gy = _rand(4, 2, 10, 32), _rand(5, 2, 10, 32)
    want = _jit(jax.grad(lambda p, x: jnp.sum(
        jxl.apply_slstm(p, x, jcfg, pol[0]) * gy), argnums=(0, 1)))(
            params, jnp.asarray(x))
    mix = xlstm.SLSTM(xlstm.SLSTMConfig(dim=32, n_heads=4), pol[1],
                      generator=None, device="meta")
    mix.load_state_dict(_mixer_state(params), assign=True)
    assert xlstm.M_INIT == -1e30
    tx_ = torch.from_numpy(x).requires_grad_()
    names = [n for n, _ in mix.named_parameters()]
    grads = torch.autograd.grad((mix(tx_) * torch.from_numpy(gy)).sum(),
                                [p for _, p in mix.named_parameters()]
                                + [tx_])
    for n, g in zip(names, grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, n
        _close(g, want[0][n], LOGITS_TOL, n)
    _close(grads[-1], want[1], LOGITS_TOL, "x")


# ---------------------------------------------------------------------------
# The LM: xlstm-reduced.
# ---------------------------------------------------------------------------

def _pair(precision=None, **kw):
    cj, ct = jx.reduced(), tx.reduced()
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
    """Parameters in the reference's pytree for xlstm-reduced (f32 under
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
    """The reduced xlstm on both sides under the f32 policy and its own
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
    """Every cache leaf in f32: the mLSTM's (units, 1, B, H, hd, hd + 1)
    matrix memory and the sLSTM's h, c, n and m."""
    precision, ct, out = lm_run
    got, want = out[what]
    assert set(got) == {"s0_mlstm", "s1_slstm"}
    assert got["s0_mlstm"]["state"].shape == (2, 1, 2, 4, 32, 33)
    for leaf, g, w in _cache_leaves(got, want):
        assert g.dtype == torch.float32, leaf
        _check(g, w, precision, f"{what} {leaf}")


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


def test_lm_loss_and_gradients_match_jax(grads_run):
    """f32: the loss within 1e-5 relative, every gradient (the sLSTM's
    recurrence and bias through its token loop included) within 1e-4 of
    its leaf's largest magnitude, finite and nonzero."""
    _, _, _, model, b, want, want_g, _, _ = grads_run
    loss, parts, grads = _loss_and_grads(model, b)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(parts["aux"]) == 0.0
    assert grads.keys() == want_g.keys()
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
    (the sLSTM's ``b``, stacked (n_units, n, 4D) there, and ``r``): loss
    1e-5 relative, grad_norm and lr 1e-6, each parameter within 1e-5 of
    its leaf's largest plus twice the step noise its two gradients predict
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
    assert got_decay["stages/s1_slstm/mix/b"]
    assert got_decay["stages/s1_slstm/mix/r"]
    assert not got_decay["stages/s0_mlstm/mix/norm/scale"]

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
# Parameters, configs, serving and the launcher.
# ---------------------------------------------------------------------------

def test_lm_state_from_jax_maps_every_leaf_once():
    """Every reference leaf lands in exactly one port parameter of the
    right shape, the sLSTM's ``b`` and ``r`` under the reference's names;
    a leaf left over raises ValueError."""
    params = jax.tree.map(np.asarray, _params())
    state = lm_state_from_jax(params)
    n_leaves = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(t.numel() for t in state.values()) == n_leaves
    model = lm.LM(_pair()[1], device="meta")
    assert {n: tuple(t.shape) for n, t in state.items()} == \
        {n: tuple(p.shape) for n, p in model.named_parameters()}
    np.testing.assert_array_equal(
        state["stages.s1_slstm.1.0.mix.r"].numpy(),
        params["stages"]["s1_slstm"]["mix"]["r"][1, 0])
    extra = jax.tree.map(lambda a: a, params)
    extra["stages"]["s0_mlstm"]["mix"]["extra"] = np.zeros((2, 1, 3))
    with pytest.raises(ValueError, match="extra"):
        lm_state_from_jax(extra)


def test_config_and_entry_match_the_reference():
    for make in ("full", "reduced"):
        mine, theirs = getattr(tx, make)(), getattr(jx, make)()
        for f in dataclasses.fields(mine):
            if f.name == "gspn_impl":
                continue
            want, got = getattr(theirs, f.name), getattr(mine, f.name)
            if isinstance(got, torch.dtype):
                want = getattr(torch, str(jnp.dtype(want)))
            assert got == want, (make, f.name)
    mine, theirs = tbase.get_arch("xlstm-1.3b"), jbase.get_arch("xlstm-1.3b")
    assert (mine.name, mine.family, mine.skip_shapes, mine.source) == \
        (theirs.name, theirs.family, theirs.skip_shapes, theirs.source)
    assert "xlstm-1.3b" in tbase.list_archs()
    for kind in ("mlstm", "slstm"):
        assert kind in lm.KINDS


def test_full_config_on_meta_has_the_reference_counts():
    """2 119 657 472 parameters (the reference's, from jax.eval_shape of
    init_lm), 48 blocks, the reference's count_active_params, and a
    mLSTM state of 4 x 1024 x 1025 f32 a layer (16.8 MB a sequence)."""
    cfg = tx.full()
    model = lm.LM(cfg, device="meta")
    assert lm.count_params(model) == 2_119_657_472
    assert cfg.layer_count() == 48 == jx.full().layer_count()
    assert lm.count_active_params(cfg) == jlm.count_active_params(jx.full())
    assert lm.count_active_params(tx.reduced()) == \
        jlm.count_active_params(jx.reduced())
    cache = lm.init_lm_cache(cfg, 1, 8, device="meta")
    assert cache["s0_mlstm"]["state"].shape == (6, 7, 1, 4, 1024, 1025)
    assert cache["s1_slstm"]["m"].shape == (6, 1, 1, 2048)


def test_engine_serves_xlstm_in_one_shot():
    """The reference's rule: neither mixer has a chunked prefill, so the
    engine asked for chunks prefills each prompt in one shot; its greedy
    tokens are those of ``lm_prefill`` and ``lm_decode_step`` alone."""
    cj, ct = _pair("f32")
    assert not lm.supports_chunked_prefill(ct)
    assert not jlm.supports_chunked_prefill(cj)
    _, model = _lm(cj, ct)
    prompts = [np.random.default_rng(i).integers(0, 512, n)
               for i, n in enumerate((13, 5, 9))]
    eng = ServeEngine(model, batch_size=2, max_len=MAX_LEN, prefill_chunk=8)
    assert eng.prefill_chunk == 0
    for i, pr in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=pr, max_new_tokens=4))
    got = {u: r.tokens for u, r in eng.run().items()}
    assert eng.metrics["prefills"] == 3
    for i, pr in enumerate(prompts):
        with torch.no_grad():
            logits, caches = lm.lm_prefill(
                model, torch.from_numpy(pr)[None].long(), MAX_LEN)
            toks = [int(logits[0, -1].argmax())]
            for _ in range(3):
                logits, caches = lm.lm_decode_step(
                    model, torch.tensor([[toks[-1]]]), caches)
                toks.append(int(logits[0, -1].argmax()))
        assert got[i] == toks, i


def test_train_launcher_trains_xlstm_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --arch xlstm-1.3b --reduced --device cpu --steps
    2`` under the bf16 preset: the f32 master copy and loss scaling over
    bf16 weights beside the sLSTM's f32 bias, finite losses, a
    checkpoint of the last step."""
    tr = ltrain.main(["--arch", "xlstm-1.3b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path), "--precision", "bf16"])
    out = capsys.readouterr().out
    assert "xlstm-reduced on cpu" in out and "recoveries=0" in out
    assert tr.step == 2 and all(map(np.isfinite, tr.history))
    params = dict(tr.model.named_parameters())
    assert params["stages.s1_slstm.0.0.mix.b"].dtype == torch.float32
    assert params["stages.s1_slstm.0.0.mix.r"].dtype == torch.bfloat16
    assert tr.ckpt.latest_step() == 2
