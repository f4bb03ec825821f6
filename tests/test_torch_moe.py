"""The port's MoE family against the JAX reference package:
``models/moe.py`` (the router's hand VJP, ``route`` with the reference's
order among tied probabilities, the capacity, the dispatch and combine,
the expert SwiGLU, the shared expert), the ``attn_moe`` block kind with
its aux loss, ``kimi-k2-1t-a32b`` and ``grok-1-314b``.

The layer against ``repro.models.moe.apply_moe`` under the f32 and the
bf16 policy, with and without the shared expert and with a capacity
factor that drops slots; on ``kimi-reduced`` and ``grok-reduced``, from
``lm_state_from_jax`` of parameters in the reference's pytree:
``apply_lm`` logits, ``lm_prefill``, a chunk chain and a decode chain
with every cache leaf, ``lm_loss`` (ce and aux) and its gradients, one
``build_train_step`` step with the reference's decay mask, a copy of
kimi at capacity factor 0.5 whose every path drops; the serve engine's
greedy tokens and pooled caches against the reference engine's with a
free slot (its stale token takes part in each decode step's routing);
the refusal of more than one model shard; the full configs on ``meta``;
the launchers.

Tolerances: f32 1e-5 of the largest magnitude, logits and gradients 1e-4,
a loss 1e-5 relative, 1e-2 relative L2 under bf16 products.  On the
CPU.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import grok_1_314b as jgrok
from repro.configs import kimi_k2_1t_a32b as jkimi
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.serve import engine as jengine
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs import grok_1_314b as tgrok
from repro_torch.configs import kimi_k2_1t_a32b as tkimi
from repro_torch.launch import serve as lserve
from repro_torch.launch import train as ltrain
from repro_torch.models import layers, lm, moe
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig, decays
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import step as tstep

TOL = 1e-5
LOGITS_TOL = 1e-4
BF16_TOL = 1e-2
MAX_LEN = 32
ARCHS = {"kimi": (jkimi, tkimi), "grok": (jgrok, tgrok)}


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


LEVEL_0 = {"xla_backend_optimization_level": 0}


def _jit(fn, **kw):
    """``jax.jit`` of a reference function, compiled at XLA's backend
    optimisation level 0: the same program in under half the compile
    time, which is most of this file's time."""
    return jax.jit(fn, compiler_options=LEVEL_0, **kw)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@contextlib.contextmanager
def _dropped():
    """The pairs each MoE call of the port dropped, in call order."""
    seen, real = [], moe.dispatch

    def spy(experts, cap, n_experts):
        row, kept = real(experts, cap, n_experts)
        seen.append(int((~kept).sum()))
        return row, kept

    moe.dispatch = spy
    try:
        yield seen
    finally:
        moe.dispatch = real


# ---------------------------------------------------------------------------
# The layer.
# ---------------------------------------------------------------------------

POLICIES = {
    "f32": (jlayers.DTypePolicy(jnp.float32, jnp.float32, jnp.float32),
            layers.DTypePolicy(torch.float32, torch.float32, torch.float32)),
    "bf16": (jlayers.DTypePolicy(jnp.bfloat16, jnp.bfloat16, jnp.float32),
             layers.DTypePolicy(torch.bfloat16, torch.bfloat16,
                                torch.float32)),
}


def _layer(precision, cf=2.0, shared=32, seed=0):
    """The reference's layer parameters (in the shapes and dtypes of its
    ``init_moe``, drawn with numpy: the router f32, the rest in the
    policy's parameter dtype) and the port's layer holding them: D 32,
    E 4, top-2, F 16."""
    kw = dict(dim=32, n_experts=4, top_k=2, d_ff=16, capacity_factor=cf,
              shared_expert_ff=shared)
    jcfg, tcfg = jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)
    jpol, tpol = POLICIES[precision]
    shapes = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg,
                                                    jpol.param_dtype),
                            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: _draw(p, a, rng), shapes)
    layer = moe.MoE(tcfg, tpol, generator=None, device="meta")
    layer.load_state_dict(
        {".".join(str(p.key) for p in path):
         torch.from_numpy(np.asarray(a, np.float32)).to(
             torch.float32 if a.dtype == jnp.float32 else tpol.param_dtype)
         for path, a in jax.tree_util.tree_leaves_with_path(params)},
        assign=True)
    return jcfg, jpol, params, layer


def _reference_layer(jcfg, jpol, params, x, gy):
    """route, apply_moe's (y, aux) and the gradients of <y, gy> + aux with
    respect to x and every parameter, as one program."""
    cd = jpol.compute_dtype

    @_jit
    def run(params, x, gy):
        def f(params, x):
            y, aux = jmoe.apply_moe(params, x, jcfg, policy=jpol)
            return (y.astype(jnp.float32) * gy).sum() + aux, (y, aux)

        (_, (y, aux)), grads = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, x)
        routed = jmoe._route(x.reshape(-1, x.shape[-1]), params["router"],
                             jcfg)
        return y, aux, grads, routed

    return run(params, jnp.asarray(x, cd), jnp.asarray(gy))


LAYER_CASES = {"f32": ("f32", 2.0, 32), "f32_no_shared": ("f32", 2.0, 0),
               "bf16": ("bf16", 2.0, 32), "bf16_no_shared": ("bf16", 2.0, 0),
               "f32_drops": ("f32", 0.05, 32),
               "bf16_drops": ("bf16", 0.05, 0)}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(case):
    """``route`` (gates, experts, the aux loss), y, the aux loss times its
    coefficient and the gradients of x, the router, the slabs and the
    shared expert against the reference: f32 1e-5 (gradients 1e-4), 1e-2
    relative L2 under bf16, experts equal.  At capacity factor 0.05 (cap
    1 for 40 pairs over 4 experts) slots drop, and the gradients of the
    dropped pairs' tokens reach the router only through the gates."""
    precision, cf, shared = LAYER_CASES[case]
    jcfg, jpol, params, layer = _layer(precision, cf, shared)
    x, gy = _rand(1, 2, 10, 32), _rand(2, 2, 10, 32)
    y, aux, (gp, gx), (jg, je, jaux) = _reference_layer(jcfg, jpol, params,
                                                        x, gy)
    cd = layer.policy.compute_dtype
    tx = torch.from_numpy(x).to(cd).requires_grad_()
    gates, experts, taux = moe.route(tx.detach().reshape(-1, 32),
                                     layer.router, layer.cfg)
    assert experts.tolist() == np.asarray(je).tolist()
    _check(gates, jg, precision, "gates")
    _check(taux, jaux, precision, "route aux")
    with _dropped() as drops:
        ty, taux = layer(tx)
    assert drops == [0] if cf > 1 else drops[0] > 0, drops
    assert ty.dtype == cd and taux.dtype == torch.float32
    _check(ty, y, precision, "y")
    _check(taux, aux, precision, "aux")
    ((ty.float() * torch.from_numpy(gy)).sum() + taux).backward()
    _check(tx.grad, gx, precision, "dx", LOGITS_TOL)
    named = dict(layer.named_parameters())
    assert sorted(named) == sorted(
        ".".join(str(p.key) for p in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(gp))
    for path, g in jax.tree_util.tree_leaves_with_path(gp):
        name = ".".join(str(p.key) for p in path)
        p = named[name]
        assert p.grad.dtype == p.dtype, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
        _check(p.grad, g, precision, f"d{name}", LOGITS_TOL)


def test_router_backward_contracts_in_the_compute_dtype():
    """Under bf16 the router's hand VJP rounds the logits' cotangent to
    bf16 before both contractions, as the reference's does: its gradients
    equal that rounding exactly, and differ from plain autograd's f32
    contraction."""
    torch.manual_seed(0)
    x = torch.randn(6, 8).to(torch.bfloat16).requires_grad_()
    w = torch.randn(8, 4).requires_grad_()
    dl = torch.randn(6, 4)
    moe._RouterMatmul.apply(x, w).backward(dl)
    d = dl.to(torch.bfloat16)
    assert torch.equal(x.grad, d @ w.detach().to(torch.bfloat16).T)
    assert torch.equal(w.grad, (x.detach().T @ d).float())
    assert w.grad.dtype == torch.float32
    xp, wp = x.detach().float().requires_grad_(), w.detach().clone()
    wp.requires_grad_()
    (xp @ wp.to(torch.bfloat16).float()).backward(dl)
    assert not torch.equal(wp.grad, w.grad)


@pytest.mark.parametrize("precision", sorted(POLICIES))
def test_tied_probabilities_take_the_lower_expert_first(precision):
    """An all-zero router input gives uniform probabilities: both sides
    pick experts 0..k-1 in that order (``jax.lax.top_k``'s order among
    ties), gates 1/k, and route the row's slots to the same buffer rows."""
    jcfg, jpol, params, layer = _layer(precision)
    x = _rand(3, 6, 32)
    x[[1, 4]] = 0.0
    cd = layer.policy.compute_dtype
    _, je, _ = _jit(lambda p, x: jmoe._route(x, p["router"], jcfg))(
        params, jnp.asarray(x, jpol.compute_dtype))
    gates, experts, _ = moe.route(torch.from_numpy(x).to(cd), layer.router,
                                  layer.cfg)
    assert experts.tolist() == np.asarray(je).tolist()
    assert experts[1].tolist() == experts[4].tolist() == [0, 1]
    assert gates[1].tolist() == [0.5, 0.5]


def test_capacity_and_dispatch():
    """The reference's ``ceil(k * t / E * cf)`` at full width (kimi 27
    at 1024 tokens, 54 at 2048, 1 at a 4-slot decode step; grok 320 and 2)
    and on the reduced configs (kimi-reduced ceil(t / 2); grok-reduced t,
    so it never drops); ranks follow the token-major order of the pairs,
    the first arrivals keep their rows, and a dropped pair points one past
    the buffer."""
    def cap(arch, t, reduced=False):
        cfg = getattr(ARCHS[arch][1], "reduced" if reduced else "full")()
        return moe.capacity(lm.moe_config(cfg), t)

    assert [cap("kimi", t) for t in (1024, 2048, 4)] == [27, 54, 1]
    assert [cap("grok", t) for t in (1024, 4)] == [320, 2]
    for t in (1, 4, 7, 36):
        assert cap("kimi", t, True) == -(-t // 2)
        assert cap("grok", t, True) == t
    experts = torch.tensor([[2, 0], [2, 1], [0, 2], [2, 0]])
    row, kept = moe.dispatch(experts, 2, 3)
    assert kept.tolist() == [True] * 5 + [False] * 3
    assert row.tolist() == [4, 0, 5, 2, 1, 6, 6, 6]


def test_per_expert_loop_matches_the_layer():
    """``moe_per_expert``, the plain version the card's checks hold the
    layer against, equals the layer in f32 (1e-5), with and without
    drops, and counts the dropped pairs as the dispatch does."""
    for cf in (2.0, 0.05):
        _, _, _, layer = _layer("f32", cf)
        x = torch.from_numpy(_rand(4, 2, 10, 32))
        with torch.no_grad(), _dropped() as drops:
            y, _ = layer(x)
            plain, dropped, pairs = moe.moe_per_expert(layer, x)
        _close(plain, y, TOL, f"cf {cf}")
        assert (dropped, pairs) == (drops[0], 40)
        assert (dropped > 0) == (cf < 1)


def test_model_shards_are_refused():
    """More than one model shard needs the slabs split over a model axis
    of that extent (``parallel.tensor_parallel``, ``tests/test_torch_tp.py``):
    the reference without a mesh then runs shard 0's slab alone (grok at
    16 shards keeps expert group 0 and half of each expert's hidden
    width), so a call without that axis raises, naming item 6.2.  The
    geometry of the slabs is the reference's, and the model builds: its
    slabs hold every shard until ``shard_model`` keeps one."""
    for shards in (2, 16):
        cfg = tgrok.full(shards)
        mine, theirs = lm.moe_config(cfg), jlm._moe_cfg(jgrok.full(shards))
        assert (mine.ep, mine.tp, mine.e_loc, mine.f_loc) == \
            (theirs.ep, theirs.tp, theirs.e_loc, theirs.f_loc)
        model = lm.LM(cfg, device="meta")
        moe = next(b for _, _, b in model.walk()).moe
        assert moe.gate_slab.shape == (shards, mine.e_loc, cfg.d_model,
                                       mine.f_loc)
        with pytest.raises(NotImplementedError, match="item 6.2"):
            moe(torch.zeros((1, 2, cfg.d_model), device="meta"))
    model = lm.LM(dataclasses.replace(tkimi.reduced(), n_model_shards=2),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 6.2"):
        lm.apply_lm(model, torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------------------
# The LM: kimi-reduced and grok-reduced.
# ---------------------------------------------------------------------------

def _pair(arch, precision=None, **kw):
    jmod, tmod = ARCHS[arch]
    cj, ct = jmod.reduced(), tmod.reduced()
    if precision == "f32":
        cj = jbase.with_precision(cj, "f32")
        ct = tbase.with_precision(ct, "f32")
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _truncated_normal(rng, shape):
    n = rng.standard_normal(shape)
    while (bad := np.abs(n) > 2).any():
        n[bad] = rng.standard_normal(int(bad.sum()))
    return n


def _draw(path, a, rng):
    """A value for a reference leaf drawn as its initialiser draws it:
    norm scales 1, the embedding truncated normal times 0.02, every other
    leaf (dense weights, the router, the slabs: the down slab's second
    last axis is the expert's hidden width) truncated normal over the
    square root of its second last axis."""
    name = "/".join(str(p.key) for p in path)
    if name.endswith("scale"):
        v = np.ones(a.shape)
    elif name == "embed":
        v = 0.02 * _truncated_normal(rng, a.shape)
    else:
        v = _truncated_normal(rng, a.shape) / np.sqrt(a.shape[-2])
    return jnp.asarray(v, a.dtype)


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    """The reference's pytree for the reduced config (f32 parameters under
    both policies), drawn with numpy into the shapes of ``jax.eval_shape``
    of ``init_lm``."""
    cj = _pair(arch)[0]
    assert cj.param_dtype == jnp.float32
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jlm.init_lm(k, cj),
                            jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(
        lambda p, a: _draw(p, a, rng), shapes)


def _lm(arch, ct):
    params = _params(arch)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, model


def _tokens(seed, batch, length, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int32)


CHUNK = 6
DECODE = 3


def _reference_lm(cj, params, toks):
    """The reference's apply_lm, lm_prefill, a chain of chunks of CHUNK
    tokens (a scan over their offsets) and a greedy decode chain from the
    prefill, as one program."""
    b, s = toks.shape

    @_jit
    def run(params, toks):
        logits = jlm.apply_lm(params, cj, toks)[0]
        plogits, pcaches, _ = jlm.lm_prefill(params, cj, toks, MAX_LEN)

        def chunk(c, lo):
            lg, c = jlm.lm_prefill_chunk(
                params, cj, jax.lax.dynamic_slice_in_dim(toks, lo, CHUNK, 1),
                c, lo)
            return c, lg

        c, chunks = jax.lax.scan(chunk, jlm.init_lm_cache(cj, b, MAX_LEN),
                                 jnp.arange(0, s, CHUNK))
        tok = jnp.argmax(plogits[:, -1:].astype(jnp.float32), -1)

        def step(carry, _):
            tok, caches = carry
            lg, caches = jlm.lm_decode_step(params, cj, tok, caches)
            nxt = jnp.argmax(lg.astype(jnp.float32), -1).astype(jnp.int32)
            return (nxt, caches), (lg[:, 0], tok[:, 0])

        (_, dcaches), (steps, fed) = jax.lax.scan(
            step, (tok.astype(jnp.int32), pcaches), None, length=DECODE)
        return {"apply_lm": logits, "lm_prefill": plogits,
                "lm_prefill caches": pcaches,
                "lm_prefill_chunk": jnp.moveaxis(chunks, 0, 1).reshape(
                    b, s, -1),
                "lm_prefill_chunk caches": c,
                "lm_decode_step": jnp.moveaxis(steps, 0, 1),
                "lm_decode_step caches": dcaches}, jnp.moveaxis(fed, 0, 1)

    return run(params, jnp.asarray(toks))


def _both_sides(arch, cj, ct, toks):
    """{what: (port, reference)} for the four entry points, and the pairs
    the port's MoE calls dropped on each path."""
    params, model = _lm(arch, ct)
    want, fed = _reference_lm(cj, params, toks)
    t = torch.from_numpy(toks).long()
    got, drops = {}, {}
    with _dropped() as drops["apply_lm"]:
        got["apply_lm"] = lm.apply_lm(model, t)
    with _dropped() as drops["lm_prefill"]:
        got["lm_prefill"], caches = lm.lm_prefill(model, t, MAX_LEN)
    got["lm_prefill caches"] = caches
    c, chunks = lm.init_lm_cache(ct, t.shape[0], MAX_LEN, device="cpu"), []
    with _dropped() as drops["lm_prefill_chunk"]:
        for lo in range(0, t.shape[1], CHUNK):
            lg, c = lm.lm_prefill_chunk(model, t[:, lo:lo + CHUNK], c, lo)
            chunks.append(lg)
    got["lm_prefill_chunk"], got["lm_prefill_chunk caches"] = \
        torch.cat(chunks, 1), c
    fed = torch.from_numpy(np.array(fed)).long()
    steps = []
    with _dropped() as drops["lm_decode_step"]:
        for i in range(DECODE):
            lg, caches = lm.lm_decode_step(model, fed[:, i:i + 1], caches)
            steps.append(lg)
    got["lm_decode_step"] = torch.cat(steps, 1)
    got["lm_decode_step caches"] = caches
    return {k: (got[k], want[k]) for k in want}, drops


def _cache_leaves(got, want):
    """(name, port leaf, reference leaf) of every cache leaf; the
    reference nests an attn or attn_moe stage's leaves under "attn"."""
    assert sorted(got) == sorted(want)
    for key in want:
        ref = want[key]["attn"]
        assert sorted(got[key]) == sorted(ref), key
        for name in ref:
            yield f"{key}/{name}", got[key][name], ref[name]


# grok-reduced (cap = t: nothing drops) and a copy of kimi-reduced at
# capacity factor 0.5, whose every path drops, under the f32 policy; kimi
# at its own factor is held in the loss, gradient and train-step tests.
# Under bf16 products the whole LM's routing is not comparable token for
# token: a near tie of two experts' probabilities flips with the rounding
# (one token of grok-reduced's logits then sits 17% from the
# reference's), so the bf16 policy is held at the layer
# (test_moe_layer_matches_jax).
LM_CASES = {"grok": None, "kimi_cf0.5": 0.5}


@pytest.fixture(scope="module")
def lm_runs():
    runs = {}
    for case, cf in LM_CASES.items():
        arch = case.split("_")[0]
        cj, ct = _pair(arch, "f32",
                       **({"capacity_factor": cf} if cf else {}))
        with torch.no_grad():
            runs[case] = (ct, *_both_sides(arch, cj, ct, _tokens(0, 2, 18)))
    return runs


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_paths_match_jax(lm_runs, case):
    """f32: apply_lm, lm_prefill, a chain of three chunks and three decode
    steps, logits 1e-4 of the largest magnitude; every cache leaf (the KV
    caches of the attn and attn_moe stages) 1e-5, lengths equal.  Capacity
    is per call (36 tokens, 12 a chunk, 2 a decode step): at
    capacity factor 0.5 each path drops, and grok-reduced (cap = t) never
    does."""
    ct, out, drops = lm_runs[case]
    for what, (got, want) in out.items():
        if what.endswith("caches"):
            for leaf, g, w in _cache_leaves(got, want):
                if leaf.endswith("length"):
                    assert g.tolist() == np.asarray(w).tolist(), leaf
                else:
                    _close(g, w, TOL, f"{what} {leaf}")
        else:
            assert got.shape[-1] == 512 and got.dtype == torch.float32
            _close(got, want, LOGITS_TOL, what)
    n_moe = sum(n for _, kind, n in ct.stages() if kind == "attn_moe")
    for path, seen in drops.items():
        calls = {"lm_prefill_chunk": 18 // CHUNK,
                 "lm_decode_step": DECODE}.get(path, 1)
        assert len(seen) == n_moe * calls, path
        if case.startswith("grok"):
            assert not any(seen), path
        elif ct.capacity_factor < 1:
            assert sum(seen) > 0, path


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


@functools.lru_cache(maxsize=None)
def _grads_run(arch):
    """f32: the reference's loss, its parts and gradients, and one step of
    its ``build_train_step`` from the same parameters and batch, as one
    program."""
    cj, ct = _pair(arch, "f32")
    params, model = _lm(arch, ct)
    b = _batch(2)
    step = jstep.build_train_step(cj, jadamw.AdamWConfig(**OPT))

    @_jit
    def reference(params, jb):
        (loss, parts), grads = jax.value_and_grad(
            lambda p: jlm.lm_loss(p, cj, jb), has_aux=True)(params)
        state = {"params": params,
                 "opt": jadamw.adamw_init(jadamw.AdamWConfig(**OPT), params)}
        return loss, parts, grads, step(state, jb)

    loss, parts, grads, (jstate, jmetrics) = reference(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    return (cj, ct, params, model, b, loss, parts,
            lm_state_from_jax(jax.tree.map(np.asarray, grads)),
            jstate, jmetrics)


@pytest.mark.parametrize("remat", ["none", "unit"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_loss_and_gradients_match_jax(arch, remat):
    """f32: the loss, ce and aux (the attn_moe blocks' summed Switch
    losses, > 0) within 1e-5 relative, every gradient within 1e-4 of its
    leaf's largest magnitude, finite and nonzero (the router's and each
    slab's included); under remat "unit" each block runs again in the
    backward and its aux loss is counted once."""
    _, ct, _, model, b, want, parts, want_g, _, _ = _grads_run(arch)
    model.cfg = dataclasses.replace(ct, remat=remat)
    try:
        loss, got, grads = _loss_and_grads(model, b)
    finally:
        model.cfg = ct
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(got[k].detach()), float(parts[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(got["aux"]) > 0
    assert grads.keys() == want_g.keys()
    assert any(n.endswith("moe.router") for n in grads)
    for n, w in want_g.items():
        assert torch.isfinite(grads[n]).all() and grads[n].abs().max() > 0, n
        _close(grads[n], w, LOGITS_TOL, n)


def _reference_path(name):
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _first_step_direction(g, norm, cfg):
    g = g.astype(np.float64) * min(cfg.grad_clip / float(norm), 1.0)
    return g / (np.abs(g) + cfg.eps)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_matches_jax(arch):
    """One ``build_train_step`` step against the reference's: AdamW decays
    exactly the leaves the reference's mask and rank rule decay (the
    router and the slabs among them); loss and aux 1e-5 relative,
    grad_norm and lr 1e-6, each parameter within 1e-5 of its leaf's
    largest plus twice the step noise its two gradients predict
    (tests/test_torch_lm_attn.py)."""
    cj, ct, params, _, b, _, _, gj, jstate, want = _grads_run(arch)
    _, model = _lm(arch, ct)
    want_decay = {
        "/".join(str(p.key) for p in path):
            jadamw._decay_mask(path) and a.ndim >= 2
        for path, a in jax.tree_util.tree_leaves_with_path(params)}
    got_decay = {_reference_path(n): decays(n, p)
                 for n, p in model.named_parameters()}
    assert got_decay == want_decay
    key = lm._stage_key(len(ct.prelude), "attn_moe")
    for leaf in ("router", "gate_slab", "up_slab", "down_slab"):
        assert got_decay[f"stages/{key}/moe/{leaf}"], leaf

    ocfg = AdamWConfig(**OPT)
    gt = _loss_and_grads(model, b)[2]
    state = tstep.init_train_state(model, ocfg)
    state, got = tstep.build_train_step(model, ocfg)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    for k, tol in (("loss", 1e-5), ("aux", 1e-5), ("grad_norm", 1e-6),
                   ("lr", 1e-6)):
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


def test_grad_accum_sums_the_aux_loss():
    """Two microbatches: the step's aux is the mean of theirs and ce the
    rest of the loss (``train/step.py``'s accumulation)."""
    _, ct = _pair("kimi", "f32")
    _, model = _lm("kimi", ct)
    b = _batch(3, n=4, seq=8)
    auxes = [float(lm.lm_loss(model, {k: torch.from_numpy(v[i:i + 2])
                                      for k, v in b.items()})[1]["aux"])
             for i in (0, 2)]
    ocfg = AdamWConfig(**OPT)
    _, got = tstep.build_train_step(model, ocfg, grad_accum=2)(
        tstep.init_train_state(model, ocfg),
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(got["aux"]), np.mean(auxes), rtol=1e-6)
    np.testing.assert_allclose(float(got["ce"]) + float(got["aux"]),
                               float(got["loss"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# Parameters, configs and the registry.
# ---------------------------------------------------------------------------

def test_lm_state_from_jax_maps_every_moe_leaf_once():
    """Every reference leaf of kimi-reduced (the shared expert included)
    lands in exactly one port parameter of the right shape, the slabs
    unstacked from (n_units, n, M, E, ...) to (M, E, ...); a missing MoE
    leaf raises KeyError and a leaf left over ValueError."""
    params = jax.tree.map(np.asarray, _params("kimi"))
    state = lm_state_from_jax(params)
    n_leaves = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(t.numel() for t in state.values()) == n_leaves
    model = lm.LM(_pair("kimi")[1], device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(t.shape) for n, t in state.items()} == shapes
    slab = params["stages"]["s1_attn_moe"]["moe"]["down_slab"]
    assert slab.shape == (1, 2, 1, 8, 32, 64)
    np.testing.assert_array_equal(
        state["stages.s1_attn_moe.0.1.moe.down_slab"].numpy(), slab[0, 1])
    assert sum(".moe." in n for n in state) == 2 * 7
    missing = jax.tree.map(lambda a: a, params)
    del missing["stages"]["s1_attn_moe"]["moe"]["shared"]["down"]
    with pytest.raises(KeyError, match="moe/shared/down"):
        lm_state_from_jax(missing)
    extra = jax.tree.map(lambda a: a, params)
    extra["stages"]["s1_attn_moe"]["moe"]["extra"] = slab
    with pytest.raises(ValueError, match="extra"):
        lm_state_from_jax(extra)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_and_entry_match_the_reference(arch):
    jmod, tmod = ARCHS[arch]
    for make in ("full", "reduced"):
        mine, theirs = getattr(tmod, make)(), getattr(jmod, make)()
        for f in dataclasses.fields(mine):
            if f.name == "gspn_impl":
                continue
            want, got = getattr(theirs, f.name), getattr(mine, f.name)
            if isinstance(got, torch.dtype):
                want = getattr(torch, str(jnp.dtype(want)))
            assert got == want, (make, f.name)
    name = tmod.full().name
    a, b = tbase.get_arch(name), jbase.get_arch(name)
    assert (a.name, a.family, a.skip_shapes, a.source) == \
        (b.name, b.family, b.skip_shapes, b.source)
    assert name in tbase.list_archs()
    assert "attn_moe" in lm.KINDS


@pytest.mark.parametrize("arch,params,active,layers", [
    ("kimi", 1_027_291_575_296, 33_743_962_112, 61),
    ("grok", 316_489_340_928, 84_560_314_368, 64)])
def test_full_config_on_meta_has_the_reference_counts(arch, params, active,
                                                      layers):
    """The parameters of the reference's ``init_lm`` (from
    ``jax.eval_shape``), its ``count_active_params`` and ``layer_count``,
    on the full and reduced configs."""
    jmod, tmod = ARCHS[arch]
    cfg = tmod.full()
    assert lm.count_params(lm.LM(cfg, device="meta")) == params
    assert lm.count_active_params(cfg) == active == \
        jlm.count_active_params(jmod.full())
    assert cfg.layer_count() == layers == jmod.full().layer_count()
    assert lm.count_active_params(tmod.reduced()) == \
        jlm.count_active_params(jmod.reduced())


# ---------------------------------------------------------------------------
# Serving and the launchers.
# ---------------------------------------------------------------------------

def test_engine_matches_the_jax_engine_with_a_free_slot():
    """kimi-reduced at capacity factor 0.5 and f32, 4 slots, chunks of 8,
    three requests (two chunked), so one slot never holds a request and
    the others free at different steps: a decode step routes all 4 rows
    (cap 1: slots drop), the free slots' stale tokens among them, as in
    the reference.  Greedy tokens equal the reference engine's, and so do
    the last tokens and every pooled cache leaf, the free slots' included
    (1e-5)."""
    cj, ct = _pair("kimi", "f32", capacity_factor=0.5)
    params, model = _lm("kimi", ct)
    prompts = [np.random.default_rng(i).integers(0, 512, n)
               for i, n in enumerate((16, 12, 24))]
    news = (5, 3, 6)
    jeng = jengine.ServeEngine(params, cj, batch_size=4, max_len=MAX_LEN,
                               prefill_chunk=8)
    for name, static in (("_prefill", ()), ("_prefill_chunk_fn", (4,)),
                         ("_decode", ())):
        setattr(jeng, name, _jit(getattr(jeng, name).__wrapped__,
                                 static_argnums=static))
    eng = ServeEngine(model, batch_size=4, max_len=MAX_LEN, prefill_chunk=8)
    for i, (pr, n) in enumerate(zip(prompts, news)):
        jeng.submit(jengine.Request(uid=i, prompt=pr, max_new_tokens=n))
        eng.submit(Request(uid=i, prompt=pr, max_new_tokens=n))
    want = {u: r.tokens for u, r in jeng.run().items()}
    with _dropped() as drops:
        got = {u: r.tokens for u, r in eng.run().items()}
    assert eng.metrics["prefill_chunks"] == 7 and \
        eng.metrics["decode_steps"] == jeng.metrics["decode_steps"]
    assert got == want
    assert sum(drops) > 0
    assert eng.last_token.tolist() == np.asarray(jeng.last_token).tolist()
    for leaf, g, w in _cache_leaves(eng.pool.caches, jeng.pool.caches):
        if leaf.endswith("length"):
            assert g.tolist() == np.asarray(w).tolist(), leaf
        else:
            _close(g, w, TOL, leaf)


def test_serve_launcher_serves_kimi_on_the_cpu(capsys):
    """``launch/serve.py --arch kimi-k2-1t-a32b --reduced --device cpu
    --prefill-chunk 16 --max-len 64``: every request finishes with its
    tokens, the long prompts in chunks."""
    results = lserve.main(["--arch", "kimi-k2-1t-a32b", "--reduced",
                           "--device", "cpu", "--requests", "3",
                           "--max-new", "3", "--prefill-chunk", "16",
                           "--max-len", "64"])
    out = capsys.readouterr().out
    assert [len(r.tokens) for r in results] == [3, 3, 3]
    assert "kimi-reduced on cpu" in out and "prefill chunk 16" in out
    assert " 3 prefill chunks" in out


def test_train_launcher_trains_grok_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --arch grok-1-314b --reduced --device cpu --steps
    2``, and again under the bf16 preset: the f32 master copy and loss
    scaling over bf16 slabs beside the f32 router, finite losses, a
    checkpoint of the last step."""
    for precision in ([], ["--precision", "bf16"]):
        ckpt = tmp_path / (precision[-1] if precision else "own")
        tr = ltrain.main(["--arch", "grok-1-314b", "--reduced", "--device",
                          "cpu", "--steps", "2", "--batch", "2", "--seq",
                          "16", "--ckpt-dir", str(ckpt)] + precision)
        out = capsys.readouterr().out
        assert "grok-reduced on cpu" in out and "recoveries=0" in out
        assert tr.step == 2 and all(map(np.isfinite, tr.history))
        assert tr.ckpt.latest_step() == 2
    params = dict(tr.model.named_parameters())
    assert params["stages.s0_attn_moe.0.0.moe.router"].dtype == torch.float32
    assert params["stages.s0_attn_moe.0.0.moe.gate_slab"].dtype == \
        torch.bfloat16
