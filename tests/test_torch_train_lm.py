"""The port's LM training path against the JAX reference package:
rmsnorm's hand VJP, ``cross_entropy_loss``, ``lm_loss`` and its
gradients, rematerialisation, the train step (AdamW, gradient
accumulation, the f32 master copy and dynamic loss scaling), the token
pipeline, checkpoints, the trainer and the entry points.

Parameters carry across with ``lm_state_from_jax``; the reference runs its
plain path (``impl="xla"``).  Tolerances: rmsnorm and the loss 1e-6 of
the largest magnitude in f32; ``lm_loss`` 1e-5 relative for the loss and
1e-4 of each leaf's largest magnitude for its gradient under the f32
policy; under the config's own bf16 policy 1e-2 relative for the loss
(DESIGN.md §10) and 3e-2 relative L2 for each gradient, no farther from
the f32 gradients than the reference is (see ``BF16_GRAD_TOL``); three
train steps 1e-5 relative for the loss, 1e-6 for the learning rate, and
for the first step 1e-6 for the gradient norm and 1e-5 of each leaf's
largest magnitude for the parameters but at the gradients' noise floor,
for the last 1e-5 and 1e-4 (see ``PARAM_TOL``).  All on the ``reduced()`` config (2 layers, d 48, vocab 512,
row width 8) or smaller, on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import qwen2_1_5b_gspn as jq
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen2_1_5b_gspn as tq
from repro_torch.data import pipeline
from repro_torch.kernels import cuda_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig


BF16_TOL = 1e-2
# Gradients of the whole LM under bf16 products.  The reference's and the
# port's each sit 1.7-4.0e-2 (relative L2, leaf by leaf) from the f32
# policy's gradients of the same parameters, and 1.1-2.3e-2 from each
# other, so DESIGN.md §10's 1e-2 (which bounds one scan's bf16 error) is
# not met by a whole model.  Two causes, each with its witness below:
# XLA on the CPU rounds a bf16 sigmoid three times and PyTorch once
# (test_xla_rounds_a_bf16_sigmoid_three_times), and the bf16 gradients
# move by 1e-3 or more when the f32 mixer's inputs move by one f32 ulp
# (test_bf16_gradients_amplify_f32_noise), while XLA's and PyTorch's f32
# mixer sums differ by more than that.  So each leaf is held to 3e-2, and
# against the f32 gradients the port must be as close as the reference:
# within BF16_VS_REF times its distance over all leaves (1.09 measured)
# and twice it per leaf (at most 1.57 measured), which a systematic
# rounding fault would break.
BF16_GRAD_TOL = 3e-2
BF16_VS_REF = 1.2


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


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _reduced(precision=None, **kw):
    cj, ct = jq.reduced(), tq.reduced()
    if precision:
        cj = jbase.with_precision(cj, precision)
        ct = tbase.with_precision(ct, precision)
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _lm(cj, ct, seed=0):
    """The reference's parameters and the port's LM holding them."""
    params = jlm.init_lm(jax.random.PRNGKey(seed), cj)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(
        lm_state_from_jax(jax.tree.map(np.asarray, params)), assign=True)
    return params, model


def _batch(n=2, seq=32, step=0, seed=0):
    """A token batch of the shared pipeline, as numpy."""
    return jpipe.host_batch(jpipe.DataConfig(vocab=512, seq_len=seq,
                                             global_batch=n, seed=seed), step)


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# rmsnorm's VJP and the loss.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vjp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    g = rng.standard_normal((3, 5, 48)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda a, s: jlayers.apply_rmsnorm({"scale": s}, a),
                     jnp.asarray(x, jd), jnp.asarray(scale, jd))
    want_dx, want_ds = vjp(jnp.asarray(g, jd))
    norm = layers.RMSNorm(48, device="cpu", dtype=td)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    out = norm(xt)
    dx, ds = torch.autograd.grad(out, (xt, norm.scale),
                                 torch.from_numpy(g).to(td))
    assert dx.dtype == td and ds.dtype == td
    with torch.no_grad():        # the bare forward serving runs
        assert torch.equal(norm(xt), out)
    for what, got, want in (("y", out, y), ("dx", dx, want_dx),
                            ("dscale", ds, want_ds)):
        if dtype == "float32":
            _close(got, want, 1e-6, what)
        else:
            assert _rel_l2(got, want) <= BF16_TOL, what


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None

    def jloss(lg):
        return jlayers.cross_entropy_loss(
            lg, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = layers.cross_entropy_loss(
        lt, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, lt)
    _close(got, want, 1e-6, "loss")
    _close(got_g, want_g, 1e-6, "gradient")


# ---------------------------------------------------------------------------
# lm_loss and rematerialisation.
# ---------------------------------------------------------------------------

def _loss_and_grads(model, batch):
    loss, parts = lm.lm_loss(model, _torch_batch(batch))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return loss.detach(), parts, dict(zip(names, grads))


@pytest.mark.parametrize("precision", ["f32", None])
def test_lm_loss_and_gradients_match_jax(precision):
    """f32: the loss within 1e-5 relative and each gradient within 1e-4
    of its leaf's largest magnitude.  The config's own policy (bf16
    products): the loss within 1e-2 relative, each gradient within
    BF16_GRAD_TOL relative L2."""
    cj, ct = _reduced(precision)
    params, model = _lm(cj, ct)
    b = _batch(seq=27)
    (want, want_parts), want_g = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, cj, _jax_batch(b)), has_aux=True)(params)
    cuda_lib.clear_counts()
    loss, parts, grads = _loss_and_grads(model, b)
    assert cuda_lib.plain_calls == {"gspn_scan_fwd": 4, "gspn_scan_bwd": 4}
    assert float(parts["aux"]) == 0.0 == float(want_parts["aux"])
    want_g = lm_state_from_jax(jax.tree.map(np.asarray, want_g))
    assert grads.keys() == want_g.keys()
    if precision == "f32":
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(parts["ce"]),
                                   float(want_parts["ce"]), rtol=1e-5)
        for name, w in want_g.items():
            _close(grads[name], w, 1e-4, name)
    else:
        assert _rel_l2(loss, want) <= BF16_TOL
        cf, _ = _reduced("f32")
        exact = lm_state_from_jax(jax.tree.map(np.asarray, jax.grad(
            lambda p: jlm.lm_loss(p, cf, _jax_batch(b))[0])(params)))
        for name, w in want_g.items():
            assert grads[name].dtype == torch.float32
            assert _rel_l2(grads[name], w) <= BF16_GRAD_TOL, name
            assert _rel_l2(grads[name], exact[name]) <= \
                2 * _rel_l2(w, exact[name]), name

        def flat(tree):
            return np.concatenate([_np(tree[k]).ravel() for k in sorted(tree)])

        assert _rel_l2(flat(grads), flat(exact)) <= \
            BF16_VS_REF * _rel_l2(flat(want_g), flat(exact))


def test_xla_rounds_a_bf16_sigmoid_three_times():
    """Witness for the bf16 gradient bound: the reference's bf16 sigmoid
    (so its silu) is 1 / (1 + exp(-x)) with every operation rounded to
    bf16, bit for bit, where PyTorch rounds the f32 sigmoid once; the two
    differ in the last bit on about a third of the values."""
    x = np.random.default_rng(0).standard_normal(20000).astype(
        np.float32) * 3
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    want = np.asarray(jax.nn.sigmoid(xj).astype(jnp.float32))
    np.testing.assert_array_equal(
        (1 / (1 + torch.exp(-xt))).float().numpy(), want)
    assert np.mean(torch.sigmoid(xt).float().numpy() != want) > 0.25


@pytest.mark.parametrize("precision,lo,hi", [("f32", 0.0, 1e-5),
                                             (None, 1e-3, BF16_GRAD_TOL)])
def test_bf16_gradients_amplify_f32_noise(precision, lo, hi):
    """Witness for the bf16 gradient bound: moving each f32 parameter of
    the mixers (which compute in f32 under either policy) by one ulp
    moves the f32 policy's gradients by under 1e-5 but the bf16 policy's
    by 1e-3 or more (relative L2 over all leaves), since the mixers'
    outputs are rounded to bf16; at the parameters of
    test_lm_loss_and_gradients_match_jax."""
    _, model = _lm(*_reduced(precision))
    b = _batch(seq=27)
    _, _, before = _loss_and_grads(model, b)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".mix." in name:
                up = torch.rand(p.shape, generator=gen) < 0.5
                p.copy_(torch.nextafter(p, torch.where(up, torch.inf,
                                                       -torch.inf)))
    _, _, after = _loss_and_grads(model, b)
    names = sorted(before)
    moved = _rel_l2(np.concatenate([_np(after[n]).ravel() for n in names]),
                    np.concatenate([_np(before[n]).ravel() for n in names]))
    assert lo <= moved <= hi


def test_remat_modes_give_the_same_loss_and_gradients():
    """"none" and "unit" within 1e-6; "unit" runs each block's forward
    again in the backward (two more scans a layer).  The reference's
    "dots" raises until the dry-run, its only caller, is ported."""
    _, ct = _reduced("f32")
    b = _batch(seq=24, seed=3)
    out, calls = {}, {}
    for remat in ("none", "unit"):
        model = lm.LM(dataclasses.replace(ct, remat=remat), device="cpu",
                      generator=torch.Generator().manual_seed(2))
        cuda_lib.clear_counts()
        out[remat] = _loss_and_grads(model, b)
        calls[remat] = dict(cuda_lib.plain_calls)
    assert calls["none"] == {"gspn_scan_fwd": 4, "gspn_scan_bwd": 4}
    assert calls["unit"] == {"gspn_scan_fwd": 8, "gspn_scan_bwd": 4}
    loss, _, grads = out["none"]
    np.testing.assert_allclose(float(out["unit"][0]), float(loss), rtol=1e-6)
    for name, g in grads.items():
        _close(out["unit"][2][name], g, 1e-6, f"unit {name}")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="item 8"):
        lm.apply_lm(lm.LM(dataclasses.replace(ct, remat="dots"),
                          device="cpu"), tokens)
    with pytest.raises(ValueError, match="remat"):
        lm.apply_lm(lm.LM(dataclasses.replace(ct, remat="all"),
                          device="cpu"), tokens)


def test_lm_loss_runs_under_the_callers_grad_mode():
    _, ct = _reduced("f32")
    model = lm.LM(ct, device="cpu")
    b = _torch_batch(_batch(seq=16))
    assert lm.lm_loss(model, b)[0].requires_grad
    with torch.no_grad():
        assert not lm.lm_loss(model, b)[0].requires_grad


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------

# AdamW for the step parity.  The first step moves each element by
# lr * g / (|g| + eps), so where the gradient sits at the f32 noise floor
# (below NOISE_FLOOR of its leaf's largest, a few eps in size) XLA's and
# PyTorch's noise is a visible share of the step: ffn.down[88, 44] has
# g = -3.81e-8 in the reference and -4.14e-8 in the port, and ends 5.1e-5
# of its leaf's largest parameter apart.  So after the first step every
# element off by more than 1e-5 must be such an element, and the
# gradient norm is held to 1e-6; once parameters differ, later steps'
# gradients do too (grad_norm 1.1e-6 apart at step 3, a few more
# elements off by up to 1.3e-5), so the last steps are held to 1e-5
# for the gradient norm and 1e-4 for the parameters.
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
PARAM_TOL = 1e-4
NOISE_FLOOR = 1e-5


def test_train_steps_match_jax():
    """Three steps of the port's step against three of the reference's
    ``build_train_step`` (no mesh), from the same parameters and
    batches."""
    cj, ct = _reduced("f32")
    params, model = _lm(cj, ct)
    jstep_fn = jax.jit(jstep.build_train_step(cj, jadamw.AdamWConfig(**OPT)))
    jstate = {"params": params,
              "opt": jadamw.adamw_init(jadamw.AdamWConfig(**OPT), params)}
    ocfg = AdamWConfig(**OPT)
    state = tstep.init_train_state(model, ocfg)
    step = tstep.build_train_step(model, ocfg)
    g0 = lm_state_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda p: jlm.lm_loss(p, cj, _jax_batch(_batch(seq=24)))[0])(params)))
    for s in range(3):
        b = _batch(step=s, seq=24)
        jstate, want = jstep_fn(jstate, _jax_batch(b))
        state, got = step(state, _torch_batch(b))
        for k, tol in (("loss", 1e-5), ("grad_norm", 1e-6 if s == 0 else
                                        1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=tol, err_msg=k)
        assert got["step"] == int(want["step"]) == s + 1
        assert set(got) == set(want)
        if s == 0:
            after = lm_state_from_jax(jax.tree.map(np.asarray,
                                                   jstate["params"]))
            for name, w in after.items():
                w, g = _np(w), _np(g0[name])
                off = np.abs(_np(state["params"][name]) - w) > \
                    1e-5 * np.abs(w).max()
                assert (np.abs(g[off]) <= NOISE_FLOOR
                        * np.abs(g).max()).all(), name
    want_p = lm_state_from_jax(jax.tree.map(np.asarray, jstate["params"]))
    for name, w in want_p.items():
        _close(state["params"][name], w, PARAM_TOL, name)


def test_grad_accum_matches_full_batch():
    """Two microbatches of 2 rows give the full batch of 4's loss and
    updated parameters within 1e-5."""
    _, ct = _reduced("f32")
    b = _torch_batch(_batch(n=4, seq=24, seed=5))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    out = {}
    for k in (1, 2):
        model = lm.LM(ct, device="cpu",
                      generator=torch.Generator().manual_seed(6))
        state = tstep.init_train_state(model, ocfg)
        state, metrics = tstep.build_train_step(model, ocfg, grad_accum=k)(
            state, b)
        out[k] = (metrics, state["params"])
    np.testing.assert_allclose(float(out[2][0]["loss"]),
                               float(out[1][0]["loss"]), rtol=1e-5)
    assert float(out[2][0]["aux"]) == 0.0
    for name, p in out[1][1].items():
        _close(out[2][1][name], p, 1e-5, name)
    with pytest.raises(ValueError, match="microbatches"):
        tstep.build_train_step(model, ocfg, grad_accum=3)(
            tstep.init_train_state(model, ocfg), b)


def test_grad_compression_waits_for_parallelism():
    _, ct = _reduced()
    with pytest.raises(NotImplementedError, match="item 6"):
        tstep.build_train_step(lm.LM(ct, device="cpu"), AdamWConfig(),
                               grad_compression="int8_ef")


# ---------------------------------------------------------------------------
# Loss scaling and the master copy (as tests/test_mixed_precision.py).
# ---------------------------------------------------------------------------

def _bf16_fixture(ls):
    _, ct = _reduced("bf16", d_model=16, d_ff=32, n_layers=1,
                     unit=(("gspn", 1),), gspn_proxy_dim=2, gspn_row_width=4)
    model = lm.LM(ct, device="cpu", generator=torch.Generator().manual_seed(0))
    ocfg = AdamWConfig()
    state = tstep.init_train_state(model, ocfg, master_weights=True,
                                   loss_scaling=ls)
    step = tstep.build_train_step(model, ocfg, master_weights=True,
                                  loss_scaling=ls)
    batch = {"tokens": torch.full((2, 16), 3, dtype=torch.int32),
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    return step, state, batch


def test_master_copy_update_and_scale_growth():
    ls = tstep.LossScaleConfig(init_scale=2.0 ** 10, growth_interval=2)
    step, state, batch = _bf16_fixture(ls)
    before = {n: m.clone() for n, m in state["master"].items()}
    state, m1 = step(state, batch)
    assert np.isfinite(float(m1["loss"]))
    assert float(m1["grads_finite"]) == 1.0
    assert float(m1["loss_scale"]) == 2.0 ** 10
    assert all(m.dtype == torch.float32 for m in state["master"].values())
    assert all(v.dtype == torch.float32 for v in state["opt"]["m"].values())
    assert all(p.dtype == torch.bfloat16 for p in state["params"].values())
    assert any(not torch.equal(before[n], m)
               for n, m in state["master"].items())
    # the working copy is the master rounded to bf16
    for n, p in state["params"].items():
        assert torch.equal(p, state["master"][n].to(torch.bfloat16)), n
    assert int(state["loss_scale"]["good_steps"]) == 1
    assert state["opt"]["step"] == 1
    state, _ = step(state, batch)
    # growth_interval=2 consecutive finite steps -> the scale doubles
    assert float(state["loss_scale"]["scale"]) == 2.0 ** 11


def test_loss_scale_overflow_skips_the_step_bit_for_bit():
    """2^127 is finite in f32 but scale * loss overflows: the gradients
    are not finite, so parameters, master, moments and step stay as they
    were, bit for bit, and the scale halves."""
    ls = tstep.LossScaleConfig(init_scale=2.0 ** 127)
    step, state, batch = _bf16_fixture(ls)
    state["opt"]["m"] = {n: torch.rand_like(m) for n, m in
                         state["opt"]["m"].items()}
    snap = {k: {n: t.detach().clone() for n, t in state[k].items()}
            for k in ("params", "master")}
    snap_m = {n: t.clone() for n, t in state["opt"]["m"].items()}
    snap_v = {n: t.clone() for n, t in state["opt"]["v"].items()}
    state, m1 = step(state, batch)
    assert float(m1["grads_finite"]) == 0.0
    assert not np.isfinite(float(m1["grad_norm"]))
    assert m1["step"] == 1 and state["opt"]["step"] == 0
    for k in ("params", "master"):
        for n, t in snap[k].items():
            assert torch.equal(state[k][n], t), (k, n)
    for n in snap_m:
        assert torch.equal(state["opt"]["m"][n], snap_m[n])
        assert torch.equal(state["opt"]["v"][n], snap_v[n])
    assert float(state["loss_scale"]["scale"]) == 2.0 ** 126
    assert int(state["loss_scale"]["good_steps"]) == 0


def test_loss_scale_transition_unit():
    ls = tstep.LossScaleConfig(init_scale=4.0, growth_interval=3,
                               min_scale=1.0)
    s = tstep.loss_scale_init(ls)
    s = tstep.loss_scale_update(ls, s, False)
    assert float(s["scale"]) == 2.0 and int(s["good_steps"]) == 0
    s = tstep.loss_scale_update(ls, s, torch.tensor(False))
    s = tstep.loss_scale_update(ls, s, False)
    assert float(s["scale"]) == 1.0          # clamped at min_scale
    for _ in range(3):
        s = tstep.loss_scale_update(ls, s, True)
    assert float(s["scale"]) == 2.0          # grew after the interval
    assert s["scale"].dtype == torch.float32
    assert s["good_steps"].dtype == torch.int32
    assert not bool(tstep.tree_all_finite([torch.tensor([1.0, np.inf])]))
    assert bool(tstep.tree_all_finite([torch.tensor([1.0, 2.0]),
                                       torch.ones(2, dtype=torch.bfloat16)]))
    # the reference's transition, step by step
    jls = jstep.LossScaleConfig(init_scale=4.0, growth_interval=3,
                                min_scale=1.0)
    js, ts = jstep.loss_scale_init(jls), tstep.loss_scale_init(ls)
    for finite in (True, True, False, True, True, True, True, False):
        js = jstep.loss_scale_update(jls, js, jnp.asarray(finite))
        ts = tstep.loss_scale_update(ls, ts, finite)
        assert float(ts["scale"]) == float(js["scale"])
        assert int(ts["good_steps"]) == int(js["good_steps"])


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,host,extra", [
    (0, 0, 0, {}), (3, 17, 1, {}), (7, 2, 3, {"vocab": 300}),
    (1, 5, 2, {}),
])
def test_token_batches_match_reference(seed, step, host, extra):
    """The port's batches equal the reference's bit for bit, and a
    reference host's slice of a 4-host split is the same rows of the
    port's one-process batch (the slicing is positional)."""
    kw = dict(vocab=9000, seq_len=20, global_batch=8, seed=seed)
    kw.update(extra)
    mine, ref = pipeline.DataConfig(**kw), jpipe.DataConfig(**kw)
    got, want = pipeline.synth_tokens(mine, step), jpipe.synth_tokens(ref,
                                                                       step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    got, want = pipeline.host_batch(mine, step), jpipe.host_batch(ref, step)
    assert got.keys() == want.keys() == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    part = jpipe.host_batch(jpipe.DataConfig(n_hosts=4, host_id=host, **kw),
                            step)
    for k in part:
        np.testing.assert_array_equal(got[k][2 * host:2 * host + 2],
                                      part[k], err_msg=k)


def test_data_config_has_no_stub_or_host_fields():
    """The vision and audio stubs (ROADMAP.md §1 item 3.6), host sharding
    (item 6) and uniform streams wait for their callers: the fields do
    not exist."""
    for field in ("vision_len", "enc_len", "d_model", "n_hosts", "host_id",
                  "structure"):
        with pytest.raises(TypeError):
            pipeline.DataConfig(vocab=8, seq_len=4, global_batch=2,
                                **{field: 1})


# ---------------------------------------------------------------------------
# Checkpoints (as tests/test_substrates.py).
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_retention_atomicity(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": 7}}
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, state)
    assert mgr.committed_steps() == [20, 30]
    target = {"params": {"w": torch.zeros(2, 3)}, "opt": {"step": 0}}
    restored, step = mgr.restore(target=target)
    assert step == 30 and restored is target
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["opt"]["step"] == 7
    assert sorted(os.listdir(tmp_path / "step_000000030")) == [
        "COMMIT", "host_000.npz", "meta.json"]
    # uncommitted checkpoints are invisible
    os.remove(tmp_path / "step_000000030" / "COMMIT")
    assert mgr.latest_step() == 20
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(target=target)


def test_checkpoint_rewrite_is_atomic(tmp_path, monkeypatch):
    """Saving a step that is already committed removes its COMMIT first:
    a write that fails part-way leaves the step uncommitted, and restore
    falls back to the one before."""
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    mgr.save(1, {"w": torch.ones(3)})
    mgr.save(2, {"w": torch.full((3,), 2.0)})

    def torn(path, **arrays):
        with open(path, "wb") as f:
            f.write(b"torn")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", torn)
    with pytest.raises(OSError):
        mgr.save(2, {"w": torch.full((3,), 3.0)})
    monkeypatch.undo()
    assert mgr.committed_steps() == [1]
    restored, step = mgr.restore(target={"w": torch.zeros(3)})
    assert step == 1 and torch.equal(restored["w"], torch.ones(3))


def test_checkpoint_async_save_then_restore(tmp_path):
    state = {"w": torch.ones((8, 8))}
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    mgr.save(1, state)
    state["w"].add_(1.0)          # the snapshot was taken before this
    mgr.wait()
    restored, step = mgr.restore(target={"w": torch.zeros((8, 8))})
    assert step == 1 and torch.equal(restored["w"], torch.ones((8, 8)))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"w": torch.ones((2, 2))})
    target = {"w": torch.zeros((3, 3))}
    with pytest.raises(ValueError):
        mgr.restore(target=target)
    assert torch.equal(target["w"], torch.zeros((3, 3)))
    with pytest.raises(KeyError):
        mgr.restore(target={"v": torch.zeros((2, 2))})


def test_checkpoint_keeps_bf16_bits(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)
                         ).to(torch.bfloat16)
    w[0, 0], w[0, 1] = float("inf"), -0.0
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, {"w": w})
    with open(tmp_path / "step_000000003" / "meta.json") as f:
        assert json.load(f)["keys"]["w"]["dtype"] == "bfloat16"
    restored, _ = mgr.restore(target={"w": torch.zeros(5, 7,
                                                       dtype=torch.bfloat16)})
    assert torch.equal(restored["w"].view(torch.int16),
                       w.view(torch.int16))


# ---------------------------------------------------------------------------
# The trainer.
# ---------------------------------------------------------------------------

def _trainer(d, **kw):
    _, ct = _reduced("f32")
    return Trainer(ct, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                   pipeline.DataConfig(vocab=512, seq_len=16, global_batch=2),
                   TrainerConfig(ckpt_dir=str(d), ckpt_every=2,
                                 log_every=1000),
                   device="cpu", **kw)


def test_trainer_recovers_to_an_uninterrupted_history(tmp_path):
    """A failure at step 3 restores the checkpoint of step 2 and replays:
    the loss history equals an uninterrupted run's, one loss a step."""
    fails = {3}

    def injector(step):
        if step in fails:
            fails.discard(step)
            raise RuntimeError("injected")

    clean = _trainer(tmp_path / "clean")
    saved, save = [], clean.ckpt.save
    clean.ckpt.save = lambda step, state: (saved.append(step),
                                           save(step, state))
    want = clean.run(6)
    # every ckpt_every = 2 steps; step 6, already saved, not a second time
    assert saved == [2, 4, 6]
    tr = _trainer(tmp_path / "faulty", failure_injector=injector)
    got = tr.run(6)
    assert tr.recoveries == 1 and tr.step == 6 and len(got) == 6
    assert got == want
    # a restart resumes from the final checkpoint and continues
    again = _trainer(tmp_path / "faulty")
    assert again.init_or_restore() == 6
    for n, p in again.state["params"].items():
        assert torch.equal(p, tr.state["params"][n]), n
    assert again.run(1) == [pytest.approx(again.history[0])]
    assert again.step == 7


def test_trainer_counters_and_loss_scale_event(tmp_path):
    _, ct = _reduced("bf16")
    before = {k: obs.counter(k).value for k in (
        "train_steps_total", "train_nonfinite_steps_total")}
    obs.clear()
    obs.enable()
    try:
        tr = Trainer(ct, AdamWConfig(), pipeline.DataConfig(
            vocab=512, seq_len=16, global_batch=2),
            TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu",
            master_weights=True,
            loss_scaling=tstep.LossScaleConfig(init_scale=2.0 ** 127))
        tr.run(2)
    finally:
        obs.disable()
    assert obs.counter("train_steps_total").value - \
        before["train_steps_total"] == 2
    assert obs.counter("train_nonfinite_steps_total").value - \
        before["train_nonfinite_steps_total"] == 2
    assert obs.histogram("train_step_seconds").to_dict()["count"] >= 2
    events = [r for r in obs.records() if r.name == "train.loss_scale"]
    assert [e.args["scale"] for e in events] == [2.0 ** 127, 2.0 ** 126]
    assert len(obs.spans("train.step")) == 2
    assert len(obs.spans("train.data")) == 2
    assert tr.state["opt"]["step"] == 0


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def test_launcher_trains_on_cpu(tmp_path, capsys):
    tr = launch_train.main(["--arch", "qwen2-1.5b-gspn", "--reduced",
                            "--device", "cpu", "--steps", "2", "--batch", "2",
                            "--seq", "16", "--ckpt-dir", str(tmp_path),
                            "--precision", "bf16", "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "qwen2-gspn-reduced on cpu" in out and "recoveries=0" in out
    assert "'gspn_scan_bwd': 8" in out
    assert tr.master_weights and tr.loss_scaling is not None
    assert tr.step == 2 and tr.ckpt.latest_step() == 2


def test_launcher_trains_the_attention_arch_on_cpu(tmp_path, capsys):
    """--arch qwen2-1.5b trains through get_arch and the trainer with no
    code of its own."""
    cuda_lib.clear_counts()
    tr = launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                            "cpu", "--steps", "2", "--batch", "2", "--seq",
                            "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "qwen2-reduced on cpu: 74128 parameters" in out
    assert "recoveries=0" in out
    assert tr.step == 2 and all(map(np.isfinite, tr.history))
    assert not cuda_lib.launch_counts and not cuda_lib.plain_calls


def test_example_trains_on_cpu(tmp_path, capsys):
    ex = _example()
    tr = ex.main(["--preset", "small", "--steps", "2", "--batch", "2",
                  "--seq", "32", "--device", "cpu", "--ckpt-dir",
                  str(tmp_path)])
    out = capsys.readouterr().out
    assert "mixer=gspn  device=cpu" in out and "over 2 steps" in out
    assert len(tr.history) == 2 and all(map(np.isfinite, tr.history))


def _example():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_points_need_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the entry points would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2-1.5b-gspn", "--reduced",
                           "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example().main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("flag", [
    ["--multi-pod"], ["--production-mesh"], ["--distributed"],
    ["--grad-compression", "int8_ef"], ["--tune-cache", "x.json"],
])
def test_unported_launcher_flags_do_not_parse(flag, tmp_path):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen2-1.5b-gspn", "--reduced",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path),
                           *flag])


def test_example_attention_mixer_waits_for_its_item(tmp_path, capsys):
    """``--mixer attn``, the reference example's default, trains since the
    attention kinds came (ROADMAP.md §1 item 3.2): a few steps on the
    CPU, finite losses and no scan."""
    cuda_lib.clear_counts()
    tr = _example().main(["--mixer", "attn", "--device", "cpu", "--steps",
                          "2", "--batch", "2", "--seq", "32", "--ckpt-dir",
                          str(tmp_path)])
    out = capsys.readouterr().out
    assert "small-attn" in out and "mixer=attn  device=cpu" in out
    assert len(tr.history) == 2 and all(map(np.isfinite, tr.history))
    assert not cuda_lib.plain_calls and not cuda_lib.launch_counts
    assert any(n.endswith("attn.wq") for n, _ in
               tr.model.named_parameters())
