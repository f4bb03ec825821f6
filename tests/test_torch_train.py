"""The port's training path against the JAX reference package: the
gradients of ``vision_loss``, AdamW, and the trainer twin
``examples/train_vision_torch.py`` against the reference example's step.

Parity goes through converted parameters; JAX gradients map onto the
port's names through the same converter.  Tolerances: gradients 1e-4 of
each leaf's largest magnitude (convolutions and matrix products sum in
another order than XLA's), AdamW 1e-6, the twin's losses 1e-4 relative.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gspn2_vision as jconfigs
from repro.configs import qwen2_1_5b as jqa
from repro.configs import qwen2_1_5b_gspn as jq
from repro.models import lm as jlm
from repro.models import vision as jvision
from repro.optim import adamw as jadamw
from repro_torch.configs import gspn2_vision as configs
from repro_torch.configs import qwen2_1_5b as tqa
from repro_torch.configs import qwen2_1_5b_gspn as tq
from repro_torch.data import pipeline
from repro_torch.kernels import cuda_lib
from repro_torch.models import lm as tlm
from repro_torch.models import vision
from repro_torch.models.convert import lm_state_from_jax, vision_state_from_jax
from repro_torch.optim import adamw

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced():
    """The reference's reduced model: config, parameters, and its jitted
    loss-and-gradient function, shared by every test here.  The parameters
    are numpy draws in the reference's shapes (compiling its initialiser
    would cost more than every test here): layernorm scales near 1,
    everything else small."""
    jcfg = jconfigs.reduced_vision()
    shapes = jax.eval_shape(lambda k: jvision.init_vision(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(float("scale" in jax.tree_util.keystr(path))
                    + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        for path, leaf in flat])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jvision.vision_loss(p, jcfg, b), has_aux=True))
    return jcfg, params, grad_fn


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ported(params):
    model = vision.GSPNVision(configs.reduced_vision(), device="cpu")
    model.load_state_dict(vision_state_from_jax(_np(params)), strict=True)
    return model


def _batch(step, n=4, seed=0):
    return pipeline.synth_images(pipeline.DataConfig(1, 1, n, seed=seed),
                                 step, 32, 10)


def _twin():
    path = ROOT / "examples" / "train_vision_torch.py"
    spec = importlib.util.spec_from_file_location("train_vision_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def _jit_update(cfg):
    """The reference's update, jitted once per configuration: eagerly its
    many small ops each compile on first use."""
    return jax.jit(functools.partial(jadamw.adamw_update, cfg))


def _assert_leafwise_close(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].detach()
        bound = tol * max(w.abs().max().item(), 1e-12)
        err = (g - w).abs().max().item()
        assert err <= bound, (name, err, bound)


def test_vision_loss_gradients_match_reference(reduced):
    """The repair: ``vision_loss`` builds a graph, and its gradients equal
    ``jax.grad`` of the reference's loss through the scan adjoints."""
    jcfg, params, grad_fn = reduced
    b = _batch(0, seed=5)
    (want_loss, _), want = grad_fn(params, {k: jnp.asarray(v)
                                            for k, v in b.items()})
    model = _ported(params)
    cuda_lib.clear_counts()
    loss, _ = vision.vision_loss(model, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
    assert loss.requires_grad
    loss.backward()
    n = 2 * sum(jcfg.depths)
    assert cuda_lib.plain_calls == {"gspn_pair_fwd": n, "gspn_pair_bwd": n}
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_leafwise_close({k: p.grad for k, p in model.named_parameters()},
                           vision_state_from_jax(_np(want)), 1e-4)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=4, total_steps=17, schedule=schedule,
              min_lr_ratio=0.2)
    mine = adamw.AdamWConfig(**kw)
    theirs = jadamw.AdamWConfig(**kw)
    for step in range(0, 22):
        got = adamw.lr_at(mine, step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.item(), float(jadamw.lr_at(theirs, jnp.int32(step))),
            rtol=1e-6, atol=0)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    got, norm = adamw.clip_by_global_norm(map(torch.from_numpy, leaves), 0.5)
    want, jnorm = jadamw.clip_by_global_norm([jnp.asarray(a) for a in leaves],
                                             0.5)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_decayed_names_match_reference_mask(reduced):
    """The port decays what the reference decays, leaf by leaf, although
    the reference's block leaves carry one more (depth) dimension, two in
    an LM's unit stage."""
    _, params, _ = reduced
    flat, treedef = jax.tree_util.tree_flatten_with_path(_np(params))
    masks = [np.full(leaf.shape, float(jadamw._decay_mask(path)
                                       and leaf.ndim >= 2), np.float32)
             for path, leaf in flat]
    state = vision_state_from_jax(jax.tree_util.tree_unflatten(treedef,
                                                               masks))
    want = {k for k, v in state.items() if bool(v.all())}
    assert not any(v.any() and not v.all() for v in state.values())
    model = _ported(params)
    got = {n for n, p in model.named_parameters() if adamw.decays(n, p)}
    assert got == want
    # The trap: a block's depthwise bias is (C,) here, (depth, C) there.
    assert "stages.0.blocks.0.lpu.b" in got and "stem.b" not in got

    # The LM's trees: a unit stage stacks its blocks along (n_units, n),
    # a prelude stage along (n,); every leaf against the reference's mask
    # and ndim rule.
    reduced_lm = jq.reduced()
    for jcfg in (reduced_lm, dataclasses.replace(
            reduced_lm, prelude=(("gspn", 1),), unit=(("gspn", 2),),
            n_units=2, n_layers=5)):
        shapes = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg),
                                jax.random.PRNGKey(0))
        flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        masks = [np.full(leaf.shape, float(jadamw._decay_mask(path)
                                           and leaf.ndim >= 2), np.float32)
                 for path, leaf in flat]
        state = lm_state_from_jax(jax.tree_util.tree_unflatten(treedef,
                                                               masks))
        assert not any(v.any() and not v.all() for v in state.values())
        model = tlm.LM(dataclasses.replace(
            tq.reduced(), prelude=jcfg.prelude, unit=jcfg.unit,
            n_units=jcfg.n_units, n_layers=jcfg.n_layers), device="meta")
        got = {n for n, p in model.named_parameters() if adamw.decays(n, p)}
        assert got == {k for k, v in state.items() if bool(v.all())}
        assert model.state_dict().keys() == state.keys()
        assert "embed" in got and "ln_f.scale" not in got
        assert not any(n.endswith(".scale") for n in got)
        assert any(n.endswith("mix.w_row") for n in got)
    assert adamw.reference_leaf("stages.s0_gspn.1.ln1.scale") == (
        "stages/s0_gspn/ln1/scale", 1)
    assert adamw.reference_leaf("stages.s1_gspn.0.1.mix.up") == (
        "stages/s1_gspn/mix/up", 2)
    assert adamw.reference_leaf("stages.2.blocks.1.lpu.b") == (
        "stages/2/blocks/lpu/b", 1)

    # The attn kind's tree (reduced qwen2-1.5b): no mask token matches
    # bq, bk or bv and their stacked leaves have two dimensions or more,
    # so the reference decays the qkv biases, and so must the port; the
    # norms it does not.
    jcfg = jqa.reduced()
    shapes = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg),
                            jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    masks = [np.full(leaf.shape, float(jadamw._decay_mask(path)
                                       and leaf.ndim >= 2), np.float32)
             for path, leaf in flat]
    state = lm_state_from_jax(jax.tree_util.tree_unflatten(treedef, masks))
    assert not any(v.any() and not v.all() for v in state.values())
    model = tlm.LM(tqa.reduced(), device="meta")
    assert model.state_dict().keys() == state.keys()
    got = {n for n, p in model.named_parameters() if adamw.decays(n, p)}
    assert got == {k for k, v in state.items() if bool(v.all())}
    for u in range(2):
        for b in ("bq", "bk", "bv"):
            assert f"stages.s0_attn.0.{u}.attn.{b}" in got
        for norm in ("ln1", "ln2"):
            assert f"stages.s0_attn.0.{u}.{norm}.scale" not in got
    assert "ln_f.scale" not in got


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_updates_match_reference(reduced, n_steps):
    """Identical numpy gradients (large enough that clipping acts) through
    the reference's pure update and the port's in-place one."""
    _, params, _ = reduced
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    model = _ported(params)
    mine = dict(model.named_parameters())
    state = adamw.adamw_init(cfg, mine)
    jparams, jstate = params, jadamw.adamw_init(jcfg, params)
    rng = np.random.default_rng(n_steps)
    for _ in range(n_steps):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            _np(params))
        stats = adamw.adamw_update(cfg, vision_state_from_jax(grads), state,
                                   mine)
        jparams, jstate, jstats = _jit_update(jcfg)(
            jax.tree.map(jnp.asarray, grads), jstate, jparams)
        np.testing.assert_allclose(stats["grad_norm"].item(),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        assert stats["step"] == int(jstats["step"])
    for got, want in ((mine, jparams), (state["m"], jstate["m"]),
                      (state["v"], jstate["v"])):
        want = vision_state_from_jax(_np(want))
        for name, w in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_twin_steps_match_reference_example(reduced):
    """Three steps of the twin's step function against three of the
    reference example's (``value_and_grad(vision_loss)`` + ``adamw_update``
    with the example's optimizer settings), from the same parameters."""
    _, params, grad_fn = reduced
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=3, weight_decay=0.01)
    jcfg = jadamw.AdamWConfig(**kw)
    jopt = jadamw.adamw_init(jcfg, params)
    model = _ported(params)
    twin = _twin()
    step, _ = twin.make_step(model, adamw.AdamWConfig(**kw))
    got, want = [], []
    for s in range(3):
        b = _batch(s)
        got.append(step(twin.to_device(b, "cpu")).item())
        (loss, _), g = grad_fn(params, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        params, jopt, _ = _jit_update(jcfg)(g, jopt, params)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_twin_runs_on_cpu(capsys):
    """The twin's command line, two steps at batch 4 on the plain path."""
    twin = _twin()
    acc = twin.run(twin.parse_args(["--steps", "2", "--batch", "4",
                                    "--device", "cpu"]))
    assert 0.0 <= acc <= 1.0
    out = capsys.readouterr().out
    assert "on cpu" in out and "step    1" in out
