"""The model axis of parallelism (ROADMAP.md §1 item 6.2, its model half)
against the reference on the CPU: ``parallel.tensor_parallel`` (the
vocab-parallel lookup and loss, the column- and row-parallel layers,
heads split over ``model``), the MoE's expert-parallel branch, the
train step on ``(data, model)`` meshes, the model-sharded checkpoint,
the converter's re-laid slabs and model shards, and the launcher's mesh;
the int8_ef step, whose scales take a MAX over the model axis, on
``(1, 2)`` and ``(2, 2)``.

Spawned: the same numpy inputs go through the reference on forced host
devices (``run_sub``) and through the port in gloo ranks
(``tests/test_torch_tp_worker.py``, one process a rank): 2 ranks for the
steps of ``qwen2-1.5b-gspn``, ``qwen2-1.5b``, ``zamba2-2.7b``,
``xlstm-1.3b``, ``whisper-base`` (encoder frames in the batch),
``qwen2-vl-72b`` (vision embeddings) and a whisper twin of 509 tokens
(embedding and head whole) reduced on ``(data 1, model 2)``, the MoE of
``grok-1-314b`` and ``kimi-k2-1t-a32b`` reduced at M = 2, the
vocab-parallel loss, the sharded prefill and decode (whisper's from
``lm_encode``, qwen2-vl's with vision embeddings), and a checkpoint
saved on ``(1, 2)`` and restored on ``(2, 1)``; 4 ranks for the steps on
``(2, 2)``, of ``qwen2-1.5b`` on ``(1, 4)`` (heads that straddle ranks),
of a 2-head xlstm twin on ``(1, 4)`` (its mixers whole on every rank)
and of a 2-head whisper twin on ``(1, 4)`` (half a head a rank in its
self-, cross- and encoder attention), the prefill and decode of those
twins and of qwen2-vl (caches split by positions), grok at M = 4 (ep 4)
and a variant with E = 2 at M = 4 (ep 2, tp 2: the hidden split).
Beside them, the train launcher's ``--distributed`` on reduced zamba2
and whisper over ``(data 1, model 2)``: 3 steps straight, and 2 then a
resumed 1.  In process: the port's one-rank step and MoE at M = 1 on the
same weights, the checkpoints restored on one rank, the configs the
model axis takes at M = 2, 4 and 16, ``gspn_impl="sp"`` that raises.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import pathlib
import re
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline
from repro_torch.launch import mesh as lmesh
from repro_torch.models import lm
from repro_torch.models.attention import kv_split
from repro_torch.models.convert import lm_state_from_jax, relayout_slab
from repro_torch.optim.adamw import AdamWConfig, lr_at
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.train import step as tstep

HERE = pathlib.Path(__file__).resolve().parent
WORKER = HERE / "test_torch_tp_worker.py"
sys.path.insert(0, str(HERE))
import test_torch_dp as DP  # noqa: E402
import test_torch_tp_worker as W  # noqa: E402

NOISE_FLOOR = 1e-5
STEP_CASES = [(arch, shape) for k in (2, 4) for arch, shape in W.STEPS[k]]
INT8_CASES = [(arch, shape) for k in (2, 4) for arch, shape in W.INT8[k]]
MOE_CASES = {name: (arch, m, changes) for k in (2, 4)
             for name, arch, m, changes in W.MOE[k]}
SERVE_CASES = {name: (arch, changes, k) for k, cases in W.SERVE.items()
               for name, arch, changes in cases}
SEQ, MOE_SEQ = 24, 16


def _jcfg(arch, **changes):
    arch, twin = W.TWINS.get(arch, (arch, {}))
    return dataclasses.replace(
        jbase.with_precision(jbase.get_arch(arch).reduced(), "f32"),
        remat="unit", **twin, **changes)


def _paths(params) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _batch(seq, seed=0, cfg=None):
    """Two rows of ``seq`` tokens over ``cfg``'s vocabulary (512 without
    one), with its family's vision embeddings (half the rows' positions)
    or encoder frames."""
    vlm, audio = cfg is not None and cfg.family == "vlm", \
        cfg is not None and cfg.family == "audio"
    dcfg = pipeline.DataConfig(
        vocab=512 if cfg is None else cfg.vocab, seq_len=seq, global_batch=2,
        seed=seed, vision_len=seq // 2 if vlm else 0,
        enc_len=cfg.enc_len if audio else 0,
        d_model=0 if cfg is None else cfg.d_model)
    return pipeline.host_batch(dcfg, 0)


def _moe_params(name):
    arch, m, changes = MOE_CASES[name]
    return jlm.init_lm(jax.random.PRNGKey(1),
                       _jcfg(arch, n_model_shards=m, **changes))


def _serve_params(arch, changes):
    return jlm.init_lm(jax.random.PRNGKey(4), _jcfg(arch, **changes))


def _inputs() -> dict:
    d = {}
    for arch in {a for a, _ in STEP_CASES}:
        for k, v in _paths(jlm.init_lm(jax.random.PRNGKey(0),
                                       _jcfg(arch))).items():
            d[f"jax/{arch}/{k}"] = v
        for k, v in _batch(SEQ, cfg=_jcfg(arch)).items():
            d[f"batch/{arch}/{k}"] = v
    for name in MOE_CASES:
        for k, v in _paths(_moe_params(name)).items():
            d[f"jax/{name}/{k}"] = v
        for k, v in _batch(MOE_SEQ, seed=3).items():
            d[f"batch/{name}/{k}"] = v
    rng = np.random.default_rng(0)
    # The VL and audio cases draw from a generator of their own.
    rng_x = np.random.default_rng(1)
    for name, (arch, changes, _) in SERVE_CASES.items():
        for k, v in _paths(_serve_params(arch, changes)).items():
            d[f"jax/serve_{name}/{k}"] = v
        cfg = _jcfg(arch, **changes)
        gen = rng if cfg.family not in ("vlm", "audio") else rng_x
        d[f"serve/{name}/tokens"] = gen.integers(
            0, 512, (2, W.PROMPT + W.DECODE_STEPS)).astype(np.int32)
        if cfg.family == "vlm":
            d[f"serve/{name}/vision_embeds"] = gen.standard_normal(
                (2, W.VISION, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            d[f"serve/{name}/enc_frames"] = gen.standard_normal(
                (2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    d["ce/logits"] = rng.standard_normal((2, 6, 64)).astype(np.float32) * 3
    d["ce/labels"] = rng.integers(0, 64, (2, 6)).astype(np.int32)
    d["ce/mask"] = (rng.random((2, 6)) < 0.6).astype(np.float32)
    d["ce/table"] = rng.standard_normal((64, 8)).astype(np.float32)
    return d


JAX_BODY = """
    import dataclasses, json
    from repro.configs import base as jbase
    from repro.launch.mesh import make_mesh_for_devices
    from repro.models import lm as jlm
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel import sharding as shd
    from repro.train.step import build_train_step
    from jax.sharding import NamedSharding, PartitionSpec as P

    inp = dict(np.load(IN))
    out = {}

    def jcfg(arch, **changes):
        arch, twin = TWINS.get(arch, (arch, {}))
        return dataclasses.replace(jbase.with_precision(
            jbase.get_arch(arch).reduced(), "f32"), remat="unit", **twin,
            **changes)

    def batch(key):
        return {k: jnp.asarray(inp[f"batch/{key}/{k}"])
                for k in ("tokens", "labels") + EXTRA
                if f"batch/{key}/{k}" in inp}

    for arch, shape, comp in STEPS:
        cfg = jcfg(arch)
        params = jlm.init_lm(jax.random.PRNGKey(0), cfg)
        ocfg = AdamWConfig(**OPT)
        state = {"params": params, "opt": adamw_init(ocfg, params)}
        n = shape[0] * shape[1]
        mesh = make_mesh(tuple(shape), ("data", "model"),
                         devices=jax.devices()[:n])
        ps = shd.param_shardings(params, mesh)
        ssh = {"params": ps, "opt": {"m": ps, "v": ps,
                                     "step": NamedSharding(mesh, P())}}
        if comp == "int8_ef":
            state["errors"] = jax.tree.map(jnp.zeros_like, params)
            ssh["errors"] = ps
        b = batch(arch)
        with set_mesh(mesh):
            bs = shd.batch_shardings(b, mesh, ("data",))
            step = jax.jit(build_train_step(cfg, ocfg, mesh=mesh,
                                            dp_axes=("data",),
                                            grad_compression=comp),
                           in_shardings=(ssh, bs), out_shardings=(ssh, None))
            state, m = step(state, b)
        tag = f"{'step' if comp == 'none' else comp}/{arch}/" \
              f"{shape[0]}x{shape[1]}"
        out[f"{tag}/loss"] = float(m["loss"])
        out[f"{tag}/grad_norm"] = float(m["grad_norm"])
        for i, leaf in enumerate(jax.tree.leaves(state["params"])):
            out[f"{tag}/leaf/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(state.get("errors", {}))):
            out[f"{tag}/err/{i}"] = np.asarray(leaf)

    for name, (arch, m, changes) in MOE.items():
        cfg = jcfg(arch, n_model_shards=m, **changes)
        params = jlm.init_lm(jax.random.PRNGKey(1), cfg)
        mesh = make_mesh((1, m), ("data", "model"), devices=jax.devices()[:m])
        ctx = jlm.Ctx(mesh=mesh, dp_axes=("data",))
        with set_mesh(mesh):
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                lambda p: jlm.lm_loss(p, cfg, batch(name), ctx),
                has_aux=True))(params)
        out[f"moe/{name}/loss"] = float(loss)
        out[f"moe/{name}/aux"] = float(metrics["aux"])
        for i, leaf in enumerate(jax.tree.leaves(grads)):
            out[f"moe/{name}/leaf/{i}"] = np.asarray(leaf)

    for n in range(1, 9):
        mm = make_mesh_for_devices(jax.devices()[:n],
                                   model_parallel=min(16, n))
        out[f"mesh/{n}"] = json.dumps([list(mm.devices.shape),
                                       list(mm.axis_names)])
    np.savez(OUT, **out)
"""


STEPS = [(arch, shape, "none") for arch, shape in STEP_CASES] + \
    [(arch, shape, "int8_ef") for arch, shape in INT8_CASES]


# The train launcher on reduced zamba2 and whisper over 2 ranks: (data 1,
# model 2), with int8 error feedback (its residuals ride in the
# checkpoint).
def _launch(arch):
    return ["-m", "repro_torch.launch.train", "--distributed", "--arch",
            arch, "--reduced", "--device", "cpu", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--grad-compression", "int8_ef"]


LAUNCHED = ("zamba2-2.7b", "whisper-base")


@pytest.fixture(scope="module")
def runs(run_sub, tmp_path_factory):
    """The reference's run, the worker in 2 ranks then 4, and the
    launcher's runs of each of ``LAUNCHED`` (3 steps straight; 2 steps,
    then 1 resumed): zamba2's started with the 2 ranks, whisper's with
    the 4."""
    d = tmp_path_factory.mktemp("tp")
    inputs = d / "inputs.npz"
    np.savez(inputs, **_inputs())
    scratch = d / "scratch"
    scratch.mkdir()

    def ckpt(arch, name):
        return scratch / f"launch_{name}_{arch}"

    def launch(arch):
        return [DP._start(2, _launch(arch) + ["--steps", str(n),
                                              "--ckpt-dir", ckpt(arch, name)])
                for n, name in ((3, "straight"), (2, "split"))]

    def resume(arch, pair):
        logs = [DP._join(p)[0] for p in pair]
        return logs, DP._start(2, _launch(arch) + [
            "--steps", "1", "--ckpt-dir", ckpt(arch, "split")])

    zamba, whisper = LAUNCHED
    two = DP._start(2, [WORKER, inputs, d / "torch2.npz", scratch])
    launches = {zamba: launch(zamba)}
    logs = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(
            run_sub, f"IN, OUT = {str(inputs)!r}, {str(d / 'jax.npz')!r}\n"
                     f"OPT = {W.OPT!r}\nSTEPS = {STEPS!r}\n"
                     f"MOE = {MOE_CASES!r}\nTWINS = {W.TWINS!r}\n"
                     f"EXTRA = {W.EXTRA!r}\n"
                     + textwrap.dedent(JAX_BODY),
            timeout=600)
        try:
            DP._join(two)
            four = DP._start(4, [WORKER, inputs, d / "torch4.npz", scratch])
            launches[whisper] = launch(whisper)
            resumed = {}
            for arch in LAUNCHED:
                logs[arch], resumed[arch] = resume(arch, launches[arch])
            DP._join(four)
            for arch in LAUNCHED:
                logs[arch].append(DP._join(resumed[arch])[0])
        finally:
            ref.result()
    mine = dict(np.load(d / "torch2.npz"))
    mine.update(np.load(d / "torch4.npz"))
    return {"jax": dict(np.load(d / "jax.npz")), "torch": mine,
            "inputs": dict(np.load(inputs)), "scratch": scratch,
            "launch": logs, "ckpt": ckpt, "memo": {}}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


def _tree(jparams, leaves):
    tree = jax.tree.structure(jparams)
    return jax.tree.unflatten(tree, leaves)


# ---------------------------------------------------------------------------
# The vocabulary.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_loss_matches_jax(runs, m, masked):
    """The loss over vocab-sharded logits against the reference's
    ``cross_entropy_loss`` on the whole: loss 1e-5, gradient 1e-4 of its
    largest; the vocab-parallel lookup gives the table's rows exactly."""
    inp, mine = runs["inputs"], runs["torch"]
    mask = jnp.asarray(inp["ce/mask"]) if masked else None
    loss, grad = jax.value_and_grad(lambda z: jlayers.cross_entropy_loss(
        z, jnp.asarray(inp["ce/labels"]), mask))(jnp.asarray(inp["ce/logits"]))
    np.testing.assert_allclose(mine[f"ce/{m}/{masked}/loss"], float(loss),
                               rtol=1e-5)
    _close(mine[f"ce/{m}/{masked}/grad"], grad, 1e-4, "grad")
    assert bool(mine[f"ce/{m}/embed_equal"])


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------

def _once(runs, fn, arch, *args):
    """``fn(arch, runs["inputs"], *args)``, computed once a module run: the
    same CPU program on the same inputs for every test that reads it."""
    key = (fn.__name__, arch, *args)
    if key not in runs["memo"]:
        runs["memo"][key] = fn(arch, runs["inputs"], *args)
    return runs["memo"][key]


def _one_rank(arch, inp, comp="none"):
    """The port's one-rank step on the whole batch from the reference's
    weights: (loss, grad_norm, parameters, int8 residuals or None)."""
    setup = tstep.make_train_setup(W.config(arch), AdamWConfig(**W.OPT),
                                   device="cpu", grad_compression=comp)
    W.load_whole(setup, lm_state_from_jax(W.tree(inp, f"jax/{arch}")))
    _, m = setup.train_step(setup.state, W.batch_of(inp, f"batch/{arch}"))
    errors = setup.state.get("errors")
    return float(m["loss"]), float(m["grad_norm"]), {
        n: p.detach().numpy() for n, p in setup.state["params"].items()}, \
        None if errors is None else {n: e.numpy() for n, e in errors.items()}


def _grads0(arch, inp):
    cj = _jcfg(arch)
    params = jlm.init_lm(jax.random.PRNGKey(0), cj)
    b = {k: jnp.asarray(v.numpy()) for k, v in W.batch_of(
        inp, f"batch/{arch}").items()}
    return {n: t.numpy() for n, t in lm_state_from_jax(jax.tree.map(
        np.asarray, jax.grad(lambda p: jlm.lm_loss(p, cj, b)[0])(
            params))).items()}


def _adamw_noise(g, grad_norm):
    """How far AdamW's first step moves an element under a change of its
    gradient by 1e-5 of its leaf's largest (the noise floor): the update
    ``lr · ĝ / (|ĝ| + eps)`` of the clipped gradient ĝ turns steeply
    where |ĝ| is a few eps (an attention key bias's gradients reach
    1e-7 beside a largest of 1e-2)."""
    ocfg = AdamWConfig(**W.OPT)
    lr = float(lr_at(ocfg, 1))
    gc = np.abs(g) * min(1.0, ocfg.grad_clip / grad_norm)
    return lr * ocfg.eps / (gc + ocfg.eps) ** 2 * NOISE_FLOOR * gc.max()


@pytest.mark.parametrize("against", ["jax", "one_rank"])
@pytest.mark.parametrize("arch,shape", STEP_CASES)
def test_tp_step_matches(runs, arch, shape, against):
    """One AdamW step on a (data, model) mesh against the reference's
    step on the same mesh and against the port's one-rank step on the
    whole batch: loss 1e-5 relative, grad_norm 1e-6, parameters 1e-5 of
    their largest except elements whose gradient is below 1e-5 of their
    leaf's largest (the bounds of the data-parallel step) or whose update
    a gradient change of that size moves further (``_adamw_noise``)."""
    mine = runs["torch"]
    tag = f"step/{arch}/{shape[0]}x{shape[1]}"
    if against == "jax":
        ref = runs["jax"]
        loss, gn = ref[f"{tag}/loss"], ref[f"{tag}/grad_norm"]
        jp = jlm.init_lm(jax.random.PRNGKey(0), _jcfg(arch))
        n_leaves = len(jax.tree.leaves(jp))
        want = {n: t.numpy() for n, t in lm_state_from_jax(_tree(jp, [
            ref[f"{tag}/leaf/{i}"] for i in range(n_leaves)])).items()}
    else:
        loss, gn, want, _ = _once(runs, _one_rank, arch)
    np.testing.assert_allclose(mine[f"{tag}/loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(mine[f"{tag}/grad_norm"], gn, rtol=1e-6)
    g0 = _once(runs, _grads0, arch)
    for name, w in want.items():
        p, g = mine[f"{tag}/p/{name}"], g0[name]
        off = np.abs(p - w) > 1e-5 * np.abs(w).max() + _adamw_noise(g, gn)
        assert (np.abs(g[off]) <= NOISE_FLOOR * np.abs(g).max()).all(), name


@pytest.mark.parametrize("against", ["jax", "one_rank"])
@pytest.mark.parametrize("arch,shape", INT8_CASES)
def test_tp_int8_ef_step_matches(runs, arch, shape, against):
    """One int8 error-feedback step on a (data, model) mesh (each global
    leaf's scale from a MAX over the data and model axes) against the
    reference's int8_ef step on the same mesh and against the port's
    one-rank int8_ef step, with ``test_torch_dp``'s
    ``test_int8_ef_step_matches_jax`` bounds: loss and grad_norm 1e-5
    relative, every parameter within 1e-5 of its largest magnitude and
    every residual within 1e-5 of its reference leaf's largest gradient
    magnitude, except elements whose quantised gradient sits one int8
    step away where the other side's unquantised value lies within 1e-4
    of a step of a rounding boundary (its residual within 1e-4 of a step
    of half a step), the residuals then one step apart (reported)."""
    mine = runs["torch"]
    tag = f"int8_ef/{arch}/{shape[0]}x{shape[1]}"
    if against == "jax":
        ref = runs["jax"]
        loss, gn = ref[f"{tag}/loss"], ref[f"{tag}/grad_norm"]
        jp = jlm.init_lm(jax.random.PRNGKey(0), _jcfg(arch))
        n_leaves = len(jax.tree.leaves(jp))

        def leaves(key):
            return {n: t.numpy() for n, t in lm_state_from_jax(_tree(jp, [
                ref[f"{tag}/{key}/{i}"] for i in range(n_leaves)])).items()}

        want, errors = leaves("leaf"), leaves("err")
    else:
        loss, gn, want, errors = _once(runs, _one_rank, arch, "int8_ef")
    np.testing.assert_allclose(mine[f"{tag}/loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(mine[f"{tag}/grad_norm"], gn, rtol=1e-5)
    amax = tstep._leaf_amax({n: torch.from_numpy(g) for n, g in
                             _once(runs, _grads0, arch).items()})
    flips = 0
    for name, w in want.items():
        scale = max(float(amax[name]), 1e-12) / 127.0
        e, e_ref = mine[f"{tag}/e/{name}"], errors[name]
        boundary = np.abs(np.abs(e_ref) / scale - 0.5) < 1e-4
        off_e = np.abs(e - e_ref) > 1e-5 * 127.0 * scale
        p = mine[f"{tag}/p/{name}"]
        off_p = np.abs(p - w) > 1e-5 * np.abs(w).max()
        assert boundary[off_e].all() and boundary[off_p].all(), name
        np.testing.assert_allclose(np.abs(e - e_ref)[off_e], scale,
                                   rtol=1e-3, err_msg=name)
        flips += int(off_e.sum())
    print(f"tp int8_ef {tag} vs {against}: {flips} elements one int8 step "
          f"apart")


@pytest.mark.parametrize("arch,shape", STEP_CASES)
def test_placements_follow_the_rules(runs, arch, shape):
    """Every local tensor has the shape its placements give, the model
    axis splits some leaves, and the converter's model shard
    (``model_rank``) is the setup's model-local slice; the embedding and
    the head are vocab-parallel (the LM's ``tp`` set) exactly where the
    axis divides the vocabulary (not the 509 of a whisper twin)."""
    meta = json.loads(str(runs["torch"][
        f"step/{arch}/{shape[0]}x{shape[1]}/meta"]))
    assert meta["bad"] == []
    assert 0 < meta["n_model_sharded"] < meta["n_params"]
    assert meta["vocab_parallel"] == (W.config(arch).vocab % shape[1] == 0)


# ---------------------------------------------------------------------------
# The MoE's expert-parallel branch.
# ---------------------------------------------------------------------------

def _moe_one_rank(name, inp):
    """The port at M = 1, the slabs re-laid from M: loss, aux, gradients
    (the slabs' re-laid back to M)."""
    arch, m, changes = MOE_CASES[name]
    model = lm.LM(W.config(arch, **changes), device="meta")
    model.load_state_dict(lm_state_from_jax(W.tree(inp, f"jax/{name}"),
                                            n_model_shards=1), assign=True)
    loss, metrics = lm.lm_loss(model, W.batch_of(inp, f"batch/{name}"))
    loss.backward()
    e = model.cfg.n_experts
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad.numpy()
        if n.endswith("_slab"):
            g = relayout_slab(g, e, m, down=n.endswith("down_slab"))
        grads[n] = g
    return float(loss.detach()), float(metrics["aux"].detach()), grads


@pytest.mark.parametrize("against", ["jax", "one_rank"])
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_branch_matches(runs, name, against):
    """The sharded branch at M (grok at 2 and 4, kimi with its shared
    expert at 2, E = 2 at 4: ep 2, tp 2) against the reference's
    ``shard_map`` branch on the same mesh and against the port at M = 1
    with the slabs re-laid: loss and aux 1e-5, each gradient 1e-4 of its
    largest."""
    mine, inp = runs["torch"], runs["inputs"]
    if against == "jax":
        ref = runs["jax"]
        loss, aux = ref[f"moe/{name}/loss"], ref[f"moe/{name}/aux"]
        jp = _moe_params(name)
        grads = lm_state_from_jax(_tree(jp, [
            ref[f"moe/{name}/leaf/{i}"]
            for i in range(len(jax.tree.leaves(jp)))]))
        grads = {n: g.numpy() for n, g in grads.items()}
    else:
        loss, aux, grads = _moe_one_rank(name, inp)
    np.testing.assert_allclose(mine[f"moe/{name}/loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(mine[f"moe/{name}/aux"], aux, rtol=1e-5)
    assert aux > 0
    for n, g in grads.items():
        _close(mine[f"moe/{name}/g/{n}"], g, 1e-4, n)


def test_moe_refuses_shards_without_their_axis():
    """A layer laid out for 2 shards and no model axis of 2 raises (the
    reference then runs shard 0's slab alone)."""
    model = lm.LM(dataclasses.replace(tbase.get_arch(
        "kimi-k2-1t-a32b").reduced(), n_model_shards=2), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6.2"):
        lm.apply_lm(model, torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------------------
# Prefill and decode under the model axis.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_sharded_prefill_and_decode_match_jax(runs, name):
    """``lm_prefill`` and three ``lm_decode_step`` calls on (data 1, model
    M) against the reference's unsharded ones on the same weights, at M =
    2: the GSPN mixer whole on each rank, qwen2-1.5b's kv heads split,
    one kv head (the cache split by positions, the decode's softmax
    combined over the axis), grok's expert-parallel MoE, zamba2's and
    xlstm's heads a rank, whisper from ``lm_encode`` (its self- and
    cross-attention heads split) and qwen2-vl with vision embeddings; at
    M = 4 the 2-head xlstm whole on each rank, the 2-head whisper (half a
    head a rank) and qwen2-vl, both caches split by positions.  Logits
    and whisper's ``enc_kv`` within 1e-5 of their largest, each rank's
    cache shapes those of ``cache_shardings``, each KV cache gathered and
    each recurrent cache leaf within 1e-5 of the reference's, every
    rank's ``enc_kv`` and whole cache leaves bit-equal after the prefill
    and each step; ``lm_prefill_chunk`` refuses the sharded model, and
    so does the engine (whisper's for its encoder, on any mesh)."""
    from repro_torch.parallel.sharding import cache_shardings

    mine, inp = runs["torch"], runs["inputs"]
    arch, changes, m = SERVE_CASES[name]
    cfg = _jcfg(arch, **changes)
    params = _serve_params(arch, changes)
    tokens = jnp.asarray(inp[f"serve/{name}/tokens"])
    tag = f"serve/{name}"
    extra = {k: jnp.asarray(inp[f"{tag}/{k}"]) for k in W.EXTRA
             if f"{tag}/{k}" in inp}
    logits, caches, enc_kv = jlm.lm_prefill(
        params, cfg, tokens[:, :W.PROMPT], max_len=W.MAX_LEN, **extra)
    assert (enc_kv is not None) == ("enc_frames" in extra)
    for n, t in zip("kv", enc_kv or ()):
        _close(mine[f"{tag}/enc_kv/{n}"], t, 1e-5, f"enc_kv {n}")
    _close(mine[f"{tag}/prefill"], logits, 1e-5, "prefill")
    for i in range(W.DECODE_STEPS):
        logits, caches = jlm.lm_decode_step(
            params, cfg, tokens[:, W.PROMPT + i:W.PROMPT + i + 1], caches,
            enc_kv=enc_kv)
        _close(mine[f"{tag}/decode{i}"], logits, 1e-5, f"decode {i}")
    tcfg = W.config(arch, **changes)
    whole = {k: {n: tuple(v.shape) for n, v in sub.items()} for k, sub in
             lm.init_lm_cache(tcfg, 2, W.MAX_LEN, device="meta").items()}
    specs = cache_shardings(whole, {"data": 1, "model": m})
    want = {k: {n: [d // m if s == "model" else d
                    for d, s in zip(whole[k][n], specs[k][n])]
                for n in sub} for k, sub in whole.items()}
    assert json.loads(str(mine[f"{tag}/shapes"])) == want
    kv = [(k, n) for k, sub in whole.items() for n in sub if n in ("k", "v")]
    assert bool(kv) == (arch not in ("qwen2-1.5b-gspn", "xlstm-1.3b"))
    for key, n in kv:
        _close(mine[f"{tag}/cache/{key}/{n}"], caches[key]["attn"][n],
               1e-5, f"cache {key}/{n}")
    recurrent = [(k, n) for k, sub in whole.items() for n in sub
                 if k.endswith(("_mamba", "_mlstm", "_slstm"))]
    assert bool(recurrent) == (arch in ("zamba2-2.7b", "xlstm-1.3b"))
    for key, n in recurrent:
        _close(mine[f"{tag}/cache/{key}/{n}"], caches[key][n], 1e-5,
               f"cache {key}/{n}")
    assert json.loads(str(mine[f"{tag}/agree"])) == [True] * (
        1 + W.DECODE_STEPS)
    # The engine refuses an encoder-decoder model on any mesh (requests
    # carry no frames), with a ValueError before it looks at the axis.
    assert json.loads(str(mine[f"{tag}/refused"])) == {
        "chunk": "NotImplementedError",
        "engine": "ValueError" if cfg.encoder_layers
        else "NotImplementedError"}


# ---------------------------------------------------------------------------
# Checkpoints, the launcher's mesh, the kinds that raise.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["one_rank", "data2_model1"])
def test_checkpoint_saved_on_1x2_restores_bit_equal(runs, layout):
    """The state saved on (data 1, model 2) after a step, restored on one
    rank (in process) and on (data 2, model 1) (gathered): every
    parameter and moment bit for bit."""
    mine = runs["torch"]
    if layout == "one_rank":
        setup = tstep.make_train_setup(W.config("qwen2-1.5b-gspn"),
                                       AdamWConfig(**W.OPT), device="cpu",
                                       seed=7)
        _, step = CheckpointManager(str(runs["scratch"] / "ck_tp")).restore(
            target=setup.state)
        items = [(f"params/{n}", t.detach().numpy())
                 for n, t in setup.state["params"].items()]
        items += [(f"opt/{m}/{n}", t.numpy()) for m in ("m", "v")
                  for n, t in setup.state["opt"][m].items()]
    else:
        step = int(mine["ck/restored/step"])
        items = [(k[len("ck/restored/"):], v) for k, v in mine.items()
                 if k.startswith("ck/restored/") and k != "ck/restored/step"]
    assert step == 1 and len(items) > 3 * 10
    for k, v in items:
        np.testing.assert_array_equal(v, mine[f"ck/saved/{k}"], err_msg=k)


@pytest.mark.parametrize("n", range(1, 9))
def test_launcher_mesh_matches_jax(runs, n):
    """The launcher's mesh over n ranks, ``model_parallel=min(16, n)``:
    the reference's shape and axis names."""
    want = json.loads(str(runs["jax"][f"mesh/{n}"]))
    dims = lmesh.mesh_dims_for(n, model_parallel=min(16, n))
    assert [list(dims[0]), list(dims[1])] == want


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_recurrent_kinds_run_under_the_model_axis(arch, m):
    """mamba, mlstm and slstm (and zamba2's shared attention block) pass
    ``check_model_axis`` at M = 2, 4 and 16, reduced and full; the full
    configs' mixers run their own heads where M divides them (zamba2's
    80 at every M, xlstm's 4 at 2 and 4) and whole at xlstm's M = 16."""
    for cfg in (tbase.get_arch(arch).reduced(), tbase.get_arch(arch).full(
            n_model_shards=m)):
        tpar.check_model_axis(cfg, m)
    split = tpar.head_split(cfg.n_heads, m)
    assert (split is None) == (arch == "xlstm-1.3b" and m == 16)
    if split is not None:
        assert split[-1] == (cfg.n_heads - cfg.n_heads // m, cfg.n_heads)


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b"])
def test_vl_and_audio_run_under_the_model_axis(arch, m):
    """xattn, the audio encoder and the VL model pass
    ``check_model_axis`` at M = 2, 4 and 16, reduced and full.  The full
    configs at M = 16: whisper's 8 heads of 64 leave each rank half a
    head (32 rows of wo, 32 columns of enc_kv_proj) and its vocabulary of
    51 865 whole; qwen2-vl's 64 heads split 4 a rank; neither model's 8
    kv heads divide 16, so both KV caches split by positions there."""
    for cfg in (tbase.get_arch(arch).reduced(), tbase.get_arch(arch).full(
            n_model_shards=m)):
        tpar.check_model_axis(cfg, m)
    rows = cfg.n_heads * cfg.hd // m
    assert (rows % cfg.hd == 0) == (arch == "qwen2-vl-72b" or m < 16)
    assert (tpar.model_dim("embed", (cfg.vocab, cfg.d_model), m) is None) \
        == (arch == "whisper-base")
    assert kv_split(cfg.n_kv_heads, 32768, m) == (
        "seq" if m == 16 else "heads")


@pytest.mark.parametrize("arch,changes", [
    ("whisper-base", {}), ("qwen2-vl-72b", {}),
    ("qwen2-1.5b-gspn", {"gspn_impl": "sp"})])
def test_out_of_slice_kinds_raise(arch, changes):
    """``gspn_impl="sp"`` raises under a model axis of 2, naming item
    6.2; every other kind, whisper's and qwen2-vl's included, and one
    model rank do not, and a MoE laid out for another extent raises."""
    cfg = dataclasses.replace(tbase.get_arch(arch).reduced(), **changes)
    if changes:
        with pytest.raises(NotImplementedError, match="item 6.2"):
            tpar.check_model_axis(cfg, 2)
    else:
        tpar.check_model_axis(cfg, 2)
    tpar.check_model_axis(cfg, 1)
    for ok in ("qwen2-1.5b-gspn", "qwen2-1.5b", "zamba2-2.7b",
               "xlstm-1.3b", "whisper-base", "qwen2-vl-72b"):
        tpar.check_model_axis(tbase.get_arch(ok).reduced(), 2)
    with pytest.raises(ValueError, match="n_model_shards"):
        tpar.check_model_axis(tbase.get_arch("grok-1-314b").reduced(), 2)


def _launcher_resumes_bit_equal(runs, arch):
    """The straight and the resumed runs of ``arch``'s launcher on (data
    1, model 2): every loss finite, the resumed third step's loss the
    straight run's bit for bit, both step-3 checkpoints restored on one
    rank to the same parameters, moments and int8 residuals bit for
    bit."""
    straight, first, resumed = runs["launch"][arch]
    for log in runs["launch"][arch]:
        assert "mesh {'data': 1, 'model': 2}" in log, log[-2000:]

    def losses(log):
        return json.loads(re.search(r"losses (\[[^\]]*\])", log).group(1))

    assert "from step 0" in straight and "from step 2" in resumed
    want, head = losses(straight), losses(first)
    assert len(want) == 3 and np.isfinite(want).all()
    assert head == want[:2]
    assert losses(resumed) == want[2:]
    states = []
    for name in ("straight", "split"):
        setup = tstep.make_train_setup(
            tbase.get_arch(arch).reduced(), AdamWConfig(),
            device="cpu", seed=11, grad_compression="int8_ef")
        _, step = CheckpointManager(str(runs["ckpt"](arch, name))).restore(
            target=setup.state)
        assert step == 3, name
        states.append({f"{k}/{n}": t.detach().clone()
                       for k in ("params", "errors")
                       for n, t in setup.state[k].items()}
                      | {f"opt/{m}/{n}": t.clone() for m in ("m", "v")
                         for n, t in setup.state["opt"][m].items()})
    assert states[0].keys() == states[1].keys() and len(states[0]) > 30
    for k, t in states[0].items():
        assert torch.equal(t, states[1][k]), k
    assert any(t.any() for k, t in states[0].items()
               if k.startswith("errors/"))


def test_launcher_trains_zamba2_on_the_model_axis_and_resumes_bit_equal(
        runs):
    """``launch.train --distributed --grad-compression int8_ef`` on
    reduced zamba2 over 2 gloo ranks, laid out as (data 1, model 2) (its
    mamba mixers on their own heads, the shared attention block's heads
    split): 3 steps straight, and 2 steps then a launch that resumes from
    the model-sharded checkpoint at step 2 and takes the third
    (:func:`_launcher_resumes_bit_equal`)."""
    _launcher_resumes_bit_equal(runs, "zamba2-2.7b")


def test_launcher_trains_whisper_on_the_model_axis_and_resumes_bit_equal(
        runs):
    """The same on reduced whisper: its encoder frames in every batch,
    the encoder, self- and cross-attention and ``enc_kv_proj`` split over
    (data 1, model 2)."""
    _launcher_resumes_bit_equal(runs, "whisper-base")
