"""The data axis of parallelism (ROADMAP.md §1 item 6.2, its data half)
against the reference on the CPU: ``parallel.sharding``,
``parallel.collectives``, ``parallel.pipeline``, ``launch.mesh``, the
host slices of ``data.pipeline``, the sharded checkpoints, the
data-parallel train step, the elastic trainer and the launcher's
``--distributed``.

In process: every parameter's spec of every registry config's
``reduced()`` on four meshes against the reference's ``spec_for_param``
(a stub with ``.shape`` stands in for its mesh), the batch, cache and
sp-activation specs, ``quantize_int8`` bit for bit, the hosts' batch
slices and the prefetcher, the int8 error-feedback step against the
reference's single-device step, and a one-rank checkpoint of the old
layout.

Spawned: the same numpy inputs go through the reference on forced host
devices (``run_sub``) and through the port in gloo ranks
(``tests/test_torch_dp_worker.py``, one process a rank, as ``torchrun``
starts them): 2 ranks for the compressed all-reduce, the placements, the
sharded step (against the reference's on a ``("data",)`` mesh of 2 and
the port's one-rank step) and a sharded checkpoint; 4 ranks for its
restore, ``pipeline_apply``, the meshes and the elastic trainer; and the
train launcher with ``--distributed`` in 2 ranks, then resumed.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel import collectives as jcoll
from repro.parallel import sharding as jshd
from repro.train import step as jstep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline
from repro_torch.launch import mesh as lmesh
from repro_torch.models import lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import collectives, sharding
from repro_torch.train import step as tstep

HERE = pathlib.Path(__file__).resolve().parent
WORKER = HERE / "test_torch_dp_worker.py"
SRC = HERE.parent / "src"
sys.path.insert(0, str(HERE))
import test_torch_dp_worker as W  # noqa: E402

MESHES = {"data2": {"data": 2}, "data4": {"data": 4},
          "data4_model2": {"data": 4, "model": 2},
          "pod2_data2": {"pod": 2, "data": 2},
          "data1_model2": {"data": 1, "model": 2},
          "data2_model2": {"data": 2, "model": 2},
          "model4": {"model": 4}}
NOISE_FLOOR = 1e-5
ARCHS = tbase.list_archs()


class StubMesh:
    """What the reference's sharding functions read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _spec(p) -> tuple:
    """A reference PartitionSpec as a tuple, one-axis tuples as names."""
    return sharding.normalize(tuple(p))


def _trailing(spec, ndim):
    spec = tuple(spec) + (None,) * max(0, ndim - len(spec))
    return spec[len(spec) - ndim:]


def _ref_path(name: str) -> str:
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


# ---------------------------------------------------------------------------
# Specs, in process.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh):
    """Every parameter of the arch's reduced config: the port's spec
    equals the reference's on the leaf it comes from, the reference's
    stacking axes dropped (and the causal conv's dims reversed, as the
    port lays them out)."""
    shape = MESHES[mesh]
    cj = jbase.get_arch(arch).reduced()
    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: jlm.init_lm(k, cj), jax.random.PRNGKey(0)))[0]
    want = {}
    for path, leaf in leaves:
        spec = jshd.spec_for_param(path, leaf, StubMesh(shape))
        want[jshd.path_str(path)] = (_spec(spec), leaf.ndim)
    model = lm.LM(tbase.get_arch(arch).reduced(), device="meta")
    seen = set()
    for name, p in model.named_parameters():
        ref, ndim = want[_ref_path(name)]
        trailing = _trailing(ref, p.dim())
        if name.endswith("conv.w"):
            trailing = trailing[::-1]
        got = sharding.spec_for_param(name, p.shape, shape)
        assert got == trailing, (name, got, trailing)
        seen.add(_ref_path(name))
    assert seen == set(want)


@pytest.mark.parametrize("dp_axes,mesh", [
    (("data",), {"data": 2}), (("data",), {"data": 4, "model": 2}),
    (("pod", "data"), {"pod": 2, "data": 2}),
    (("data",), {"data": 3})])
def test_batch_specs_match_jax(dp_axes, mesh):
    shapes = {"tokens": (8, 32), "labels": (8, 32),
              "vision_embeds": (8, 16, 48), "odd": (6, 4)}
    got = sharding.batch_shardings(shapes, mesh, dp_axes)
    for k, s in shapes.items():
        ref = jshd.batch_shardings({k: jax.ShapeDtypeStruct(s, jnp.float32)},
                                   StubMesh(mesh), dp_axes)[k]
        assert sharding.normalize(got[k]) == _trailing(
            _spec(ref.spec), len(s)), k


class _NamedStub:
    """``jshd.batch_shardings`` builds ``NamedSharding``s; give it one
    that keeps the spec."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture(autouse=True)
def _stub_named_sharding(monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", _NamedStub)


@pytest.mark.parametrize("dp_axes,mesh", [
    (("data",), {"data": 2, "model": 1}),
    (("data",), {"data": 4, "model": 2}),
    (("pod", "data"), {"pod": 2, "data": 2, "model": 2})])
@pytest.mark.parametrize("arch", ["qwen2-1.5b-gspn", "qwen2-1.5b",
                                  "zamba2-2.7b", "xlstm-1.3b",
                                  "kimi-k2-1t-a32b", "whisper-base"])
def test_cache_specs_match_jax(arch, dp_axes, mesh):
    """The decode caches of a batch of 4 (the reference nests a KV cache
    one level deeper, under ``attn``)."""
    cj = jbase.get_arch(arch).reduced()
    want = jax.tree_util.tree_flatten_with_path(jshd.cache_shardings(
        jax.eval_shape(lambda: jlm.init_lm_cache(cj, 4, 16)),
        StubMesh(mesh), dp_axes))[0]
    want = {jshd.path_str(p).replace("/attn/", "/"): _spec(s.spec)
            for p, s in want}
    caches = lm.init_lm_cache(tbase.get_arch(arch).reduced(), 4, 16,
                              device="meta")
    got = sharding.cache_shardings(
        {k: {n: v.shape for n, v in sub.items()} for k, sub in
         caches.items()}, mesh, dp_axes)
    flat = {f"{k}/{n}": sharding.normalize(s) for k, sub in got.items()
            for n, s in sub.items()}
    assert set(flat) == set(want)
    for k, s in flat.items():
        assert s == _trailing(want[k], len(s)), k


@pytest.mark.parametrize("scan_dim,batch_dim", [(-2, 0), (1, 0), (-2, None)])
@pytest.mark.parametrize("mesh", [{"data": 2, "seq": 2}, {"seq": 4},
                                  {"data": 4}, {"pod": 2, "data": 2}])
def test_sp_activation_specs_match_jax(mesh, scan_dim, batch_dim):
    shapes = {"scan": (8, 12, 16), "vision": (4, 8, 8, 6), "flat": (8,)}
    got = sharding.sp_activation_shardings(
        shapes, mesh, scan_dim=scan_dim, batch_dim=batch_dim,
        dp_axes=("pod", "data"))
    for k, s in shapes.items():
        ref = jshd.sp_activation_shardings(
            jax.ShapeDtypeStruct(s, jnp.float32), StubMesh(mesh),
            scan_dim=scan_dim, batch_dim=batch_dim, dp_axes=("pod", "data"))
        assert sharding.normalize(got[k]) == _trailing(
            _spec(ref.spec), len(s)), k
        assert sharding.scan_dim_spec(len(s), scan_dim,
                                      batch_dim=batch_dim) == \
            _trailing(_spec(jshd.scan_dim_spec(len(s), scan_dim,
                                               batch_dim=batch_dim)),
                      len(s))


def test_sanitize_drops_axes_the_mesh_lacks_or_that_do_not_divide():
    mesh = {"data": 4, "model": 2}
    for spec, shape in ((("data", "model"), (8, 6)), (("seq", None), (4, 4)),
                        ((("pod", "data"), "model"), (8, 3)),
                        (("data",), (6, 2, 2)), (None, (4, 4))):
        want = jshd.sanitize_spec(None if spec is None else
                                  jax.sharding.PartitionSpec(*spec), shape,
                                  StubMesh(mesh))
        assert sharding.sanitize_spec(spec, shape, mesh) == _trailing(
            _spec(want), len(shape))


# ---------------------------------------------------------------------------
# int8 quantisation and data, in process.
# ---------------------------------------------------------------------------

def _quant_inputs():
    rng = np.random.default_rng(0)
    halves = (np.arange(-254, 255) / 2.0).astype(np.float32)
    return {"normal": rng.standard_normal((64, 33)).astype(np.float32),
            "ties": halves, "zeros": np.zeros((5, 7), np.float32),
            "tiny": (rng.standard_normal(50) * 1e-30).astype(np.float32),
            "bf16": rng.standard_normal((8, 8)).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_quant_inputs()))
def test_quantize_int8_bit_equal(case):
    x = _quant_inputs()[case]
    if case == "bf16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jcoll.quantize_int8(jx)
    q, s = collectives.quantize_int8(tx)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s.item()).tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        collectives.dequantize_int8(q, s).numpy(),
        np.asarray(jcoll.dequantize_int8(jq, js)))


@pytest.mark.parametrize("host", range(4))
def test_host_batch_matches_reference(host):
    """Host ``host`` of 4: the port's slice equals the reference's bit for
    bit, the vision and audio stubs included."""
    kw = dict(vocab=600, seq_len=12, global_batch=8, seed=2, n_hosts=4,
              host_id=host, vision_len=3, d_model=5, enc_len=4)
    got = pipeline.host_batch(pipeline.DataConfig(**kw), 7)
    want = jpipe.host_batch(jpipe.DataConfig(**kw), 7)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape[0] == 2
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pipeline.DataConfig(**kw).host_batch == 2


def test_prefetcher_yields_steps_in_order():
    cfg = pipeline.DataConfig(vocab=300, seq_len=8, global_batch=4,
                              n_hosts=2, host_id=1)
    pf = pipeline.Prefetcher(cfg, start_step=5, device="cpu")
    try:
        for want in range(5, 9):
            step, batch = next(pf)
            assert step == want
            ref = pipeline.host_batch(cfg, want)
            for k, v in ref.items():
                assert torch.equal(batch[k], torch.from_numpy(v)), k
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# The int8 error-feedback step against the reference's, in process.
# ---------------------------------------------------------------------------

OPT = W.OPT


def _reduced_pair():
    cj = dataclasses.replace(
        jbase.with_precision(jbase.get_arch("qwen2-1.5b-gspn").reduced(),
                             "f32"), remat="unit")
    return cj, W.config()


def _batches(n_steps, global_batch=4, seq=24):
    cfg = pipeline.DataConfig(vocab=512, seq_len=seq,
                              global_batch=global_batch)
    return [pipeline.host_batch(cfg, s) for s in range(n_steps)]


def test_int8_ef_step_matches_jax():
    """One int8 error-feedback step against the reference's
    single-device step: every parameter within 1e-5 of its largest
    magnitude, and every residual within 1e-5 of the leaf's largest
    gradient magnitude (the gradients themselves differ by up to 1e-6 of
    it), except elements whose quantised gradient sits one int8 step
    away where the reference's unquantised value lies within 1e-4 of a
    step of a rounding boundary (reported)."""
    cj, ct = _reduced_pair()
    params = jlm.init_lm(jax.random.PRNGKey(0), cj)
    jcfg = jadamw.AdamWConfig(**OPT)
    jstate = {"params": params, "opt": jadamw.adamw_init(jcfg, params),
              "errors": jax.tree.map(jnp.zeros_like, params)}
    b = _batches(1)[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    grads = jax.grad(lambda p: jlm.lm_loss(p, cj, jb)[0])(params)
    jstate, want = jax.jit(jstep.build_train_step(
        cj, jcfg, grad_compression="int8_ef"))(jstate, jb)
    model = lm.LM(ct, device="meta")
    model.load_state_dict(lm_state_from_jax(jax.tree.map(np.asarray,
                                                         params)),
                          assign=True)
    ocfg = AdamWConfig(**OPT)
    state = tstep.init_train_state(model, ocfg, grad_compression="int8_ef")
    state, got = tstep.build_train_step(model, ocfg,
                                        grad_compression="int8_ef")(
        state, {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    g_ref = lm_state_from_jax(jax.tree.map(np.asarray, grads))
    p_ref = lm_state_from_jax(jax.tree.map(np.asarray, jstate["params"]))
    e_ref = lm_state_from_jax(jax.tree.map(np.asarray, jstate["errors"]))
    flips = 0
    for name, g in g_ref.items():
        g = g.numpy().astype(np.float64)
        scale = max(np.abs(g).max(), 1e-12) / 127.0
        frac = np.abs(g / scale) % 1.0
        boundary = np.abs(frac - 0.5) < 1e-4
        e = state["errors"][name].numpy()
        off_e = np.abs(e - e_ref[name].numpy()) > 1e-5 * 127.0 * scale
        p, w = state["params"][name].detach().numpy(), p_ref[name].numpy()
        off_p = np.abs(p - w) > 1e-5 * np.abs(w).max()
        assert (boundary[off_e]).all() and (boundary[off_p]).all(), name
        # A flipped element's residual differs by exactly one step.
        np.testing.assert_allclose(np.abs(e - e_ref[name].numpy())[off_e],
                                   scale, rtol=1e-3)
        flips += int(off_e.sum())
    print(f"int8_ef: {flips} elements one int8 step from the reference's")


# ---------------------------------------------------------------------------
# Checkpoints, in process.
# ---------------------------------------------------------------------------

def test_one_rank_checkpoint_of_the_old_layout_restores(tmp_path):
    """A one-host checkpoint as the single-file layout writes it
    (``host_000.npz``, a manifest without slices) restores, and a
    one-host save still writes that layout."""
    sdir = tmp_path / "step_000000004"
    sdir.mkdir()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.savez(sdir / "host_000.npz", **{"params/w": a, "opt/step": np.array(4)})
    (sdir / "meta.json").write_text(json.dumps({
        "step": 4, "n_hosts": 1, "extra": {}, "time": 0.0,
        "keys": {"params/w": {"shape": [3, 4], "dtype": "float32"},
                 "opt/step": {"shape": [], "dtype": "int64"}}}))
    (sdir / "COMMIT").write_text("4")
    target = {"params": {"w": torch.zeros(3, 4)}, "opt": {"step": 0}}
    got, step = CheckpointManager(str(tmp_path)).restore(target=target)
    assert step == 4 and got["opt"]["step"] == 4
    assert torch.equal(got["params"]["w"], torch.from_numpy(a))
    ck = CheckpointManager(str(tmp_path / "new"), async_save=False)
    ck.save(1, target)
    files = sorted(os.listdir(tmp_path / "new" / "step_000000001"))
    assert files == ["COMMIT", "host_000.npz", "meta.json"]
    meta = json.loads((tmp_path / "new" / "step_000000001" /
                       "meta.json").read_text())
    assert all("parts" not in v for v in meta["keys"].values())


# ---------------------------------------------------------------------------
# Spawned runs.
# ---------------------------------------------------------------------------

JAX_BODY = """
    import dataclasses, json
    from repro.configs import base as jbase
    from repro.launch.mesh import make_mesh_for_devices
    from repro.models.lm import init_lm
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel import sharding as shd
    from repro.parallel.collectives import compressed_allreduce
    from repro.parallel.pipeline import pipeline_apply
    from repro.train.step import build_train_step
    from jax.sharding import NamedSharding, PartitionSpec as P

    inp = dict(np.load(IN))
    out = {}
    cm = make_mesh((2,), ("pod",), devices=jax.devices()[:2])
    with set_mesh(cm):
        fn = jax.jit(compressed_allreduce(cm, "pod"))
        for case in ("random", "zero", "one_zero"):
            g = jnp.asarray(inp[f"comp/{case}"])
            gh, e = fn(g, jnp.zeros_like(g))
            out[f"comp/{case}/g"] = np.asarray(gh)
            out[f"comp/{case}/e"] = np.asarray(e)

    cfg = dataclasses.replace(jbase.with_precision(
        jbase.get_arch("qwen2-1.5b-gspn").reduced(), "f32"), remat="unit")
    params = init_lm(jax.random.PRNGKey(0), cfg)
    ocfg = AdamWConfig(**OPT)
    state = {"params": params, "opt": adamw_init(ocfg, params)}
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    ps = shd.param_shardings(params, mesh)
    ssh = {"params": ps, "opt": {"m": ps, "v": ps,
                                 "step": NamedSharding(mesh, P())}}
    with set_mesh(mesh):
        for s in range(STEPS):
            batch = {k: jnp.asarray(inp[f"batch/{s}/{k}"])
                     for k in ("tokens", "labels")}
            bs = shd.batch_shardings(batch, mesh, ("data",))
            step = jax.jit(build_train_step(cfg, ocfg, mesh=mesh,
                                            dp_axes=("data",)),
                           in_shardings=(ssh, bs), out_shardings=(ssh, None))
            state, m = step(state, batch)
            out[f"jax/{s}/loss"] = float(m["loss"])
            out[f"jax/{s}/grad_norm"] = float(m["grad_norm"])
            for i, leaf in enumerate(jax.tree.leaves(state["params"])):
                out[f"jax/{s}/leaf/{i}"] = np.asarray(leaf)

    pm = make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
    with set_mesh(pm):
        out["pipe/y"] = np.asarray(pipeline_apply(
            pm, "pipe", lambda w, x: jnp.tanh(x @ w["w"]),
            {"w": jnp.asarray(inp["pipe/ws"])}, jnp.asarray(inp["pipe/x"]),
            n_micro=inp["pipe/x"].shape[0]))
    for n in (1, 2, 4, 8):
        for mp, sp in ((16, 1), (2, 1), (1, 2), (2, 2)):
            m = make_mesh_for_devices(jax.devices()[:n], model_parallel=mp,
                                      seq_parallel=sp)
            out[f"mesh/{n}/{mp}/{sp}"] = json.dumps(
                [list(m.devices.shape), list(m.axis_names)])
    np.savez(OUT, **out)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    d = {}
    g = rng.standard_normal((2, 32, 16)).astype(np.float32)
    d["comp/random"] = g
    d["comp/zero"] = np.zeros_like(g)
    one = g.copy()
    one[0] = 0.0
    d["comp/one_zero"] = one
    for s, b in enumerate(_batches(W.STEPS)):
        for k, v in b.items():
            d[f"batch/{s}/{k}"] = v
    cj, _ = _reduced_pair()
    params = jlm.init_lm(jax.random.PRNGKey(0), cj)
    for n, v in lm_state_from_jax(jax.tree.map(np.asarray, params)).items():
        d[f"params/{n}"] = v.numpy()
    d["pipe/ws"] = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    d["pipe/x"] = rng.standard_normal((6, 2, 16)).astype(np.float32)
    return d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(k: int) -> dict:
    return dict(os.environ, WORLD_SIZE=str(k), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))


def _start(k: int, args) -> list:
    env = _env(k)
    return [subprocess.Popen(
        [sys.executable, *map(str, args)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(k)]


def _join(procs, timeout=300) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p.returncode, log[-3000:]) for p, log in zip(procs, logs)
           if p.returncode]
    assert not bad, bad
    return logs


LAUNCH = ["-m", "repro_torch.launch.train", "--distributed", "--arch",
          "qwen2-1.5b-gspn", "--reduced", "--device", "cpu", "--batch", "2",
          "--seq", "16", "--grad-compression", "int8_ef"]


@pytest.fixture(scope="module")
def runs(run_sub, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    inputs = d / "inputs.npz"
    np.savez(inputs, **_inputs())
    scratch = d / "scratch"
    scratch.mkdir()
    ck = d / "launch_ck"
    two = _start(2, [WORKER, inputs, d / "torch2.npz", scratch])
    launch = _start(2, LAUNCH + ["--steps", "3", "--ckpt-every", "2",
                                 "--ckpt-dir", ck])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(
            run_sub, f"IN, OUT = {str(inputs)!r}, {str(d / 'jax.npz')!r}\n"
                     f"OPT, STEPS = {OPT!r}, {W.STEPS}\n"
                     + textwrap.dedent(JAX_BODY), timeout=600)
        try:
            _join(two)
            four = _start(4, [WORKER, inputs, d / "torch4.npz", scratch])
            first = _join(launch)
            launch = _start(2, LAUNCH + ["--steps", "1", "--ckpt-dir", ck])
            _join(four)
            second = _join(launch)
        finally:
            ref.result()
    return {"jax": dict(np.load(d / "jax.npz")),
            "inputs": dict(np.load(inputs)),
            2: dict(np.load(d / "torch2.npz")),
            4: dict(np.load(d / "torch4.npz")),
            "launch": (first, second), "scratch": scratch}


@pytest.mark.parametrize("case", ["random", "zero", "one_zero"])
def test_compressed_allreduce_matches_jax(runs, case):
    """Two gloo ranks against the reference's two devices: the mean
    within 1e-6 of the largest magnitude, the residuals too; all-zero
    gradients give exact zeros."""
    mine, ref = runs[2], runs["jax"]
    g, e = mine[f"comp/{case}/g"], mine[f"comp/{case}/e"]
    want_e = ref[f"comp/{case}/e"].reshape(e.shape)
    if case == "zero":
        assert not g.any() and not e.any() and not ref[
            f"comp/{case}/g"].any()
        return
    _close(g, ref[f"comp/{case}/g"], 1e-6, "mean")
    scale = np.abs(runs["jax"][f"comp/{case}/g"]).max()
    assert np.abs(e - want_e).max() <= 1e-6 * max(scale, 1.0)
    assert np.isfinite(g).all()


def test_counted_collectives_are_the_plain_ones(runs):
    """The counted gather, reduce-scatter and all-reduce are the plain
    collectives; CPU tensors pass through no host copy, so nothing is
    counted."""
    g = runs["inputs"]["comp/random"]
    mine = runs[2]
    np.testing.assert_array_equal(mine["counted/ag"], g.reshape(-1, 16))
    np.testing.assert_array_equal(mine["counted/rs"], (g[0] + g[1])[:16])
    np.testing.assert_array_equal(mine["counted/ar"], g[0] + g[1])
    assert int(mine["counted/bytes"]) == 0


def test_init_error_state_is_f32_zeros_beside_each_gradient():
    grads = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "b": torch.ones(4)}
    errors = collectives.init_error_state(grads)
    assert set(errors) == {"a", "b"}
    for n, e in errors.items():
        assert e.dtype == torch.float32 and e.shape == grads[n].shape
        assert not e.any()


def test_placements_follow_the_rules(runs):
    """On 2 ranks every parameter, moment and residual holds exactly the
    local shape its spec gives; replicated leaves are whole and equal on
    both ranks; the gathered weights equal an unsharded model's drawn
    from the same seed."""
    p = json.loads(str(runs[2]["placements"]))
    assert p["bad"] == [] and p["replicated_equal"] and p["seed_equal"]
    assert 0 < p["n_sharded"] < p["n_params"]


def _jax_params(runs, s):
    cj, _ = _reduced_pair()
    tree = jax.tree.structure(jax.eval_shape(
        lambda k: jlm.init_lm(k, cj), jax.random.PRNGKey(0)))
    leaves = [runs["jax"][f"jax/{s}/leaf/{i}"]
              for i in range(tree.num_leaves)]
    return lm_state_from_jax(jax.tree.unflatten(tree, leaves))


def _grads0(cj):
    """The reference's gradients of the first batch at its initial
    parameters, in the port's names, as numpy."""
    params = jlm.init_lm(jax.random.PRNGKey(0), cj)
    b = _batches(1)[0]
    return {n: t.numpy() for n, t in lm_state_from_jax(jax.tree.map(
        np.asarray, jax.grad(lambda p: jlm.lm_loss(
            p, cj, {k: jnp.asarray(v) for k, v in b.items()})[0])(
                params))).items()}


@pytest.mark.parametrize("against", ["jax", "one_rank"])
def test_sharded_step_matches(runs, against):
    """Two steps of the 2-rank sharded step against the reference's
    sharded step on a ``("data",)`` mesh of 2, and against the port's
    one-rank step on the whole batch: loss 1e-5 relative, grad_norm 1e-6,
    parameters 1e-5 of their largest magnitude except elements whose
    gradient is below 1e-5 of their leaf's largest."""
    mine = runs[2]
    cj, _ = _reduced_pair()
    g0 = _grads0(cj)
    for s in range(W.STEPS):
        if against == "jax":
            want = {k: runs["jax"][f"jax/{s}/{k}"]
                    for k in ("loss", "grad_norm")}
            want_p = {n: t.numpy() for n, t in _jax_params(runs, s).items()}
        else:
            want = {k: mine[f"none/one/{s}/{k}"]
                    for k in ("loss", "grad_norm")}
            want_p = {n[len(f"none/one/{s}/p/"):]: v for n, v in mine.items()
                      if n.startswith(f"none/one/{s}/p/")}
        np.testing.assert_allclose(mine[f"none/{s}/loss"], want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(mine[f"none/{s}/grad_norm"],
                                   want["grad_norm"], rtol=1e-6)
        for name, w in want_p.items():
            p, g = mine[f"none/{s}/p/{name}"], g0[name]
            off = np.abs(p - w) > 1e-5 * np.abs(w).max()
            assert (np.abs(g[off]) <= NOISE_FLOOR * np.abs(g).max()).all(), \
                (s, name)


def test_hybrid_pod_data_step_matches_one_rank(runs):
    """A ("pod", "data") mesh of 2 x 2 (sharded over data, replicated over
    pod, a row of the batch a rank): one step against the one-rank step
    on the whole batch, with the bounds of the sharded step; every rank
    holds the same parameters."""
    mine, two = runs[4], runs[2]
    assert bool(mine["pod/replicas_equal"])
    np.testing.assert_allclose(mine["pod/loss"], two["none/one/0/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(mine["pod/grad_norm"],
                               two["none/one/0/grad_norm"], rtol=1e-6)
    cj, _ = _reduced_pair()
    g0 = _grads0(cj)
    for name, g in g0.items():
        p, w = mine[f"pod/p/{name}"], two[f"none/one/0/p/{name}"]
        off = np.abs(p - w) > 1e-5 * np.abs(w).max()
        assert (np.abs(g[off]) <= NOISE_FLOOR * np.abs(g).max()).all(), name


def test_sharded_int8_ef_step_matches_one_rank(runs):
    """The first int8_ef step on 2 ranks (one scale per global reference
    leaf, from an all-reduce MAX) against the one-rank int8_ef step:
    loss and norm within 1e-5 (both steps), every residual within 1e-5 of
    the leaf's largest quantised magnitude (at least 254 times the
    largest residual, a residual being at most half a step of amax / 127)
    and every parameter within 1e-5, except elements whose quantised
    gradient sits one int8 step away, their residuals a step apart
    (reported)."""
    mine = runs[2]
    for s in range(W.STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(mine[f"int8_ef/{s}/{k}"],
                                       mine[f"int8_ef/one/{s}/{k}"],
                                       rtol=1e-5)
    names = [k[len("int8_ef/0/e/"):] for k in mine
             if k.startswith("int8_ef/0/e/")]
    assert names
    flips = 0
    for n in names:
        e, e1 = mine[f"int8_ef/0/e/{n}"], mine[f"int8_ef/one/0/e/{n}"]
        emax = np.abs(e1).max()
        d = np.abs(e - e1)
        flip = d > 1e-5 * 254 * emax
        # A flipped element's residuals differ by one step, which is at
        # least twice the largest residual.
        assert (d[flip] >= 1.9 * emax).all(), n
        p, p1 = mine[f"int8_ef/0/p/{n}"], mine[f"int8_ef/one/0/p/{n}"]
        off = np.abs(p - p1) > 1e-5 * np.abs(p1).max()
        assert flip[off].all(), n
        flips += int(flip.sum())
    print(f"sharded int8_ef: {flips} elements one int8 step from the "
          f"one-rank step's")


@pytest.mark.parametrize("ranks", [1, 4])
def test_checkpoint_saved_on_2_restores_bit_equal(runs, ranks):
    """The state the 2 ranks saved, restored on one rank (in process) and
    on 4 ranks (gathered): every parameter and moment bit for bit."""
    mine = runs[2]
    if ranks == 4:
        got = runs[4]
        assert int(got["restored/step"]) == W.STEPS
        assert int(got["restored/opt_step"]) == W.STEPS
        items = [(k[len("restored/"):], v) for k, v in got.items()
                 if k.startswith("restored/params/")
                 or k.startswith("restored/opt/")]
    else:
        setup = tstep.make_train_setup(W.config(), AdamWConfig(**OPT),
                                       device="cpu", seed=5)
        ck = CheckpointManager(str(runs["scratch"] / "ck2"))
        _, step = ck.restore(target=setup.state)
        assert step == W.STEPS and setup.state["opt"]["step"] == W.STEPS
        items = [(f"params/{n}", t.detach().numpy())
                 for n, t in setup.state["params"].items()]
        items += [(f"opt/{m}/{n}", t.numpy()) for m in ("m", "v")
                  for n, t in setup.state["opt"][m].items()]
    assert len(items) > 3 * 20
    for k, v in items:
        np.testing.assert_array_equal(v, mine[f"saved/{k}"], err_msg=k)


def test_elastic_trainer_shrinks_from_4_ranks_to_2(runs):
    """4 ranks, then 2 from step 8 of 20 (a failure injected on one rank
    at step 3, recovered by all): the loss history equals an
    uninterrupted one-rank run's within 1e-5 relative per step."""
    got = runs[4]
    meta = json.loads(str(got["elastic/meta"]))
    assert meta == {"step": 20, "recoveries": 1, "mesh": 2, "n_hosts": 2}
    assert got["elastic/active"].tolist() == [1.0, 1.0, 0.0, 0.0]
    setup = tstep.make_train_setup(W.elastic_config(),
                                   AdamWConfig(**W.ELASTIC_OPT),
                                   device="cpu")
    cfg = pipeline.DataConfig(vocab=512, seq_len=16, global_batch=4)
    want = []
    for s in range(20):
        batch = pipeline.to_device(pipeline.host_batch(cfg, s), "cpu")
        _, m = setup.train_step(setup.state, batch)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got["elastic/history"], want, rtol=1e-5)


def test_pipeline_matches_jax_and_the_sequence(runs):
    """GPipe over 4 gloo ranks, 6 microbatches, against the reference's
    over 4 devices and the 4 stages applied in sequence: 1e-5."""
    y = runs[4]["pipe/y"]
    _close(y, runs["jax"]["pipe/y"], 1e-5, "jax")
    _close(y, runs[4]["pipe/seq"], 1e-5, "sequence")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_for_devices_matches_jax(runs, n):
    """The reference's mesh arithmetic over n ranks: shapes and names,
    as pure arithmetic and (n <= 4) as a built ``DeviceMesh``."""
    for mp, sp in ((16, 1), (2, 1), (1, 2), (2, 2)):
        want = json.loads(str(runs["jax"][f"mesh/{n}/{mp}/{sp}"]))
        dims = lmesh.mesh_dims_for(n, model_parallel=mp, seq_parallel=sp)
        assert [list(dims[0]), list(dims[1])] == want
        if n <= 4:
            assert json.loads(str(runs[4][f"mesh/{n}/{mp}/{sp}"])) == want


def test_production_mesh_dims_and_refusal():
    assert lmesh.production_mesh_dims() == ((16, 16), ("data", "model"))
    assert lmesh.production_mesh_dims(multi_pod=True, seq_parallel=4) == (
        (2, 4, 4, 16), ("pod", "data", "seq", "model"))
    with pytest.raises(ValueError, match="does not divide"):
        lmesh.production_mesh_dims(seq_parallel=3)


def test_launcher_trains_distributed_and_resumes(runs):
    """``launch.train --distributed --grad-compression int8_ef`` on 2 gloo
    ranks, which the launcher now lays out as the reference's does, every
    rank on the model axis (``(data 1, model 2)``, min(16, 2) = 2: every
    layer tensor-parallel, the compression's scales over both ranks): 3
    finite losses and model-sharded checkpoints at steps 2 and 3; a
    second launch resumes at step 3 and ends at 4."""
    first, second = (logs[0] for logs in runs["launch"])
    assert "mesh {'data': 1, 'model': 2}" in first
    m = re.search(r"from step (\d+)", first)
    assert m and m.group(1) == "0"
    losses = json.loads(re.search(r"losses (\[[^\]]*\])", first).group(1))
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "from step 3" in second and "step 4," in second
