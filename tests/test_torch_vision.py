"""The port's vision backbone, layers, parameter carrier and data against
the JAX reference package, plus the port's import hygiene.

Model parity goes through converted parameters (JAX keys and torch
generators give different numbers).  The reduced model's logits agree to
1e-4: convolutions and matrix products sum in another order than XLA's.
"""

import ast
import dataclasses
import functools
import math
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gspn2_vision as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro.models import vision as jvision
from repro_torch.configs import gspn2_vision as configs
from repro_torch.data import pipeline
from repro_torch.kernels import cuda_lib
from repro_torch.models import layers, vision
from repro_torch.models.convert import vision_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jconfigs.reduced_vision()
    params = jax.jit(functools.partial(jvision.init_vision, cfg=jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


def _ported(params_np, cfg=None):
    model = vision.GSPNVision(cfg or configs.reduced_vision(), device="cpu")
    model.load_state_dict(vision_state_from_jax(params_np), strict=True)
    return model


def _batch(n=4, size=32, classes=10, seed=3):
    return pipeline.synth_images(pipeline.DataConfig(1, 1, n, seed=seed), 0,
                                 size, classes)


def test_reduced_logits_match_reference(reduced):
    jcfg, params, params_np = reduced
    cuda_lib.clear_counts()
    b = _batch()
    got = vision.apply_vision(_ported(params_np),
                              torch.from_numpy(b["images"]))
    want = jax.jit(functools.partial(jvision.apply_vision, cfg=jcfg))(
        params, jnp.asarray(b["images"]))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert cuda_lib.plain_calls["gspn_pair_fwd"] == 2 * sum(jcfg.depths)


def test_vision_loss_matches_reference(reduced):
    jcfg, params, params_np = reduced
    b = _batch(seed=5)
    nll, aux = vision.vision_loss(
        _ported(params_np), {k: torch.from_numpy(v) for k, v in b.items()})
    want, _ = jvision.vision_loss(params, jcfg,
                                  {k: jnp.asarray(v) for k, v in b.items()})
    assert aux["ce"] is nll
    assert nll.requires_grad       # differentiable (the training loss)
    np.testing.assert_allclose(nll.item(), float(want), rtol=1e-4, atol=1e-4)


def test_converter_raises_on_missing_or_extra_leaf(reduced):
    _, _, params_np = reduced
    missing = jax.tree.map(lambda a: a, params_np)
    del missing["stages"][1]["blocks"]["gspn"]["w_u"]
    with pytest.raises(KeyError, match="stages/1/blocks/gspn/w_u"):
        vision_state_from_jax(missing)
    extra = jax.tree.map(lambda a: a, params_np)
    extra["stages"][3]["down"] = {"w": np.zeros((2, 2, 64, 8), np.float32),
                                  "b": np.zeros((8,), np.float32)}
    with pytest.raises(ValueError, match="stages/3/down"):
        vision_state_from_jax(extra)


def test_converter_layouts(reduced):
    _, _, params_np = reduced
    state = vision_state_from_jax(params_np)
    lpu = params_np["stages"][2]["blocks"]["lpu"]["w"]       # (2, 3, 3, 1, C)
    assert lpu.shape == (2, 3, 3, 1, 48)
    got = state["stages.2.blocks.1.lpu.w"]
    assert tuple(got.shape) == (48, 1, 3, 3)
    np.testing.assert_array_equal(got.numpy()[:, 0],
                                  np.moveaxis(lpu[1][:, :, 0], -1, 0))
    stem = params_np["stem"]["w"]                            # HWIO
    np.testing.assert_array_equal(state["stem.w"].numpy(),
                                  stem.transpose(3, 2, 0, 1))


def test_synth_images_bitwise_equal():
    for seed, step in ((0, 0), (7, 3)):
        got = pipeline.synth_images(pipeline.DataConfig(1, 1, 5, seed=seed),
                                    step, 24, 1000)
        want = jpipeline.synth_images(
            jpipeline.DataConfig(1, 1, 5, seed=seed), step, 24, 1000)
        for k in ("images", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["gspn2-t", "gspn2-s", "gspn2-b"])
def test_param_counts_match_reference(name):
    shapes = jax.eval_shape(
        lambda k: jvision.init_vision(k, jconfigs.VISION_CONFIGS[name]),
        jax.random.PRNGKey(0))
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    model = vision.GSPNVision(configs.VISION_CONFIGS[name], device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert vision.vision_macs(configs.VISION_CONFIGS[name]) == \
        jvision.vision_macs(jconfigs.VISION_CONFIGS[name])


def test_model_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.GSPNVision(configs.reduced_vision())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.GSPNVision(configs.reduced_vision(), device="cuda")


def test_seeded_generator_gives_same_weights():
    cfg = configs.reduced_vision()
    a = vision.GSPNVision(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    b = vision.GSPNVision(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("n,k,s", [(9, 4, 4), (7, 2, 2), (7, 3, 1),
                                   (10, 3, 2), (8, 4, 4), (5, 2, 2)])
def test_same_padding_matches_jax(n, k, s):
    rng = np.random.default_rng(n * 100 + k * 10 + s)
    x = rng.standard_normal((2, n, n + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = layers.conv2d_same(torch.from_numpy(x),
                             torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                             torch.zeros(4), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_dwconv_layernorm_mlp_match_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32) * 3
    key = jax.random.PRNGKey(1)
    p_dw = jlayers.init_dwconv2d(key, 6)
    p_dw["b"] = jnp.asarray(rng.standard_normal(6), jnp.float32)
    dw = layers.DWConv2d(6, generator=None, device="meta")
    dw.w = torch.nn.Parameter(torch.from_numpy(
        np.asarray(p_dw["w"]).transpose(3, 2, 0, 1).copy()))
    dw.b = torch.nn.Parameter(torch.from_numpy(np.array(p_dw["b"])))
    p_ln = {"scale": jnp.asarray(rng.standard_normal(6), jnp.float32),
            "bias": jnp.asarray(rng.standard_normal(6), jnp.float32)}
    ln = layers.LayerNorm(6, device="cpu")
    ln.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in p_ln.items()})
    p_mlp = jlayers.init_gelu_mlp(key, 6, 24)
    p_mlp["b1"] = jnp.asarray(rng.standard_normal(24), jnp.float32)
    mlp = layers.GeluMLP(6, 24, generator=None, device="meta")
    mlp.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p_mlp.items()}, assign=True)
    policy = jlayers.DTypePolicy(jnp.float32, jnp.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    with torch.no_grad():
        for got, want in ((dw(xt), jlayers.apply_dwconv2d(p_dw, xj)),
                          (ln(xt), jlayers.apply_layernorm(p_ln, xj)),
                          (mlp(xt), jlayers.apply_gelu_mlp(p_mlp, xj,
                                                           policy))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    v = np.linspace(-4, 4, 101).astype(np.float32)
    got = torch.nn.functional.gelu(torch.from_numpy(v), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(v)),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(v))
    assert (exact - got).abs().max() > 1e-4     # the two do differ


def test_configs_match_reference():
    for name, cfg in configs.VISION_CONFIGS.items():
        ref = jconfigs.VISION_CONFIGS[name]
        mine = dataclasses.asdict(cfg)
        theirs = dataclasses.asdict(ref)
        for k in ("seq_axis", "sp_strategy", "param_dtype"):
            theirs.pop(k)
        mine.pop("param_dtype")
        assert mine == theirs


# ---------------------------------------------------------------------------
# Import hygiene: the port, its trainer twin and chip_smoke.py never import
# JAX or the reference package.
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "examples" / "train_vision_torch.py"]


def test_port_imports_no_jax_or_reference():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append((str(path.relative_to(ROOT)), name))
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.models.vision, repro_torch.models.convert,"
            " repro_torch.optim.adamw;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
