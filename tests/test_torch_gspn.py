"""The port's tap normalisation, directional dispatch and GSPN-2 attention
module against the JAX reference package, forward and gradients, from the
same numpy inputs and converted parameters (f32, 1e-5: DESIGN.md §3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gspn as jgspn
from repro_torch.core import gspn
from repro_torch.kernels import cuda_lib

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["softmax", "abs"])
def test_normalize_taps(mode):
    logits = np.random.default_rng(0).standard_normal((3, 6, 7, 3)) * 4
    wl, wc, wr = gspn.normalize_taps(torch.from_numpy(logits).float(), mode)
    assert wl.dtype == torch.float32
    np.testing.assert_allclose((wl + wc + wr).numpy(), 1.0, atol=1e-5)
    assert torch.all(wl[..., 0] == 0) and torch.all(wr[..., -1] == 0)
    for got, want in zip((wl, wc, wr), jgspn.normalize_taps(
            jnp.asarray(logits, jnp.float32), mode)):
        _close(got, want)


def test_normalize_taps_runs_in_f32_before_any_cast():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((4, 9, 3))).bfloat16()
    wl, wc, wr = gspn.normalize_taps(logits)
    assert wl.dtype == torch.float32
    torch.testing.assert_close(wl + wc + wr, torch.ones(4, 9), rtol=0,
                               atol=1e-6)


def _dir_inputs(seed, nd, g, h, w, cpw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, h, w)).astype(np.float32)
    z = rng.standard_normal((nd, g // cpw, h, w, 3))
    z = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    taps = [z[..., k].astype(np.float32) for k in range(3)]
    lam = rng.uniform(0, 1, (nd, g, h, w)).astype(np.float32)
    return x, *taps, lam


@pytest.mark.parametrize("direction", ["tb", "bt", "lr", "rl"])
def test_directional_scan_single(direction):
    x, wl, wc, wr, lam = _dir_inputs(2, 1, 4, 9, 13, 2)
    args = (x, wl[0], wc[0], wr[0], lam[0])
    _close(gspn.directional_scan(*map(torch.from_numpy, args), direction),
           jgspn.directional_scan(*map(jnp.asarray, args), direction,
                                  impl="xla"))


@pytest.mark.parametrize("directions", [("tb", "bt", "lr", "rl"),
                                        ("rl", "tb", "lr"),
                                        ("bt", "tb")])
def test_directional_scan_fused(directions):
    cuda_lib.clear_counts()
    a = _dir_inputs(3, len(directions), 4, 9, 13, 2)
    _close(gspn.directional_scan(*map(torch.from_numpy, a), directions),
           jgspn.directional_scan(*map(jnp.asarray, a), directions,
                                  impl="xla"))
    pairs = sum(p[0] in directions and p[1] in directions
                for p in gspn.OPPOSITE_PAIRS)
    assert cuda_lib.plain_calls["gspn_pair_fwd"] == pairs
    assert cuda_lib.plain_calls["gspn_scan_fwd"] == len(directions) - 2 * pairs


@pytest.mark.parametrize("channel_shared,chunk", [(True, None), (True, 3),
                                                  (False, None)])
def test_attention_matches_reference(channel_shared, chunk):
    jcfg = jgspn.GSPNAttentionConfig(dim=12, proxy_dim=2,
                                     channel_shared=channel_shared,
                                     chunk=chunk, impl="xla")
    params = jgspn.init_gspn_attention(jax.random.PRNGKey(0), jcfg)
    cfg = gspn.GSPNAttentionConfig(dim=12, proxy_dim=2,
                                   channel_shared=channel_shared, chunk=chunk)
    mod = gspn.GSPNAttention(cfg, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()}, strict=True)
    x = np.random.default_rng(4).standard_normal((2, 6, 9, 12)).astype(
        np.float32)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    _close(got, jgspn.apply_gspn_attention(params, jnp.asarray(x), jcfg))
    assert sum(p.numel() for p in mod.parameters()) == \
        gspn.gspn_attention_param_count(cfg) == \
        jgspn.gspn_attention_param_count(jcfg)


@pytest.mark.parametrize("channel_shared,chunk", [(True, 3), (False, None)])
def test_attention_gradients_match_reference(channel_shared, chunk):
    """Gradients of a random projection of the module's output, for every
    parameter and the input, against ``jax.grad`` of the reference's
    ``apply_gspn_attention`` (four directions: both fused pairs)."""
    jcfg = jgspn.GSPNAttentionConfig(dim=12, proxy_dim=2,
                                     channel_shared=channel_shared,
                                     chunk=chunk, impl="xla")
    params = jgspn.init_gspn_attention(jax.random.PRNGKey(1), jcfg)
    mod = gspn.GSPNAttention(gspn.GSPNAttentionConfig(
        dim=12, proxy_dim=2, channel_shared=channel_shared, chunk=chunk),
        device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()}, strict=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 9, 12)).astype(np.float32)
    r = rng.standard_normal((2, 6, 9, 12)).astype(np.float32)

    def jloss(p, xj):
        return jnp.sum(jgspn.apply_gspn_attention(p, xj, jcfg) * r)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (mod(xt) * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, want_x)
    for name, p in mod.named_parameters():
        _close(p.grad, want_p[name])


def test_attention_parameter_names_match_reference():
    jcfg = jgspn.GSPNAttentionConfig(dim=8)
    shapes = jax.eval_shape(
        lambda k: jgspn.init_gspn_attention(k, jcfg), jax.random.PRNGKey(0))
    mod = gspn.GSPNAttention(gspn.GSPNAttentionConfig(dim=8), device="meta")
    assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}


def test_attention_bf16_streams_stay_close_to_f32():
    cfg = gspn.GSPNAttentionConfig(dim=8, proxy_dim=2)
    mod = gspn.GSPNAttention(cfg, device="cpu")
    mod16 = gspn.GSPNAttention(
        dataclasses.replace(cfg, compute_dtype=torch.bfloat16), device="cpu")
    mod16.load_state_dict(mod.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 5, 6, 8)).astype(np.float32))
    with torch.no_grad():
        ref, got = mod(x), mod16(x)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max() <= 1e-2 * max(ref.abs().max(), 1.0)
