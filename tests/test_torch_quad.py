"""The port's single-launch quad scan (plain version), the GSPN-1 per-step
emulation and the per-step dispatch against the JAX reference package.

Inputs come from numpy with a seed and go to both packages.  Tolerances:
1e-5 in float32; 1e-2 for bfloat16 outputs (one output rounding of values
computed in f32, DESIGN.md §10).  The quad's reference is the Pallas
``gspn_scan_quad_pallas`` in interpret mode (``row_tile=4``, as its own
tests run it) and the quad oracle of ``tests/test_conformance.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gspn_multidir as jmk
from repro.kernels import ref as jref
from repro_torch.core import gspn
from repro_torch.kernels import cuda_lib, gspn_multidir, ops, ref
from repro_torch.kernels.spec import ScanSpec

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad_inputs(seed, g, n, cpw, ndir=4):
    """x (G,N,N), row-stochastic taps (ndir,G_w,N,N), lam (ndir,G,N,N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, n, n)).astype(np.float32)
    z = rng.standard_normal((ndir, g // cpw, n, n, 3))
    z = np.exp(z - z.max(-1, keepdims=True))
    z = (z / z.sum(-1, keepdims=True)).astype(np.float32)
    lam = rng.uniform(0.0, 1.0, (ndir, g, n, n)).astype(np.float32)
    return x, z[..., 0], z[..., 1], z[..., 2], lam


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _jax_quad_oracle(x, wl4, wc4, wr4, lam4):
    """``tests/test_conformance.py``'s quad oracle: entries 0/1 scan x,
    2/3 its transpose with pre-transposed taps; odd entries reversed."""
    xt = jnp.swapaxes(x, -1, -2)
    return jnp.stack([jref.gspn_scan_ref(
        x if d < 2 else xt, wl4[d], wc4[d], wr4[d], lam4[d],
        reverse=d % 2 == 1) for d in range(4)])


CASES = [(2, 8, 1), (4, 8, 2), (6, 12, 3), (6, 12, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,cpw", CASES)
def test_quad_plain_matches_pallas_interpret(g, n, cpw, dtype):
    a = _quad_inputs(g * n + cpw, g, n, cpw)
    jd = jnp.dtype(dtype)
    jx, jwl, jwc, jwr, jlam = (jnp.asarray(v).astype(jd) for v in a)
    want = jmk.gspn_scan_quad_pallas(jx, {"wl": jwl, "wc": jwc, "wr": jwr},
                                     jlam, channels_per_weight=cpw,
                                     row_tile=4)
    td = getattr(torch, dtype)
    got = gspn_multidir.gspn_scan_quad_torch(
        *(torch.from_numpy(v).to(td) for v in a))
    assert got.dtype == td and got.shape == (4, g, n, n)
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("g,n,cpw", CASES)
def test_quad_matches_jax_oracle(g, n, cpw):
    a = _quad_inputs(100 + g * n + cpw, g, n, cpw)
    want = _jax_quad_oracle(*(jnp.asarray(v) for v in a))
    t = tuple(torch.from_numpy(v) for v in a)
    cuda_lib.clear_counts()
    got = gspn_multidir.gspn_scan_quad(*t)       # CPU: the plain version
    assert cuda_lib.plain_calls == {"gspn_quad_fwd": 1}
    _close(got, want)
    _close(ref.gspn_scan_quad_ref(*t), want)


def test_quad_equals_the_four_directional_scans():
    """Entries 2/3 transposed back, the quad is the four-direction pass of
    ``directional_scan`` (pair-fused) from taps in the original
    orientation."""
    x, wl, wc, wr, lam = (torch.from_numpy(v)
                          for v in _quad_inputs(7, 4, 12, 2))

    def t4(v):
        return torch.stack([v[0], v[1], v[2].mT, v[3].mT])

    quad = t4(gspn_multidir.gspn_scan_quad(x, t4(wl), t4(wc), t4(wr),
                                           t4(lam)))
    pair = gspn.directional_scan(x, wl, wc, wr, lam, gspn.DIRECTIONS)
    torch.testing.assert_close(quad, pair, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cpw", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_step_matches_reference(cpw, dtype):
    x, wl, wc, wr, lam = _quad_inputs(20 + cpw, 6, 12, cpw, ndir=1)
    a = (x, wl[0], wc[0], wr[0], lam[0])
    want = jref.gspn_scan_per_step(*(jnp.asarray(v) for v in a), block=True)
    t = tuple(torch.from_numpy(v) for v in a)
    cuda_lib.clear_counts()
    _close(ref.gspn_scan_per_step(*t), want)
    assert not cuda_lib.plain_calls  # the oracle counts nothing
    _close(ref.gspn_scan_per_step(*t), ref.gspn_scan_ref(*t).numpy())
    # Through the dispatch, in the stream dtype (f32 arithmetic).
    td = getattr(torch, dtype)
    cuda_lib.clear_counts()
    got = ops.gspn_scan(*(v.to(td) for v in t), impl="per_step")
    assert got.dtype == td
    assert cuda_lib.plain_calls == {"per_step": 1, "per_step_row": 12}
    _close(got, want, dtype)
    got = ops.gspn_scan(*t, spec=ScanSpec(impl="per_step",
                                          channels_per_weight=cpw))
    _close(got, want)


def test_per_step_gradients_match_the_plain_dispatch():
    """Its backward is the plain adjoint walk, as the reference's custom_vjp
    runs its XLA adjoint for per_step."""
    x, wl, wc, wr, lam = _quad_inputs(30, 4, 8, 2, ndir=1)
    a = (x, wl[0], wc[0], wr[0], lam[0])
    r = torch.from_numpy(np.random.default_rng(31).standard_normal(
        x.shape).astype(np.float32))

    def grads(impl):
        leaves = [torch.from_numpy(v).requires_grad_(True) for v in a]
        return torch.autograd.grad((ops.gspn_scan(*leaves, impl=impl)
                                    * r).sum(), leaves)

    for p, t in zip(grads("per_step"), grads("torch")):
        torch.testing.assert_close(p, t, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cpw", [1, 2])
def test_directional_scan_per_step_skips_pair_fusion(cpw):
    x, wl, wc, wr, lam = (torch.from_numpy(v)
                          for v in _quad_inputs(40 + cpw, 4, 8, cpw))
    want = gspn.directional_scan(x, wl, wc, wr, lam, gspn.DIRECTIONS)
    for kwargs in (dict(impl="per_step"),
                   dict(spec=ScanSpec(impl="per_step",
                                      channels_per_weight=cpw))):
        cuda_lib.clear_counts()
        got = gspn.directional_scan(x, wl, wc, wr, lam, gspn.DIRECTIONS,
                                    **kwargs)
        assert cuda_lib.plain_calls == {"per_step": 4, "per_step_row": 32}
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_refusals():
    x, wl, wc, wr, lam = (torch.from_numpy(v)
                          for v in _quad_inputs(50, 2, 8, 1))
    with pytest.raises(ValueError, match="square"):
        gspn_multidir.gspn_scan_quad(x[:, :6], wl[..., :6, :], wc[..., :6, :],
                                     wr[..., :6, :], lam[..., :6, :])
    with pytest.raises(ValueError, match="forward-only"):
        gspn_multidir.gspn_scan_quad(x, wl.requires_grad_(True), wc, wr, lam)
    with pytest.raises(ValueError, match="no fused adjoint"):
        ScanSpec(direction="quad").adjoint()
    for direction in ("bwd", "pair_fwd", "pair_bwd", "quad"):
        with pytest.raises(ValueError, match="per_step"):
            ScanSpec(direction=direction, impl="per_step")
    p = (x, wl[:2], wc[:2], wr[:2], lam[:2])
    with pytest.raises(ValueError, match="per_step"):
        ops.gspn_scan_pair(*(v.detach() for v in p), impl="per_step")
    with pytest.raises(ValueError, match="one-shot"):
        ops.gspn_scan(x, wl[0].detach(), wc[0], wr[0], lam[0], chunk=4,
                      impl="per_step")
