"""The port's scan oracle, kernel plain versions, dispatch and spec against
the JAX reference package, forward and backward.

Inputs come from numpy with a seed and go to both packages; f32 results
and gradients agree to 1e-5 (DESIGN.md §3).  The CUDA kernels themselves
run only on a card: ``test_torch_cuda.py`` holds them against their plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cuda_lib, gspn_multidir, gspn_scan, ops, ref
from repro_torch.kernels.spec import ScanSpec, dtype_name

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taps(rng, shape):
    """Row-stochastic (wl, wc, wr) of ``shape`` so the scan stays bounded."""
    z = rng.standard_normal(shape + (3,))
    z = np.exp(z - z.max(-1, keepdims=True))
    z = (z / z.sum(-1, keepdims=True)).astype(np.float32)
    return z[..., 0], z[..., 1], z[..., 2]


def _inputs(seed, g, h, w, cpw, pair=False):
    rng = np.random.default_rng(seed)
    lead = (2,) if pair else ()
    x = rng.standard_normal((g, h, w)).astype(np.float32)
    wl, wc, wr = _taps(rng, lead + (g // cpw, h, w))
    lam = rng.uniform(0.0, 1.0, lead + (g, h, w)).astype(np.float32)
    return x, wl, wc, wr, lam


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


SHAPES = [(4, 19, 37), (4, 7, 7)]
CPWS = [1, 2, 4]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cpw", CPWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_scan_matches_jax(shape, cpw, reverse):
    a = _inputs(0, *shape, cpw)
    _close(ref.gspn_scan_ref(*_t(a), reverse=reverse),
           jref.gspn_scan_ref(*_j(a), reverse=reverse))


def test_ref_scan_h0_matches_jax():
    a = _inputs(1, 4, 9, 11, 2)
    h0 = np.random.default_rng(2).standard_normal((4, 11)).astype(np.float32)
    for reverse in (False, True):
        _close(ref.gspn_scan_ref(*_t(a), h0=torch.from_numpy(h0),
                                 reverse=reverse),
               jref.gspn_scan_ref(*_j(a), h0=jnp.asarray(h0),
                                  reverse=reverse))


@pytest.mark.parametrize("cpw", CPWS)
def test_chunked_ref_matches_jax(cpw):
    a = _inputs(3, 4, 12, 9, cpw)
    _close(ref.gspn_scan_chunked_ref(*_t(a), 4),
           jref.gspn_scan_chunked_ref(*_j(a), 4))


def test_chunked_ref_reverse_is_flipped_chunked():
    a = _inputs(4, 4, 12, 9, 2)
    flip = tuple(np.flip(v, axis=1).copy() for v in a)
    _close(ref.gspn_scan_chunked_ref(*_t(a), 3, reverse=True),
           np.flip(np.asarray(jref.gspn_scan_chunked_ref(*_j(flip), 3)),
                   axis=1))


@pytest.mark.parametrize("cpw", CPWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_kernel_versions_match_jax(shape, cpw):
    a = _inputs(5, *shape, cpw)
    _close(gspn_scan.gspn_scan_fwd_torch(*_t(a)), jref.gspn_scan_ref(*_j(a)))
    p = _inputs(6, *shape, cpw, pair=True)
    x, wl2, wc2, wr2, lam2 = _j(p)
    want = jnp.stack([
        jref.gspn_scan_ref(x, wl2[0], wc2[0], wr2[0], lam2[0]),
        jref.gspn_scan_ref(x, wl2[1], wc2[1], wr2[1], lam2[1], reverse=True)])
    _close(gspn_multidir.gspn_scan_bidir_torch(*_t(p)), want)


def test_pair_matches_multidir_interpret():
    """One tiny shape through the reference's fused Pallas pair kernel in
    interpret mode."""
    p = _inputs(7, 4, 8, 8, 2, pair=True)
    _close(ops.gspn_scan_pair(*_t(p), impl="torch"),
           jops.gspn_scan_pair(*_j(p), impl="multidir"))


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("cpw", CPWS)
@pytest.mark.parametrize("shape", [(4, 14, 37), (4, 7, 7)])
def test_pair_op_matches_xla(shape, cpw, chunk):
    p = _inputs(8, *shape, cpw, pair=True)
    _close(ops.gspn_scan_pair(*_t(p), chunk=chunk),
           jops.gspn_scan_pair(*_j(p), impl="xla", chunk=chunk))


@pytest.mark.parametrize("chunk", [None, 3, 6])
@pytest.mark.parametrize("cpw", CPWS)
def test_scan_op_chunk_matches_xla(cpw, chunk):
    a = _inputs(9, 4, 12, 13, cpw)
    _close(ops.gspn_scan(*_t(a), chunk=chunk),
           jops.gspn_scan(*_j(a), impl="xla", chunk=chunk))
    _close(gspn_scan.gspn_scan_fwd_torch(*_t(a), chunk=chunk),
           jops.gspn_scan(*_j(a), impl="xla", chunk=chunk))


@pytest.mark.parametrize("cpw", [1, 2])
def test_dense_oracle(cpw):
    a = _inputs(10, 2, 5, 6, cpw)
    dense = ref.gspn_dense_oracle(*_t(a))
    _close(dense, jref.gspn_dense_oracle(*_j(a)))
    _close(dense, ref.gspn_scan_ref(*_t(a)).numpy())


def test_chunk_must_divide_h():
    a = _t(_inputs(11, 2, 12, 5, 1))
    with pytest.raises(ValueError, match="divisor"):
        ops.gspn_scan(*a, chunk=5)


def test_spec_validation_and_canonical():
    s = ScanSpec(stream_dtype=torch.bfloat16, carry_dtype="float")
    assert (s.stream_dtype, s.carry_dtype) == ("bfloat16", "float32")
    assert s == ScanSpec(stream_dtype="bfloat16")
    assert hash(s) == hash(ScanSpec(stream_dtype="torch.bfloat16"))
    assert s.with_(channels_per_weight=2).canonical() == \
        "fwd|auto|bfloat16|carry-float32|cs1|bnd-one_shot"
    for bad in (dict(impl="pallas"), dict(direction="quad", impl="per_step"),
                dict(boundary="sp_block_local"), dict(channels_per_weight=0),
                dict(stream_dtype="nope")):
        with pytest.raises(ValueError):
            ScanSpec(**bad)
    # The quad is accepted and forward-only.
    quad = ScanSpec(direction="quad", impl="cuda", channels_per_weight=2)
    assert quad.canonical() == "quad|cuda|float32|carry-float32|cs1|bnd-one_shot"
    with pytest.raises(ValueError, match="no fused adjoint"):
        quad.adjoint()
    assert dtype_name(torch.float32) == "float32"


def test_spec_canonical_matches_reference_format():
    from repro.kernels.spec import ScanSpec as JSpec
    for direction in ("fwd", "pair_fwd"):
        mine = ScanSpec(direction=direction, impl="torch",
                        channels_per_weight=2, stream_dtype="bfloat16")
        theirs = JSpec(direction=direction, impl="xla",
                       channels_per_weight=2, stream_dtype="bfloat16")
        for m, t in ((mine, theirs), (mine.adjoint(), theirs.adjoint())):
            assert m.canonical() == t.canonical().replace("|xla|", "|torch|")


def test_spec_adjoint():
    s = ScanSpec(direction="pair_fwd", channels_per_weight=2,
                 stream_dtype="bfloat16", carry_dtype="bfloat16")
    adj = s.adjoint()
    assert (adj.direction, adj.carry_dtype, adj.stream_dtype,
            adj.channels_per_weight) == ("pair_bwd", "float32", "bfloat16", 2)
    assert ScanSpec().adjoint().direction == "bwd"
    for direction in ("bwd", "pair_bwd"):
        with pytest.raises(ValueError, match="no fused adjoint"):
            ScanSpec(direction=direction).adjoint()


def test_spec_cuda_refuses_narrow_carry_and_cpu_tensors():
    with pytest.raises(ValueError, match="carry"):
        ScanSpec(impl="cuda", carry_dtype="bfloat16")
    a = _t(_inputs(12, 2, 4, 5, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gspn_scan(*a, impl="cuda")
    p = _t(_inputs(12, 2, 4, 5, 1, pair=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gspn_scan_pair(*p, spec=ScanSpec(impl="cuda"))


def test_wrappers_take_plain_version_on_cpu():
    cuda_lib.clear_counts()
    a = _t(_inputs(13, 4, 6, 5, 2))
    p = _t(_inputs(13, 4, 6, 5, 2, pair=True))
    _close(gspn_scan.gspn_scan_fwd(*a), gspn_scan.gspn_scan_fwd_torch(*a))
    _close(gspn_multidir.gspn_scan_bidir(*p),
           gspn_multidir.gspn_scan_bidir_torch(*p))
    _close(ops.gspn_scan_pair(*p), gspn_multidir.gspn_scan_bidir_torch(*p))
    assert sum(cuda_lib.launch_counts.values()) == 0
    assert cuda_lib.plain_calls == {"gspn_scan_fwd": 2, "gspn_pair_fwd": 4}


def test_plain_versions_store_in_stream_dtype():
    a = tuple(t.bfloat16() for t in _t(_inputs(14, 4, 6, 5, 2)))
    out = gspn_scan.gspn_scan_fwd_torch(*a)
    assert out.dtype == torch.bfloat16
    want = ref.gspn_scan_ref(*(t.float() for t in a)).bfloat16()
    assert torch.equal(out, want)


@pytest.mark.parametrize("case", ["taps", "lam", "dtype", "contig", "width",
                                  "groups", "chunk"])
def test_launch_checks_operands(case):
    """The wrapper's operand checks run before any build or launch."""
    x, wl, wc, wr, lam = _t(_inputs(15, 4, 6, 5, 2, pair=True))
    ndir, chunk = 2, None
    if case == "taps":
        wl = wl[0]
    elif case == "lam":
        lam = lam[0]
    elif case == "dtype":
        x, wl, wc, wr, lam = (t.half() for t in (x, wl, wc, wr, lam))
    elif case == "contig":
        wc = wc.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "width":
        x = torch.zeros(4, 1, 1025)
        wl = wc = wr = torch.zeros(2, 2, 1, 1025)
        lam = torch.zeros(2, 4, 1, 1025)
    elif case == "groups":
        wl, wc, wr = (torch.zeros(2, 3, 6, 5) for _ in range(3))
    elif case == "chunk":
        chunk = 4
    with pytest.raises(ValueError):
        gspn_scan.launch(ndir, "test", x, wl, wc, wr, lam, chunk)


@pytest.mark.parametrize("case,match", [("ndir", "ndir"),
                                        ("square", "square"),
                                        ("chunk", "square")])
def test_template_launch_refuses_what_it_has_no_instance_for(case, match):
    """The forward template runs 1, 2 or 4 directions, the quad on a
    square grid without a chunk; anything else raises before any build or
    launch."""
    g, h, w = 4, 6, 6
    ndir, chunk = 4, None
    if case == "ndir":
        ndir = 3
    elif case == "square":
        w = 5
    elif case == "chunk":
        chunk = 3
    x = torch.zeros(g, h, w)
    taps = torch.zeros(ndir, 2, h, w)
    lam = torch.zeros(ndir, g, h, w)
    with pytest.raises(ValueError, match=match):
        gspn_scan.launch(ndir, "test", x, taps, taps, taps, lam, chunk)



# ---------------------------------------------------------------------------
# Backward: the adjoint oracle, the plain adjoint walks and the gradients of
# the autograd Functions.
# ---------------------------------------------------------------------------

def _dy(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cpw", CPWS)
def test_ref_vjp_matches_jax(cpw):
    shape = SHAPES[0]
    a = _inputs(20, *shape, cpw)
    dy = _dy(21, shape)
    got = ref.gspn_scan_ref_vjp(*_t(a), torch.from_numpy(dy))
    want = jref.gspn_scan_ref_vjp(*_j(a), jnp.asarray(dy))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("reverse", [False, True])
def test_ref_vjp_matches_autograd(reverse):
    a = _inputs(22, 4, 9, 11, 2)
    dy = torch.from_numpy(_dy(23, (4, 9, 11)))
    leaves = [t.requires_grad_(True) for t in _t(a)]
    want = torch.autograd.grad(ref.gspn_scan_ref(*leaves, reverse=reverse),
                               leaves, dy)
    got = ref.gspn_scan_ref_vjp(*_t(a), dy, reverse=reverse)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def _xla_adjoint(dy, wl, wc, wr, reverse, chunk):
    """The reference's adjoint walk on the fold the reference uses for
    ``chunk``: (G, H, W) -> (G·H/chunk, chunk, W), weights broadcast."""
    g, h, w = dy.shape
    fold = h // (chunk or h)

    def f(a):
        return jref._broadcast_w(jnp.asarray(a), g).reshape(g * fold, -1, w)

    out = jops._bwd_adjoint_xla(f(dy), f(wl), f(wc), f(wr), reverse=reverse)
    return np.asarray(out).reshape(g, h, w)


@pytest.mark.parametrize("cpw,chunk", [(1, None), (2, 6), (4, 4)])
def test_plain_adjoints_match_jax(cpw, chunk):
    _, wl, wc, wr, _ = _inputs(24, 4, 12, 13, cpw)
    dy = _dy(25, (4, 12, 13))
    got = gspn_scan.gspn_scan_bwd_torch(*_t((dy, wl, wc, wr)), chunk=chunk)
    assert got.dtype == torch.float32
    _close(got, _xla_adjoint(dy, wl, wc, wr, True, chunk))
    _, wl2, wc2, wr2, _ = _inputs(26, 4, 12, 13, cpw, pair=True)
    dy2 = _dy(27, (2, 4, 12, 13))
    got2 = gspn_multidir.gspn_scan_bidir_bwd_torch(
        *_t((dy2, wl2, wc2, wr2)), chunk=chunk)
    for d in (0, 1):
        _close(got2[d], _xla_adjoint(dy2[d], wl2[d], wc2[d], wr2[d], d == 0,
                                     chunk))


def _grads(op, arrays, dy, **kw):
    leaves = [t.requires_grad_(True) for t in _t(arrays)]
    return torch.autograd.grad(op(*leaves, **kw), leaves, torch.from_numpy(dy))


def _jax_grads(op, arrays, dy, **kw):
    _, vjp = jax.vjp(lambda *t: op(*t, **kw), *_j(arrays))
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("cpw,chunk", [(1, None), (2, None), (2, 6), (4, 4)])
@pytest.mark.parametrize("pair", [False, True])
def test_op_gradients_match_xla(pair, cpw, chunk):
    """``torch.autograd.grad`` through the port's Functions against
    ``jax.vjp`` of the reference's custom_vjp ops (the xla adjoint and the
    same epilogue), ragged W, chunk None, H/2 and H/3."""
    a = _inputs(28, 4, 12, 13, cpw, pair=pair)
    dy = _dy(29, ((2,) if pair else ()) + (4, 12, 13))
    mine, theirs = (ops.gspn_scan_pair, jops.gspn_scan_pair) if pair else \
        (ops.gspn_scan, jops.gspn_scan)
    for g, w in zip(_grads(mine, a, dy, chunk=chunk),
                    _jax_grads(theirs, a, dy, impl="xla", chunk=chunk)):
        assert g.shape == w.shape
        _close(g, w)


def test_op_gradients_match_pallas_interpret():
    """One small case through the reference's Pallas adjoint kernels (#2,
    #4) in interpret mode, as the reference suite runs them."""
    a = _inputs(30, 4, 8, 8, 2)
    dy = _dy(31, (4, 8, 8))
    for g, w in zip(_grads(ops.gspn_scan, a, dy),
                    _jax_grads(jops.gspn_scan, a, dy, impl="pallas")):
        _close(g, w)
    p = _inputs(32, 4, 8, 8, 2, pair=True)
    dy2 = _dy(33, (2, 4, 8, 8))
    for g, w in zip(_grads(ops.gspn_scan_pair, p, dy2),
                    _jax_grads(jops.gspn_scan_pair, p, dy2, impl="multidir")):
        _close(g, w)


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("pair", [False, True])
def test_functions_gradcheck_float64(pair, chunk):
    a = tuple(torch.from_numpy(v).double().requires_grad_(True)
              for v in _inputs(34, 4, 6, 5, 2, pair=pair))
    op = ops.gspn_scan_pair if pair else ops.gspn_scan
    assert torch.autograd.gradcheck(lambda *t: op(*t, chunk=chunk), a)


def test_adjoint_wrappers_take_plain_version_on_cpu():
    cuda_lib.clear_counts()
    _, wl, wc, wr, lam = _t(_inputs(35, 4, 6, 5, 2))
    _, wl2, wc2, wr2, lam2 = _t(_inputs(35, 4, 6, 5, 2, pair=True))
    _close(gspn_scan.gspn_scan_bwd(lam, wl, wc, wr),
           gspn_scan.gspn_scan_bwd_torch(lam, wl, wc, wr))
    _close(gspn_multidir.gspn_scan_bidir_bwd(lam2, wl2, wc2, wr2),
           gspn_multidir.gspn_scan_bidir_bwd_torch(lam2, wl2, wc2, wr2))
    assert sum(cuda_lib.launch_counts.values()) == 0
    assert cuda_lib.plain_calls == {"gspn_scan_bwd": 2, "gspn_pair_bwd": 2}


@pytest.mark.parametrize("case", ["taps", "dy", "dtype", "contig", "chunk"])
def test_launch_bwd_checks_operands(case):
    """The pair adjoint's operand checks run before any build or
    launch."""
    _, wl, wc, wr, dy = _t(_inputs(36, 4, 6, 5, 2, pair=True))
    chunk = None
    if case == "taps":
        wl = wl[0]
    elif case == "dy":
        dy = dy[0]
    elif case == "dtype":
        dy, wl, wc, wr = (t.double() for t in (dy, wl, wc, wr))
    elif case == "contig":
        dy = dy.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "chunk":
        chunk = 4
    with pytest.raises(ValueError):
        gspn_multidir.launch_pair_bwd(dy, wl, wc, wr, chunk)
