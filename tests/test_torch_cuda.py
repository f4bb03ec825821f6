"""The port's CUDA kernels and its kernel path on a card, held against the
plain PyTorch versions.

This file imports neither JAX nor the reference package, so it runs on a
GPU host that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a card.  Tolerances: 1e-5 of the largest
magnitude in float32 and 1e-2 in bfloat16 (DESIGN.md §10); the adjoint
kernels 1e-5 in both, since they compute in f32 and write f32 from the
same inputs as their plain versions; the model's logits and gradients
1e-4 of the largest magnitude with TF32 off (the language model's under
its f32 policy).
"""

import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs.base import with_precision
from repro_torch.configs.gspn2_vision import reduced_vision
from repro_torch.configs.qwen2_1_5b_gspn import reduced as reduced_lm
from repro_torch.core.gspn import DIRECTIONS, directional_scan
from repro_torch.kernels import cuda_lib, gspn_multidir, gspn_scan, ops
from repro_torch.models import lm
from repro_torch.models.vision import GSPNVision, apply_vision, vision_loss
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels are built with nvcc "
                    "for sm_90a")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, g, h, w, cpw, dtype, pair=False, ndir=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = (ndir,) if ndir else (2,) if pair else ()
    x = torch.randn((g, h, w), generator=gen, device="cuda")
    taps = torch.softmax(torch.randn(lead + (g // cpw, h, w, 3),
                                     generator=gen, device="cuda"), dim=-1)
    lam = torch.rand(lead + (g, h, w), generator=gen, device="cuda")
    return tuple(t.to(dtype).contiguous()
                 for t in (x, taps[..., 0], taps[..., 1], taps[..., 2], lam))


def _err_ok(got, want, tol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    return err <= tol * want.float().abs().max().item()


SHAPES = [((8, 19, 37), 1, None), ((8, 19, 37), 4, 19), ((8, 18, 37), 4, 6),
          ((4, 5, 1), 2, None), ((128, 56, 56), 2, None),
          ((2, 3, 1024), 1, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", SHAPES)
def test_kernels_match_plain(card, dtype, shape, cpw, chunk):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    a = _inputs(1, *shape, cpw, dtype)
    p = _inputs(2, *shape, cpw, dtype, pair=True)
    assert _err_ok(gspn_scan.gspn_scan_fwd(*a, chunk=chunk),
                   gspn_scan.gspn_scan_fwd_torch(*a, chunk=chunk), tol)
    assert _err_ok(gspn_multidir.gspn_scan_bidir(*p, chunk=chunk),
                   gspn_multidir.gspn_scan_bidir_torch(*p, chunk=chunk), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n,cpw", [(8, 19, 1), (8, 19, 4), (6, 33, 3),
                                     (128, 56, 2), (4, 1, 2)])
def test_quad_kernel_matches_plain(card, dtype, g, n, cpw):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    q = _inputs(11, g, n, n, cpw, dtype, ndir=4)
    cuda_lib.clear_counts()
    got = gspn_multidir.gspn_scan_quad(*q)
    assert cuda_lib.launch_counts == {"gspn_quad_fwd": 1}
    assert got.dtype == dtype and got.shape == (4, g, n, n)
    assert _err_ok(got, gspn_multidir.gspn_scan_quad_torch(*q), tol)


# The single scan (#1) on whole planes (H <= 64: the ring holds the plane)
# and streamed ones (H = 200 and 512 pass through the 64-row ring), at the
# main widths, with and without a chunk reset.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [56, 200, 512])
@pytest.mark.parametrize("w", [28, 56])
def test_single_scan_over_whole_and_streamed_planes(card, dtype, h, w):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for chunk in (None, h // 4):
        a = _inputs(31, 8, h, w, 2, dtype)
        cuda_lib.clear_counts()
        got = gspn_scan.gspn_scan_fwd(*a, chunk=chunk)
        assert cuda_lib.launch_counts == {"gspn_scan_fwd": 1}, chunk
        assert got.dtype == dtype and got.shape == (8, h, w)
        assert _err_ok(got, gspn_scan.gspn_scan_fwd_torch(*a, chunk=chunk),
                       tol), chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", [((6, 201, 27), 3, None),
                                             ((6, 201, 27), 3, 67),
                                             ((5, 19, 37), 5, 19),
                                             ((4, 49, 7), 1, 7)])
def test_single_scan_planes_at_odd_offsets(card, dtype, shape, cpw, chunk):
    """Planes of an odd number of items: in bfloat16 every other plane (of
    x, lam, out and the taps) starts at a 2-byte boundary, and the ring's
    runs are widened to the words that cover them."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    a = _inputs(32, *shape, cpw, dtype)
    assert _err_ok(gspn_scan.gspn_scan_fwd(*a, chunk=chunk),
                   gspn_scan.gspn_scan_fwd_torch(*a, chunk=chunk), tol)


# The quad (#5): whole planes in the ring at N <= 56, streamed column slabs
# at N = 96 and 256; N = 7 and 19 give planes of an odd number of items.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [7, 19, 56, 96, 256])
@pytest.mark.parametrize("cpw", [1, 2, 4])
def test_quad_kernel_over_whole_and_streamed_slabs(card, dtype, n, cpw):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    q = _inputs(33, 2 * cpw, n, n, cpw, dtype, ndir=4)
    cuda_lib.clear_counts()
    got = gspn_multidir.gspn_scan_quad(*q)
    assert cuda_lib.launch_counts == {"gspn_quad_fwd": 1}
    assert got.dtype == dtype and got.shape == (4, 2 * cpw, n, n)
    assert _err_ok(got, gspn_multidir.gspn_scan_quad_torch(*q), tol)


def test_quad_reads_x_in_place(card):
    """The quad launches one kernel and allocates its output and nothing
    else: no copy of x stacked with its transpose, nor a transpose."""
    x, wl, wc, wr, lam = _inputs(34, 64, 56, 56, 2, torch.float32, ndir=4)
    x_bytes = x.numel() * x.element_size()
    gspn_multidir.gspn_scan_quad(x, wl, wc, wr, lam)   # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cuda_lib.clear_counts()
    out = gspn_multidir.gspn_scan_quad(x, wl, wc, wr, lam)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    assert cuda_lib.launch_counts == {"gspn_quad_fwd": 1}
    assert out.numel() == 4 * x.numel()
    assert grown < 4 * x_bytes + x_bytes // 2, grown


def test_quad_kernel_refuses_what_it_cannot_run(card):
    q = _inputs(12, 4, 6, 6, 2, torch.float32, ndir=4)
    with pytest.raises(ValueError, match="square"):
        gspn_multidir.gspn_scan_quad(q[0][:, :5], *q[1:])
    with pytest.raises(ValueError, match="forward-only"):
        gspn_multidir.gspn_scan_quad(q[0].requires_grad_(True), *q[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n,cpw", [(8, 19, 1), (128, 28, 2), (4, 96, 2)])
def test_template_instances_agree_bitwise(card, dtype, g, n, cpw):
    """The single scan (D = 1), the pair (D = 2) and the quad (D = 4) are
    instances of one template: on the same operands each direction gives
    the same bits in every instance, the quad's transposed directions
    (read from column slabs of x) the bits of the pair and the single scan
    on x transposed; at N = 96 the planes stream through the ring."""
    x, wl4, wc4, wr4, lam4 = _inputs(13, g, n, n, cpw, dtype, ndir=4)
    quad = gspn_multidir.gspn_scan_quad(x, wl4, wc4, wr4, lam4)
    xt = x.transpose(-1, -2).contiguous()
    for src, lo in ((x, 0), (xt, 2)):
        pair = gspn_multidir.gspn_scan_bidir(
            src, *(a[lo:lo + 2].contiguous() for a in (wl4, wc4, wr4, lam4)))
        single = gspn_scan.gspn_scan_fwd(
            src, *(a[lo].contiguous() for a in (wl4, wc4, wr4, lam4)))
        assert torch.equal(quad[lo:lo + 2], pair)
        assert torch.equal(pair[0], single)


def test_ladder_launch_counts(card):
    """The four-direction ladder at a small square shape: per direction
    four single scans, the pair dispatch two pair launches, the quad one
    launch, per_step none; the same counts from the kernel.launch spans;
    every rung equal to the pair rung."""
    x, wl, wc, wr, lam = _inputs(14, 8, 12, 12, 2, torch.float32, ndir=4)

    def quad():
        t = (lambda a: torch.stack([a[0], a[1], a[2].transpose(-1, -2),
                                    a[3].transpose(-1, -2)]).contiguous())
        out = gspn_multidir.gspn_scan_quad(x, t(wl), t(wc), t(wr), t(lam))
        return t(out)

    rungs = {
        "per_step": (lambda: directional_scan(x, wl, wc, wr, lam, DIRECTIONS,
                                              impl="per_step"), {}),
        "per_direction": (lambda: torch.stack([
            directional_scan(x, wl[i], wc[i], wr[i], lam[i], d)
            for i, d in enumerate(DIRECTIONS)]), {"gspn_scan_fwd": 4}),
        "pair": (lambda: directional_scan(x, wl, wc, wr, lam, DIRECTIONS),
                 {"gspn_pair_fwd": 2}),
        "quad": (quad, {"gspn_quad_fwd": 1}),
    }
    want = rungs["pair"][0]()
    try:
        for name, (fn, launches) in rungs.items():
            cuda_lib.clear_counts()
            obs.enable()
            out = fn()
            obs.disable()
            spans = {}
            for r in obs.spans("kernel.launch"):
                spans[r.args["kernel"]] = spans.get(r.args["kernel"], 0) + 1
            assert dict(cuda_lib.launch_counts) == launches == spans, name
            if name == "per_step":
                assert cuda_lib.plain_calls["per_step_row"] == 4 * 12
            assert _err_ok(out, want, 1e-5), name
    finally:
        obs.disable()


def test_ops_route_cuda_tensors_to_the_kernels(card):
    cuda_lib.clear_counts()
    p = _inputs(3, 4, 6, 5, 2, torch.float32, pair=True)
    x_t = p[0].transpose(-1, -2)                   # non-contiguous operand
    out = ops.gspn_scan_pair(x_t, *(t.transpose(-1, -2) for t in p[1:]))
    want = gspn_multidir.gspn_scan_bidir_torch(
        x_t.contiguous(), *(t.transpose(-1, -2).contiguous() for t in p[1:]))
    assert _err_ok(out, want, 1e-5)
    assert cuda_lib.launch_counts["gspn_pair_fwd"] == 1
    assert cuda_lib.plain_calls["gspn_pair_fwd"] == 1   # the reference above


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", SHAPES)
def test_adjoint_kernels_match_plain(card, dtype, shape, cpw, chunk):
    gen = torch.Generator(device="cuda").manual_seed(7)
    _, wl, wc, wr, lam = _inputs(3, *shape, cpw, dtype)
    _, wl2, wc2, wr2, lam2 = _inputs(4, *shape, cpw, dtype, pair=True)
    dy, dy2 = (torch.randn(t.shape, generator=gen, device="cuda").to(dtype)
               for t in (lam, lam2))
    got = gspn_scan.gspn_scan_bwd(dy, wl, wc, wr, chunk=chunk)
    assert got.dtype == torch.float32
    assert _err_ok(got, gspn_scan.gspn_scan_bwd_torch(dy, wl, wc, wr,
                                                      chunk=chunk), 1e-5)
    got2 = gspn_multidir.gspn_scan_bidir_bwd(dy2, wl2, wc2, wr2, chunk=chunk)
    assert got2.dtype == torch.float32
    assert _err_ok(got2, gspn_multidir.gspn_scan_bidir_bwd_torch(
        dy2, wl2, wc2, wr2, chunk=chunk), 1e-5)


RING_WIDTHS = [1, 7, 31, 32, 33, 56, 63, 64, 65, 255, 256, 1024]
# Heights around the ring depth S the launch shape picks: one row, two,
# one batch short of the ring, the ring, one past it, and three rings and
# a part, so the walk refills the ring mid-plane.
RING_HEIGHTS = {"1": lambda s: 1, "2": lambda s: 2, "S-1": lambda s: s - 1,
                "S": lambda s: s, "S+1": lambda s: s + 1,
                "3S+5": lambda s: 3 * s + 5}


def _proper_divisor(h):
    """A chunk length that divides H and is shorter than it (1 for a prime
    H), or None for H = 1."""
    return None if h == 1 else next(c for c in range(h // 2, 0, -1)
                                    if h % c == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("height", list(RING_HEIGHTS))
@pytest.mark.parametrize("w", RING_WIDTHS)
def test_pair_kernels_over_ring_shapes(card, w, height, dtype):
    """The pair forward and adjoint against their plain versions at widths
    around the lane mapping (K = 1…32 columns per lane), heights around the
    ring depth S of each launch shape, cpw 1, 2, 3, 4 and 33 (33 splits a
    group over CTAs), without and with a chunk reset; two weight groups,
    so with W·H odd the bfloat16 planes after the first start at a 2-byte
    boundary."""
    ftol = 1e-5 if dtype == torch.float32 else 1e-2
    for cpw in (1, 2, 3, 4, 33):
        g = 2 * cpw
        for kind in ("fwd", "bwd"):
            s = gspn_scan.pair_launch_shape(g, 64, w, cpw, dtype, kind)
            h = max(1, RING_HEIGHTS[height](s.stages))
            for chunk in (None, _proper_divisor(h)):
                x, wl, wc, wr, lam = _inputs(21, g, h, w, cpw, dtype,
                                             pair=True)
                where = (kind, cpw, h, chunk)
                if kind == "fwd":
                    got = gspn_multidir.gspn_scan_bidir(x, wl, wc, wr, lam,
                                                        chunk=chunk)
                    want = gspn_multidir.gspn_scan_bidir_torch(
                        x, wl, wc, wr, lam, chunk=chunk)
                    assert got.dtype == dtype, where
                    assert _err_ok(got, want, ftol), where
                else:
                    dy = (lam - 0.5).contiguous()
                    got = gspn_multidir.gspn_scan_bidir_bwd(dy, wl, wc, wr,
                                                            chunk=chunk)
                    want = gspn_multidir.gspn_scan_bidir_bwd_torch(
                        dy, wl, wc, wr, chunk=chunk)
                    assert got.dtype == torch.float32, where
                    assert _err_ok(got, want, 1e-5), where


# The single adjoint (#2) where it runs: the main widths, 1024² stage 1,
# the LM mixer's T→B pass (H = 4 rows of 1024) and its within-row pass
# transposed (1024 rows of 4) at cpw 8, a chunked LM shape, ragged shapes.
SINGLE_BWD_SHAPES = [((128, n, n), 2, None) for n in (56, 28, 14, 7)] + [
    ((32, 256, 256), 2, None), ((128, 4, 1024), 8, None),
    ((128, 1024, 4), 8, None), ((128, 32, 1024), 8, 8),
    ((8, 19, 37), 1, None), ((8, 19, 37), 4, None)]


def _adjoint_inputs(seed, shape, cpw, dtype):
    """(dy, wl, wc, wr) of the single adjoint, dy in (-0.5, 0.5)."""
    _, wl, wc, wr, lam = _inputs(seed, *shape, cpw, dtype)
    return (lam.float() - 0.5).to(dtype).contiguous(), wl, wc, wr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", SINGLE_BWD_SHAPES)
def test_single_adjoint_matches_plain(card, dtype, shape, cpw, chunk):
    """#2, the D = 1 instance of the adjoint template, against its plain
    version: 1e-5 of the largest magnitude in both stream dtypes (f32
    arithmetic and output from the same inputs), one launch."""
    a = _adjoint_inputs(41, shape, cpw, dtype)
    cuda_lib.clear_counts()
    got = gspn_scan.gspn_scan_bwd(*a, chunk=chunk)
    assert cuda_lib.launch_counts == {"gspn_scan_bwd": 1}
    assert got.dtype == torch.float32 and got.shape == shape
    assert _err_ok(got, gspn_scan.gspn_scan_bwd_torch(*a, chunk=chunk), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("height", list(RING_HEIGHTS))
@pytest.mark.parametrize("w", RING_WIDTHS)
def test_single_adjoint_over_ring_shapes(card, w, height, dtype):
    """#2 at widths around the lane mapping and its layouts (W > 128
    spreads a row over warps: in windows on the planes of up to 16 rows
    here, in bands from the ring on the taller ones), heights around the
    ring depth S of its launch shape at H = 64, cpw 1, 2, 8 and 33,
    without and with a chunk reset."""
    for cpw in (1, 2, 8, 33):
        s = gspn_scan.pair_launch_shape(2 * cpw, 64, w, cpw, dtype, "bwd", 1)
        h = max(1, RING_HEIGHTS[height](s.stages))
        for chunk in (None, _proper_divisor(h)):
            a = _adjoint_inputs(42, (2 * cpw, h, w), cpw, dtype)
            got = gspn_scan.gspn_scan_bwd(*a, chunk=chunk)
            assert _err_ok(got, gspn_scan.gspn_scan_bwd_torch(
                *a, chunk=chunk), 1e-5), (cpw, h, chunk)


def _adjoint_with_shape(dy, wl, wc, wr, chunk, shape):
    """#2 launched through the library's C entry with launch ``shape``."""
    lib = cuda_lib.library("gspn_pair")
    g, h, w = dy.shape
    out = torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
    err = lib.gspn_bwd_launch(
        1, 0 if dy.dtype == torch.float32 else 1, dy.data_ptr(),
        wl.data_ptr(), wc.data_ptr(), wr.data_ptr(), out.data_ptr(), g, h, w,
        g // wl.shape[0], gspn_scan.chunk_arg(h, chunk), shape.planes,
        shape.warps, shape.k, shape.splits, shape.batch, shape.nbuf,
        shape.bands, int(shape.direct), shape.smem_bytes,
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, err, "gspn_scan_bwd")
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", [((4, 37, 129), 2, None),
                                             ((32, 256, 256), 2, None),
                                             ((16, 9, 1000), 8, 3),
                                             ((128, 4, 1024), 8, None),
                                             ((6, 1, 200), 3, None),
                                             ((8, 16, 160), 2, 4),
                                             ((8, 24, 1024), 8, 6)])
def test_adjoint_layouts_agree_bitwise(card, dtype, shape, cpw, chunk):
    """A row spread over 2 to 32 warps of a plane from the ring, or walked
    in windows of 32, 64 or 128 columns straight from device memory (where
    a window is wider than 2H; all of a row's windows to a CTA that the
    registers allow, or 3), gives the bits of one warp per plane (K = 8 or
    32 columns per lane) on the same operands: only the neighbours at the
    band edges, or the columns a window stores, are reached otherwise."""
    a = _adjoint_inputs(43, shape, cpw, dtype)
    g, h, w = shape
    one_warp = gspn_scan.pair_launch_shape(g, h, w, cpw, dtype, "bwd", 1,
                                           bands=1)
    one = _adjoint_with_shape(*a, chunk, one_warp)
    assert _err_ok(one, gspn_scan.gspn_scan_bwd_torch(*a, chunk=chunk), 1e-5)
    layouts = [{"bands": b} for b in (2, 4, 8, 16, 32)
               if 1 <= one_warp.k // b <= 4]
    layouts += [{"direct": True, "window_k": k, "bands": per}
                for k in (1, 2, 4) if 32 * k > 2 * h for per in (None, 3)]
    for layout in layouts:
        s = gspn_scan.pair_launch_shape(g, h, w, cpw, dtype, "bwd", 1,
                                        **layout)
        assert torch.equal(_adjoint_with_shape(*a, chunk, s), one), layout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", [((8, 19, 37), 4, None),
                                             ((8, 18, 37), 4, 6),
                                             ((128, 56, 56), 2, None),
                                             ((6, 9, 1024), 3, 3),
                                             ((32, 256, 256), 2, None),
                                             ((128, 4, 1024), 8, None),
                                             ((128, 1024, 4), 8, None),
                                             ((128, 32, 1024), 8, 8)])
def test_pair_adjoint_agrees_with_single_adjoint_bitwise(card, dtype, shape,
                                                         cpw, chunk):
    """Direction 0 of the pair adjoint walks H-1..0 as the single adjoint
    (#2) does: on the same operands both give the same bits, the single
    adjoint's rows of more than 128 columns spread over warps in windows
    (up to 16 rows) or bands."""
    _, wl2, wc2, wr2, lam2 = _inputs(22, *shape, cpw, dtype, pair=True)
    dy2 = (lam2 - 0.5).contiguous()
    pair = gspn_multidir.gspn_scan_bidir_bwd(dy2, wl2, wc2, wr2, chunk=chunk)
    single = gspn_scan.gspn_scan_bwd(dy2[0], wl2[0], wc2[0], wr2[0],
                                     chunk=chunk)
    assert torch.equal(pair[0], single)


def test_pair_wrappers_refuse_rows_wider_than_1024(card):
    """On CUDA tensors the pair wrappers launch the kernel or raise: a row
    of 1025 columns raises, and no plain version runs instead."""
    x, wl, wc, wr, lam = _inputs(23, 2, 3, 1025, 1, torch.float32, pair=True)
    cuda_lib.clear_counts()
    with pytest.raises(ValueError, match="1024"):
        gspn_multidir.gspn_scan_bidir(x, wl, wc, wr, lam)
    with pytest.raises(ValueError, match="1024"):
        gspn_multidir.gspn_scan_bidir_bwd(lam, wl, wc, wr)
    assert not cuda_lib.launch_counts and not cuda_lib.plain_calls


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("shape,cpw,chunk", [((8, 19, 37), 2, None),
                                             ((8, 18, 13), 4, 6)])
def test_op_gradients_on_card_match_cpu(card, pair, shape, cpw, chunk):
    """The autograd Functions: kernels forward and backward on the card,
    plain versions on the CPU, from the same inputs; the gradient reaches
    the Function transposed (non-contiguous)."""
    args = _inputs(5, *shape, cpw, torch.float32, pair=pair)
    r = torch.randn(((2,) if pair else ()) + shape[:1] + shape[:0:-1],
                    generator=torch.Generator(device="cuda").manual_seed(8),
                    device="cuda")
    op, kernel = (ops.gspn_scan_pair, "gspn_pair_bwd") if pair else \
        (ops.gspn_scan, "gspn_scan_bwd")

    def grads(tensors):
        leaves = [t.clone().requires_grad_(True) for t in tensors]
        out = op(*leaves, chunk=chunk)
        loss = (out.transpose(-1, -2) * r.to(out.device)).sum()
        return torch.autograd.grad(loss, leaves)

    cuda_lib.clear_counts()
    got = grads(args)
    assert cuda_lib.launch_counts[kernel] == 1
    assert sum(cuda_lib.plain_calls.values()) == 0
    want = grads([t.cpu() for t in args])
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _err_ok(a.cpu(), b, 1e-5)


def _train_two_steps(model, batches):
    params = dict(model.named_parameters())
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2,
                       weight_decay=0.01)
    opt = adamw_init(ocfg, params)
    losses, first_grads = [], None
    for batch in batches:
        loss, _ = vision_loss(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        first_grads = first_grads or dict(zip(params, grads))
        adamw_update(ocfg, dict(zip(params, grads)), opt, params)
        losses.append(loss.item())
    return losses, first_grads


def test_reduced_train_step_on_card_matches_cpu(card):
    """Two AdamW steps of the reduced model: the card's kernel path
    against the CPU's plain path from the same weights and images."""
    cfg = reduced_vision()
    cpu = GSPNVision(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(9))
    gpu = GSPNVision(cfg, device="meta")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                        assign=True)
    gen = torch.Generator().manual_seed(10)
    batches = [{"images": torch.randn((4, cfg.img_size, cfg.img_size, 3),
                                      generator=gen),
                "labels": torch.randint(0, cfg.n_classes, (4,),
                                        generator=gen)} for _ in range(2)]
    want_losses, want_grads = _train_two_steps(cpu, batches)
    cuda_lib.clear_counts()
    got_losses, got_grads = _train_two_steps(
        gpu, [{k: v.cuda() for k, v in b.items()} for b in batches])
    n = 2 * 2 * sum(cfg.depths)
    assert cuda_lib.launch_counts == {"gspn_pair_fwd": n, "gspn_pair_bwd": n}
    assert sum(cuda_lib.plain_calls.values()) == 0
    assert got_losses == pytest.approx(want_losses, rel=1e-4)
    for name, want in want_grads.items():
        assert _err_ok(got_grads[name].cpu(), want, 1e-4), name


def test_reduced_model_on_card_matches_cpu(card):
    cfg = reduced_vision()
    cpu = GSPNVision(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(5)).eval()
    gpu = GSPNVision(cfg, device="meta").eval()
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                        assign=True)
    x = torch.randn((3, cfg.img_size, cfg.img_size, 3),
                    generator=torch.Generator().manual_seed(6))
    want = apply_vision(cpu, x)
    cuda_lib.clear_counts()
    got = apply_vision(gpu, x.cuda())
    assert cuda_lib.launch_counts == {"gspn_pair_fwd": 2 * sum(cfg.depths)}
    assert sum(cuda_lib.plain_calls.values()) == 0
    assert _err_ok(got.cpu(), want, 1e-4)
    plain = GSPNVision(dataclasses.replace(cfg, impl="torch"),
                       device="meta").eval()
    plain.load_state_dict(gpu.state_dict(), assign=True)
    assert _err_ok(got, apply_vision(plain, x.cuda()), 1e-4)


# The single scan's planes on the LM serving path, cpw 8 (C_proxy): T→B
# passes of one-shot prefills of 1 or 2 rows and of a seeded chunk of
# 4096 tokens (5 rows), and the within-row passes of 1024 rows of 1, 2 and
# (batch 4) 4 columns.
SERVING_SHAPES = [(8, 1, 1024), (8, 2, 1024), (8, 5, 1024), (8, 1024, 1),
                  (8, 1024, 2), (32, 1024, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SERVING_SHAPES)
def test_single_scan_at_the_serving_shapes(card, dtype, shape):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    a = _inputs(11, *shape, 8, dtype)
    cuda_lib.clear_counts()
    got = gspn_scan.gspn_scan_fwd(*a)
    assert cuda_lib.launch_counts == {"gspn_scan_fwd": 1}
    assert _err_ok(got, gspn_scan.gspn_scan_fwd_torch(*a), tol)


def test_reduced_lm_on_card_matches_cpu(card):
    """The reduced LM under its f32 policy: prefill, a chunk chain and
    decode steps on the card (kernel #1) against the CPU (plain scan)
    from the same weights: logits 1e-4 of the largest magnitude; two
    launches of #1 a layer per prefill or chunk, none per decode step,
    no plain scan on the card."""
    cfg = with_precision(reduced_lm(), "f32")
    cpu = lm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = lm.LM(cfg, device="meta")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                        assign=True)
    toks = torch.randint(0, cfg.vocab, (2, 29),
                         generator=torch.Generator().manual_seed(4))
    per_pass = {"gspn_scan_fwd": 2 * cfg.n_layers}

    def run(model, dev):
        t = toks.to(dev)
        counts, outs = [], []

        def step(fn):
            cuda_lib.clear_counts()
            out = fn()
            counts.append((dict(cuda_lib.launch_counts),
                           sum(cuda_lib.plain_calls.values())))
            outs.append(out[0])
            return out[1]

        with torch.no_grad():
            caches = step(lambda: lm.lm_prefill(model, t[:, :26], 29))
            c = lm.init_lm_cache(cfg, 2, 29, device=dev)
            for lo, hi in ((0, 16), (16, 26)):
                c = step(lambda: lm.lm_prefill_chunk(model, t[:, lo:hi], c,
                                                     lo))
            for i in range(26, 29):
                caches = step(lambda: lm.lm_decode_step(
                    model, t[:, i:i + 1], caches))
        return counts, [o.cpu() for o in outs]

    _, want = run(cpu, "cpu")
    counts, got = run(gpu, "cuda")
    assert counts == [(per_pass, 0)] * 3 + [({}, 0)] * 3
    for g, w in zip(got, want):
        assert _err_ok(g, w, 1e-4)


def test_threaded_replicas_on_their_own_streams_give_the_engine_tokens(card):
    """Two replicas on worker threads share one reduced LM on the card,
    each engine on its own CUDA stream, with a shared prefix cache: every
    request's greedy tokens equal the single engine's, and the kernel
    launches add up to the single engine's."""
    import numpy as np

    from repro_torch.serve.cache import PrefixStateCache
    from repro_torch.serve.engine import Request, ServeEngine, drive
    from repro_torch.serve.router import Router

    cfg = with_precision(reduced_lm(), "f32")
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(3))
    rng = np.random.default_rng(5)
    head = rng.integers(0, cfg.vocab, 24)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, n)])
               for n in (9, 2, 14, 5, 30, 7, 1, 11)]

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]

    def engine(seed=0, cache=None):
        return ServeEngine(model, batch_size=2, max_len=96, prefill_chunk=8,
                           seed=seed, prefix_cache=cache)

    single = engine()
    assert single.cuda_stream is not None
    assert single.cuda_stream != torch.cuda.current_stream()
    cuda_lib.clear_counts()
    for r in reqs():
        single.submit(r)
    want = {u: r.tokens for u, r in single.run().items()}
    launches = dict(cuda_lib.launch_counts)
    cache = PrefixStateCache()
    router = Router([engine(i, cache) for i in range(2)], threaded=True)
    assert router.replicas[0].engine.cuda_stream != \
        router.replicas[1].engine.cuda_stream
    cuda_lib.clear_counts()
    router.start()
    try:
        _dt, handles = drive(router, reqs(), [0.0] * len(prompts))
    finally:
        router.stop()
    torch.cuda.synchronize()
    assert {h.uid: h.result().tokens for h in handles} == want
    assert {h.replica for h in handles} == {0, 1}
    assert sum(h.result().cached_tokens for h in handles) > 0
    assert sum(cuda_lib.launch_counts.values()) <= sum(launches.values())
    assert not cuda_lib.plain_calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["fwd", "bwd", "pair_fwd", "pair_bwd",
                                       "quad"])
def test_every_tuner_candidate_matches_plain(card, dtype, direction):
    """Every launch shape the tuner may emit at one small shape of each
    kernel (G = 16, cpw 4, 24 rows of 24 columns, and the single adjoint
    at 12 rows of 300 columns: bands and windows) against the plain
    version: 1e-5 of the largest magnitude, 1e-2 for a bfloat16
    forward."""
    from repro_torch.kernels import autotune

    h, w = (12, 300) if direction == "bwd" else (24, 24)
    key = autotune.ScanKey(autotune.device_kind("cuda"), 16, h, w, 4,
                           direction, str(dtype)[6:])
    cands = autotune.enumerate_candidates(key)
    assert len(cands) > 4
    checked = autotune.check_candidates(key, cands)
    bad = [(c.label(), e, tol) for c, e, tol in checked if not e <= tol]
    assert not bad


# ---------------------------------------------------------------------------
# LM training on the card: a narrow LM with the full model's 1024-wide rows.
# ---------------------------------------------------------------------------

def _narrow_lm(precision="f32", **kw):
    """2 layers, d 64, C_proxy 8, row width 1024: 2048 tokens fold into 2
    rows of 1024, the within-row pass into 1024 rows of 2 columns."""
    return dataclasses.replace(
        with_precision(reduced_lm(), precision), d_model=64,
        gspn_proxy_dim=8, gspn_row_width=1024, **kw)


def _lm_batch(cfg, seed=0, n=1, seq=2048):
    toks = torch.randint(0, cfg.vocab, (n, seq + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}


def test_lm_loss_gradients_on_card_match_plain(card):
    """``lm_loss`` and every parameter's gradient through #1 and #2
    against the plain scans on the card (f32, TF32 off): loss 1e-5
    relative, gradients 1e-4 of each one's largest magnitude."""
    cfg = _narrow_lm()
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    plain = lm.LM(dataclasses.replace(cfg, gspn_impl="torch"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = _lm_batch(cfg)

    def loss_and_grads(m):
        loss, _ = lm.lm_loss(m, batch)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    cuda_lib.clear_counts()
    loss, grads = loss_and_grads(model)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {"gspn_scan_fwd": 4,
                                            "gspn_scan_bwd": 4}
    assert not cuda_lib.plain_calls
    want_loss, want = loss_and_grads(plain)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for g, w in zip(grads, want):
        assert torch.isfinite(g).all()
        assert _err_ok(g, w, 1e-4)


@pytest.mark.parametrize("remat,fwd", [("none", 4), ("unit", 8)])
def test_lm_train_step_launches_on_card(card, remat, fwd):
    """One train step's launches: two scans a layer forward, two adjoints
    a layer backward, and the forward's again under rematerialisation;
    no plain scan."""
    from repro_torch.train.step import build_train_step, init_train_state

    cfg = _narrow_lm(remat=remat)
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(1))
    ocfg = AdamWConfig()
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    batch = _lm_batch(cfg, seed=1)
    cuda_lib.clear_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {"gspn_scan_fwd": fwd,
                                            "gspn_scan_bwd": 4}
    assert dict(cuda_lib.launch_shapes) == {
        ("gspn_scan_fwd", 8, 2, 1024, "float32"): fwd // 2,
        ("gspn_scan_fwd", 8, 1024, 2, "float32"): fwd // 2,
        ("gspn_scan_bwd", 8, 2, 1024, "float32"): 2,
        ("gspn_scan_bwd", 8, 1024, 2, "float32"): 2}
    assert not cuda_lib.plain_calls
    assert torch.isfinite(metrics["loss"]) and state["opt"]["step"] == 1


def test_bf16_master_weight_step_on_card(card):
    """One step under the ``bf16`` preset with the f32 master copy and
    loss scaling: finite gradients, the working copy equal to the master
    rounded to bf16, the scans' bf16 instances launched."""
    from repro_torch.train.step import (LossScaleConfig, build_train_step,
                                        init_train_state)

    cfg = _narrow_lm("bf16", remat="unit")
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(2))
    ocfg, ls = AdamWConfig(), LossScaleConfig()
    state = init_train_state(model, ocfg, master_weights=True,
                             loss_scaling=ls)
    step = build_train_step(model, ocfg, master_weights=True,
                            loss_scaling=ls)
    cuda_lib.clear_counts()
    state, metrics = step(state, _lm_batch(cfg, seed=2))
    torch.cuda.synchronize()
    assert float(metrics["grads_finite"]) == 1.0
    assert state["opt"]["step"] == 1
    assert {k[-1] for k in cuda_lib.launch_shapes} == {"bfloat16"}
    assert dict(cuda_lib.launch_counts) == {"gspn_scan_fwd": 8,
                                            "gspn_scan_bwd": 4}
    for n, p in state["params"].items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, state["master"][n].to(torch.bfloat16)), n


# ---------------------------------------------------------------------------
# The attn kind on the card (plain PyTorch products, no kernel of its own).
# ---------------------------------------------------------------------------

def test_attention_lm_on_card_matches_cpu(card):
    """The reduced qwen2-1.5b under its f32 policy, blockwise attention at
    attn_block_k 8: prefill, a chunk chain and decode steps, and lm_loss
    with every gradient, on the card against the CPU from the same
    weights (1e-4 of the largest magnitude); no scan launches."""
    from repro_torch.configs.qwen2_1_5b import reduced as reduced_attn

    cfg = dataclasses.replace(with_precision(reduced_attn(), "f32"),
                              attn_block_k=8)
    cpu = lm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    gpu = lm.LM(cfg, device="meta")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                        assign=True)
    toks = torch.randint(0, cfg.vocab, (2, 30),
                         generator=torch.Generator().manual_seed(6))

    def run(model, dev):
        t = toks.to(dev)
        outs = []
        with torch.no_grad():
            logits, caches = lm.lm_prefill(model, t[:, :26], 32)
            outs.append(logits)
            c = lm.init_lm_cache(cfg, 2, 32, device=dev)
            for lo, hi in ((0, 11), (11, 26)):
                logits, c = lm.lm_prefill_chunk(model, t[:, lo:hi], c, lo)
                outs.append(logits)
            for i in range(26, 30):
                logits, caches = lm.lm_decode_step(model, t[:, i:i + 1],
                                                   caches)
                outs.append(logits)
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        loss, _ = lm.lm_loss(model, batch)
        outs.append(loss)
        outs.extend(torch.autograd.grad(loss, list(model.parameters())))
        return [o.detach().cpu() for o in outs]

    want = run(cpu, "cpu")
    cuda_lib.clear_counts()
    got = run(gpu, "cuda")
    assert not cuda_lib.launch_counts and not cuda_lib.plain_calls
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _err_ok(g, w, 1e-4)


def _exact_attention(q, k, v):
    """Causal GQA attention in f64, returned in q's dtype."""
    import math

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(d)
    i = torch.arange(s, device=q.device)
    p = torch.softmax(torch.where(i[None, :] <= i[:, None], logits,
                                  -math.inf), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.double())
    return out.reshape(b, s, hq, d).to(q.dtype)


def test_chunked_attention_is_within_f32_rounding_of_exact(card):
    """One qwen2-1.5b layer's attention at 1 x 4096 (12 over 2 heads, 128)
    in f32: the blockwise path and its two-sweep adjoint within 1e-5 of
    the exact (f64) attention, forward and gradients.  Witness for
    holding it against ``full_attention`` at 2e-5: the dense path's own
    f32 dv (a 24 576-term sum per element) carries at least half of the
    two paths' disagreement (8.9e-6 of 1.03e-5 measured)."""
    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = ((1, 4096, 12, 128), (1, 4096, 2, 128), (1, 4096, 2, 128))
    qkv = [torch.randn(s, generator=gen, device="cuda").requires_grad_()
           for s in shapes]
    ct = torch.randn(shapes[0], generator=gen, device="cuda")
    outs = {}
    for name, fn in (("chunked", attention.chunked_attention),
                     ("full", attention.full_attention),
                     ("exact", _exact_attention)):
        out = fn(*qkv)
        outs[name] = (out.detach(), *torch.autograd.grad(out, qkv, ct))

    def errs(a, b):
        return [((x.double() - y.double()).abs().max()
                 / y.double().abs().max()).item()
                for x, y in zip(outs[a], outs[b])]

    assert max(errs("chunked", "exact")) <= 1e-5
    apart = errs("chunked", "full")
    assert max(apart) <= 2e-5
    assert errs("full", "exact")[3] >= 0.5 * apart[3]


# ---------------------------------------------------------------------------
# Sequence parallelism of the scan (parallel/gspn_sp.py).
# ---------------------------------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sp_world_size_one_over_nccl_is_the_kernel_call(card):
    """One rank over NCCL: both sharded entry points are the unsharded
    kernel call, bit for bit, launching #1 and #3 and no plain scan."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import backend_for, make_sp_mesh
    from repro_torch.parallel import gspn_sp as sp
    assert backend_for(card, 1) == "nccl"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        mesh = make_sp_mesh(1)
        a = _inputs(20, 16, 12, 40, 2, torch.float32)
        p = _inputs(21, 16, 12, 40, 2, torch.float32, pair=True)
        cuda_lib.clear_counts()
        got = sp.gspn_scan_sp(*a, mesh=mesh)
        got2 = sp.gspn_scan_sp_pair(*p, mesh=mesh)
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts == {"gspn_scan_fwd": 1,
                                          "gspn_pair_fwd": 1}
        assert not cuda_lib.plain_calls
        assert torch.equal(got, ops.gspn_scan(*a))
        assert torch.equal(got2, ops.gspn_scan_pair(*p))
    finally:
        dist.destroy_process_group()


# One rank of a gloo group on the card: the fused pair and one direction,
# forward and gradients, against the unsharded kernel call; the block-local
# launches carry sp_block_local.
_SP_RANK = """
import sys
import torch
from repro_torch.kernels import cuda_lib, ops
from repro_torch.launch.mesh import init_distributed, make_sp_mesh
from repro_torch.parallel import gspn_sp as sp
init_distributed(torch.device("cuda"))
mesh = make_sp_mesh()
gen = torch.Generator(device="cuda").manual_seed(3)

def inputs(lead):
    x = torch.randn((16, 19, 24), generator=gen, device="cuda")
    taps = torch.softmax(torch.randn(lead + (8, 19, 24, 3), generator=gen,
                                     device="cuda"), dim=-1)
    lam = torch.rand(lead + (16, 19, 24), generator=gen, device="cuda")
    return [t.contiguous().requires_grad_() for t in
            (x, taps[..., 0], taps[..., 1], taps[..., 2], lam)]

cuda_lib.clear_counts()
for fn, ref, lead in ((sp.gspn_scan_sp_pair, ops.gspn_scan_pair, (2,)),
                      (sp.gspn_scan_sp, ops.gspn_scan, ())):
    a = inputs(lead)
    out = fn(*a, mesh=mesh)
    want = ref(*a)
    dy = torch.randn(want.shape, generator=gen, device="cuda")
    for got, exp in zip((out, *torch.autograd.grad(out, a, dy)),
                        (want, *torch.autograd.grad(want, a, dy))):
        err = (got - exp).abs().max() / exp.abs().max()
        assert err <= 1e-5, err.item()
torch.cuda.synchronize()
for name in ("gspn_scan_fwd", "gspn_scan_bwd", "gspn_pair_fwd",
             "gspn_pair_bwd"):
    assert cuda_lib.launch_boundaries[(name, "sp_block_local")] == 1, name
assert not cuda_lib.plain_calls
"""


def test_sp_two_ranks_over_gloo_match_the_kernel(card):
    """Two ranks sharing the card over gloo (the exchange staged through
    host memory) hold the fused pair and one direction, forward and
    gradients, to the unsharded kernel call at 1e-5."""
    import os
    import pathlib
    import subprocess
    import sys
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1]
                              / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _SP_RANK],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs


def _two_ranks(code):
    """Run ``code`` in two ranks that share the card over gloo; both must
    exit 0."""
    import os
    import pathlib
    import subprocess
    import sys
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1]
                              / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs


# Every collective the data axis issues, on CUDA tensors over gloo and
# counted: FSDP2's gather and reduce-scatter, the all-reduces of the
# replicated gradients, the norm, the int8 scale (MAX) and payload
# (int32), and the pipeline's ring shift (through host memory: gloo's
# send and receive take no CUDA tensor).
_DP_COLLECTIVES = """
import torch, torch.distributed as dist
from repro_torch.launch.mesh import init_distributed, make_mesh_for_devices
from repro_torch.parallel import collectives as C
from repro_torch.parallel.pipeline import _ring_shift
init_distributed(torch.device("cuda"))
r = dist.get_rank()
x = torch.full((4, 6), float(r + 1), device="cuda")
g = dist.group.WORLD
out = torch.empty(8, 6, device="cuda")
C.CountedAllGather()(out, x, g)
assert (out[:4] == 1).all() and (out[4:] == 2).all()
out = torch.empty_like(x)
C.CountedReduceScatter()(out, torch.cat([x, 2 * x]), g, dist.ReduceOp.SUM)
assert (out == (3 if r == 0 else 6)).all()
assert (C.all_reduce_counted(x.clone(), g) == 3).all()
assert (C.all_reduce_counted(x.clone(), g, dist.ReduceOp.MAX) == 2).all()
assert (C.all_reduce_counted(x.to(torch.int32), g) == 3).all()
assert C.staged_bytes["all_gather"] == 96 + 192
fn = C.compressed_allreduce(make_mesh_for_devices(
    range(2), model_parallel=1, device_type="cuda"), "data")
gh, e = fn({"g": x}, {"g": torch.zeros_like(x)})
scale = torch.tensor(2.0) / 127          # the shared amax over 127
q = torch.round(torch.tensor(float(r + 1)) / scale)   # 64 and 127
assert torch.allclose(gh["g"].cpu(), torch.full((4, 6), float(
    (64 + 127) * scale / 2)))
assert torch.allclose(e["g"].cpu(), torch.full((4, 6), float(
    r + 1 - q * scale)))
y = _ring_shift(x, (r + 1) % 2, (r - 1) % 2, g, True)
assert (y == (2 if r == 0 else 1)).all()
dist.destroy_process_group()
"""


def test_dp_collectives_on_cuda_tensors_over_gloo(card):
    """Two ranks sharing the card over gloo: every collective of the data
    axis on CUDA tensors, counted."""
    _two_ranks(_DP_COLLECTIVES)


# The reduced LM's placements and one sharded step on the card against the
# one-rank step (f32 policy, TF32 off), #1 and #2 launched, no plain scan.
_DP_STEP = """
import dataclasses, torch, torch.distributed as dist
from repro_torch.configs.base import with_precision
from repro_torch.configs.qwen2_1_5b_gspn import reduced
from repro_torch.data.pipeline import DataConfig, host_batch, to_device
from repro_torch.kernels import cuda_lib
from repro_torch.launch.mesh import init_distributed, make_mesh_for_devices
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import sharded_dim
from repro_torch.train.step import make_train_setup
torch.backends.cuda.matmul.allow_tf32 = False
init_distributed(torch.device("cuda"))
r = dist.get_rank()
cfg = dataclasses.replace(with_precision(reduced(), "f32"), remat="unit")
ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
mesh = make_mesh_for_devices(range(2), model_parallel=1, device_type="cuda")
sh = make_train_setup(cfg, ocfg, mesh=mesh, device="cuda",
                      grad_compression="int8_ef")
one = make_train_setup(cfg, ocfg, device="cuda", grad_compression="int8_ef")
for n, p in sh.state["params"].items():
    want = list(one.state["params"][n].shape)
    d = sharded_dim(sh.param_specs[n], "data")
    if d is not None:
        want[d[0]] //= 2
    for t in (p, sh.state["opt"]["m"][n], sh.state["errors"][n]):
        assert list(t.shape) == want, (n, list(t.shape), want)
    assert p.is_cuda
dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
cuda_lib.clear_counts()
_, m = sh.train_step(sh.state, to_device(host_batch(
    dataclasses.replace(dc, n_hosts=2, host_id=r), 0), "cuda"))
torch.cuda.synchronize()
assert cuda_lib.launch_counts["gspn_scan_fwd"] == 8
assert cuda_lib.launch_counts["gspn_scan_bwd"] == 4
assert not cuda_lib.plain_calls
_, m1 = one.train_step(one.state, to_device(host_batch(dc, 0), "cuda"))
assert abs(float(m["loss"]) - float(m1["loss"])) <= 1e-5 * abs(float(m1["loss"]))
assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) <= 1e-5 * float(m1["grad_norm"])
dist.destroy_process_group()
"""


def test_dp_placements_and_a_sharded_step_on_card(card):
    """The reduced LM on 2 ranks sharing the card: every parameter, moment
    and residual holds the shape its spec gives, and one int8_ef step
    launches #1 and #2 and matches the one-rank step's loss and norm."""
    _two_ranks(_DP_STEP)


# ---------------------------------------------------------------------------
# The SSM and xLSTM families (plain PyTorch on the card: no kernel of their
# own, and no scan).
# ---------------------------------------------------------------------------

def test_chunked_gla_on_card_equals_its_recurrence(card):
    """chunked_gla against a loop of gla_decode_step over the same tokens,
    f32, TF32 off: 64 tokens in chunks of 16 and 63 (chunks of one),
    outputs and final state within 1e-5 of the largest magnitude."""
    from repro_torch.models.ssm import chunked_gla, gla_decode_step

    gen = torch.Generator(device="cuda").manual_seed(0)
    for s in (64, 63):
        q, k = (torch.randn((2, s, 3, 8), generator=gen, device="cuda")
                for _ in range(2))
        v = torch.randn((2, s, 3, 9), generator=gen, device="cuda")
        ld = -torch.rand((2, s, 3), generator=gen, device="cuda")
        y, st = chunked_gla(q, k, v, ld, chunk=16)
        state = torch.zeros((2, 3, 8, 9), device="cuda")
        ys = []
        for t in range(s):
            yt, state = gla_decode_step(state, q[:, t], k[:, t], v[:, t],
                                        ld[:, t])
            ys.append(yt)
        assert _err_ok(torch.stack(ys, 1), y, 1e-5), s
        assert _err_ok(state, st, 1e-5), s


def test_causal_conv_stream_equals_full_on_card(card):
    from repro_torch.models.layers import CausalConv1d

    conv = CausalConv1d(40, 4, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    x = torch.randn((2, 11, 40), device="cuda")
    with torch.no_grad():
        full, _ = conv(x)
        state = torch.zeros((2, 3, 40), device="cuda")
        steps = []
        for t in range(11):
            y, state = conv(x[:, t:t + 1], state)
            steps.append(y)
    assert torch.equal(torch.cat(steps, 1), full)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_recurrent_lm_on_card_matches_cpu(card, arch):
    """The reduced zamba2 (mamba + the shared attn block) and xlstm (mlstm
    + slstm) under the f32 policy: apply_lm, lm_prefill and 3 decode steps
    on the card against the same weights on the CPU (logits 1e-4), with
    no scan launched."""
    from repro_torch.configs.base import get_arch

    cfg = with_precision(get_arch(arch).reduced(), "f32")
    cpu = lm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = lm.LM(cfg, device="meta")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                        assign=True)
    toks = torch.randint(0, cfg.vocab, (2, 21),
                         generator=torch.Generator().manual_seed(4))
    outs = {}
    cuda_lib.clear_counts()
    for name, model, t in (("cpu", cpu, toks), ("cuda", gpu, toks.cuda())):
        with torch.no_grad():
            full = lm.apply_lm(model, t)
            logits, caches = lm.lm_prefill(model, t[:, :18], 32)
            steps = []
            for i in range(18, 21):
                lg, caches = lm.lm_decode_step(model, t[:, i:i + 1], caches)
                steps.append(lg)
        outs[name] = (full, logits, torch.cat(steps, 1))
    assert not cuda_lib.launch_counts and not cuda_lib.plain_calls
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _err_ok(got.cpu(), want, 1e-4)
    assert _err_ok(outs["cuda"][2].cpu(), outs["cpu"][0][:, 18:], 1e-4)


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_card_matches_the_per_expert_loop(card, dtype, cf):
    """The MoE layer (D 256, 16 experts, top-4, hidden 128, a shared
    expert) on the card at 1 x 512 and 1 x 4 tokens against
    ``moe_per_expert``, the loop over the experts: 1e-5 of the largest
    magnitude in float32, 1e-2 in bfloat16; at capacity factor 0.25 the
    512-token call drops pairs, and the loop counts as many as the
    layer's dispatch keeps out."""
    from repro_torch.models.layers import DTypePolicy
    from repro_torch.models.moe import (MoE, MoEConfig, capacity, dispatch,
                                        moe_per_expert, route)

    cfg = MoEConfig(dim=256, n_experts=16, top_k=4, d_ff=128,
                    capacity_factor=cf, shared_expert_ff=64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = MoE(cfg, DTypePolicy(dtype, dtype, torch.float32),
                generator=gen, device="cuda")
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for t in (512, 4):
        x = torch.randn((1, t, 256), generator=gen, device="cuda").to(dtype)
        with torch.no_grad():
            y, aux = layer(x)
            plain, dropped, pairs = moe_per_expert(layer, x)
            _, experts, _ = route(x[0], layer.router, cfg)
            _, kept = dispatch(experts, capacity(cfg, t), 16)
        assert y.dtype == dtype and torch.isfinite(aux)
        assert _err_ok(y, plain, tol)
        assert (dropped, pairs) == (int((~kept).sum()), t * 4)
        if t == 512:
            assert (dropped > 0) == (cf < 1)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "grok-1-314b"])
def test_moe_lm_on_card_matches_cpu(card, arch):
    """The reduced kimi (a dense attn layer, then attn_moe with a shared
    expert) and grok under the f32 policy: apply_lm, lm_prefill, a chain
    of chunks and 3 decode steps on the card against the same weights on
    the CPU (logits 1e-4), with no scan launched; the loss and its aux
    within 1e-5 relative."""
    from repro_torch.configs.base import get_arch

    cfg = with_precision(get_arch(arch).reduced(), "f32")
    cpu = lm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = lm.LM(cfg, device="meta")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                        assign=True)
    toks = torch.randint(0, cfg.vocab, (2, 21),
                         generator=torch.Generator().manual_seed(4))
    outs = {}
    cuda_lib.clear_counts()
    for name, model, t in (("cpu", cpu, toks), ("cuda", gpu, toks.cuda())):
        with torch.no_grad():
            full = lm.apply_lm(model, t)
            logits, caches = lm.lm_prefill(model, t[:, :18], 32)
            c, parts = lm.init_lm_cache(cfg, 2, 32, device=t.device), []
            for lo in (0, 6, 12):
                part, c = lm.lm_prefill_chunk(model, t[:, lo:lo + 6], c, lo)
                parts.append(part)
            steps = []
            for i in range(18, 21):
                lg, caches = lm.lm_decode_step(model, t[:, i:i + 1], caches)
                steps.append(lg)
            loss, parts_ = lm.lm_loss(model, {"tokens": t[:, :-1],
                                              "labels": t[:, 1:]})
        outs[name] = (full, logits, torch.cat(parts, 1), torch.cat(steps, 1),
                      torch.stack([loss, parts_["aux"]]))
    assert not cuda_lib.launch_counts and not cuda_lib.plain_calls
    for got, want in zip(outs["cuda"][:4], outs["cpu"][:4]):
        assert _err_ok(got.cpu(), want, 1e-4)
    torch.testing.assert_close(outs["cuda"][4].cpu(), outs["cpu"][4],
                               rtol=1e-5, atol=0)
    assert outs["cpu"][4][1] > 0


def test_mrope_on_card(card):
    """M-RoPE at qwen2-vl's head shape (sections 16/24/24) on the card:
    three distinct planes within 1e-5 of the largest magnitude of an f64
    evaluation of the f32 angles (position times frequency rounded as the
    reference and rope round it); three equal planes bit for bit
    rope's."""
    from repro_torch.models.layers import apply_mrope, apply_rope, rope_freqs

    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((2, 64, 8, 128), generator=gen, device="cuda")
    pos = torch.randint(0, 4096, (3, 2, 64), generator=gen, device="cuda")
    got = apply_mrope(x, pos, (16, 24, 24), 1e6)
    freqs = rope_freqs(128, 1e6, device="cuda")
    plane = torch.repeat_interleave(torch.arange(3, device="cuda"),
                                    torch.tensor([16, 24, 24], device="cuda"))
    ang = (pos.permute(1, 2, 0)[..., plane].float() * freqs).double()
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.double().chunk(2, dim=-1)
    exact = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    assert _err_ok(got, exact, 1e-5)
    same = pos[:1].expand(3, -1, -1)
    assert torch.equal(apply_mrope(x, same, (16, 24, 24), 1e6),
                       apply_rope(x, pos[0], 1e6))


@pytest.mark.parametrize("sq", [1500, 1])
def test_non_causal_chunked_attention_matches_dense_on_card(card, sq):
    """Whisper's 1500 keys in blocks of 4 (512 halved until it divides
    1500), non-causal, forward and gradients against the dense
    non-causal path: 1e-5 of the largest magnitude."""
    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn((2, sq, 8, 64), generator=gen, device="cuda")
    k, v = (torch.randn((2, 1500, 8, 64), generator=gen, device="cuda")
            for _ in range(2))
    ct = torch.randn((2, sq, 8, 64), generator=gen, device="cuda")
    outs = []
    for fn in (lambda *a: attention.chunked_attention(*a, causal=False,
                                                      block_k=512),
               lambda *a: attention.full_attention(*a, causal=False)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        outs.append((out, *torch.autograd.grad(out, ins, ct)))
    for got, want in zip(*outs):
        assert _err_ok(got, want, 1e-5)


def test_xattn_decode_on_card_matches_the_forward(card):
    """The reduced whisper under the f32 policy on the card: lm_encode,
    lm_prefill(enc_kv=) and 3 decode steps against apply_lm(enc_frames=)
    over the extended tokens (logits 1e-4), and against the same weights
    on the CPU; no scan launched."""
    from repro_torch.configs.base import get_arch

    cfg = with_precision(get_arch("whisper-base").reduced(), "f32")
    cpu = lm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    gpu = lm.LM(cfg, device="meta")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                        assign=True)
    gen = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    frames = torch.randn((2, cfg.enc_len, cfg.d_model), generator=gen)
    outs = {}
    cuda_lib.clear_counts()
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        t, f = toks.to(dev), frames.to(dev)
        with torch.no_grad():
            full = lm.apply_lm(model, t, enc_frames=f)
            kv = lm.lm_encode(model, f)
            logits, caches = lm.lm_prefill(model, t[:, :9], 16, enc_kv=kv)
            steps = []
            for i in range(9, 12):
                lg, caches = lm.lm_decode_step(model, t[:, i:i + 1], caches,
                                               enc_kv=kv)
                steps.append(lg)
        outs[name] = (full, logits, torch.cat(steps, 1))
        assert _err_ok(logits, full[:, :9], 1e-4)
        assert _err_ok(outs[name][2], full[:, 9:], 1e-4)
    assert not cuda_lib.launch_counts and not cuda_lib.plain_calls
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _err_ok(got.cpu(), want, 1e-4)
