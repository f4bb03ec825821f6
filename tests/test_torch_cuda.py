"""The port's CUDA kernels and its kernel path on a card, held against the
plain PyTorch versions.

This file imports neither JAX nor the reference package, so it runs on a
GPU host that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a card.  Tolerances: 1e-5 of the largest
magnitude in float32 and 1e-2 in bfloat16 (DESIGN.md §10); the adjoint
kernels 1e-5 in both, since they compute in f32 and write f32 from the
same inputs as their plain versions; the model's logits and gradients
1e-4 of the largest magnitude with TF32 off.
"""

import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs.gspn2_vision import reduced_vision
from repro_torch.core.gspn import DIRECTIONS, directional_scan
from repro_torch.kernels import cuda_lib, gspn_multidir, gspn_scan, ops
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
            s = gspn_multidir.pair_launch_shape(g, 64, w, cpw, dtype, kind)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", [((8, 19, 37), 4, None),
                                             ((8, 18, 37), 4, 6),
                                             ((128, 56, 56), 2, None),
                                             ((6, 9, 1024), 3, 3)])
def test_pair_adjoint_agrees_with_single_adjoint_bitwise(card, dtype, shape,
                                                         cpw, chunk):
    """Direction 0 of the pair adjoint walks H-1..0 as the single adjoint
    (#2) does: on the same operands both give the same bits."""
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
