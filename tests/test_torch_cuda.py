"""The port's CUDA kernels and its kernel path on a card, held against the
plain PyTorch versions.

This file imports neither JAX nor the reference package, so it runs on a
GPU host that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a card.  Tolerances: 1e-5 of the largest
magnitude in float32 and 1e-2 in bfloat16 (DESIGN.md §10); the model's
logits 1e-4 of the largest logit with TF32 off.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs.gspn2_vision import reduced_vision
from repro_torch.kernels import cuda_lib, gspn_multidir, gspn_scan, ops
from repro_torch.models.vision import GSPNVision, apply_vision

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels are built with nvcc "
                    "for sm_90a")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, g, h, w, cpw, dtype, pair=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = (2,) if pair else ()
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cpw,chunk", [((8, 19, 37), 1, None),
                                             ((8, 19, 37), 4, 19),
                                             ((8, 18, 37), 4, 6),
                                             ((4, 5, 1), 2, None),
                                             ((128, 56, 56), 2, None),
                                             ((2, 3, 1024), 1, None)])
def test_kernels_match_plain(card, dtype, shape, cpw, chunk):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    a = _inputs(1, *shape, cpw, dtype)
    p = _inputs(2, *shape, cpw, dtype, pair=True)
    assert _err_ok(gspn_scan.gspn_scan_fwd(*a, chunk=chunk),
                   gspn_scan.gspn_scan_fwd_torch(*a, chunk=chunk), tol)
    assert _err_ok(gspn_multidir.gspn_scan_bidir(*p, chunk=chunk),
                   gspn_multidir.gspn_scan_bidir_torch(*p, chunk=chunk), tol)


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


def test_kernels_refuse_grad(card):
    a = list(_inputs(4, 4, 6, 5, 2, torch.float32))
    a[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        gspn_scan.gspn_scan_fwd(*a)
    with torch.no_grad():
        gspn_scan.gspn_scan_fwd(*a)


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
