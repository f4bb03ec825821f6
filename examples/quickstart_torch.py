"""Quickstart: the GSPN-2 propagation layer of the PyTorch port.

    PYTHONPATH=src python examples/quickstart_torch.py                # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain

Shows (1) the four-directional line scan (two fused pair launches of the
hand kernel on the card), (2) that each direction equals the dense
Eq.-4 affinity-matrix form (``kernels.ref.gspn_dense_oracle``), (3) the
GSPN-2 attention module with compact channel propagation, and (4)
gradients through the scan's hand-derived adjoint.  The twin of
``examples/quickstart.py``; it imports no JAX.
"""

import argparse

import torch

from repro_torch.core import gspn as G
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import ref as R

DIRECTIONS = ("tb", "bt", "lr", "rl")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when not given")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, h, w = 2, 4, 16, 16

    # --- 1. the four-directional scan -------------------------------------
    x = torch.randn((b * c, h, w), generator=gen, device=dev)
    lam = torch.sigmoid(torch.randn((4, b * c, h, w), generator=gen,
                                    device=dev))
    # Channel-shared taps (GSPN-2 compact mode): one tap set per image and
    # direction, row-stochastic in that direction's scan geometry.
    taps = [G._normalize_taps_oriented(
        torch.randn((b, h, w, 3), generator=gen, device=dev), d, "softmax")
        for d in DIRECTIONS]
    wl, wc, wr = (torch.stack([t[i] for t in taps]) for i in range(3))
    cuda_lib.clear_counts()
    hidden = G.directional_scan(x, wl, wc, wr, lam, DIRECTIONS)
    print(f"four-direction scan: x{tuple(x.shape)} -> "
          f"h{tuple(hidden.shape)}; launches {dict(cuda_lib.launch_counts)}"
          f", plain calls {dict(cuda_lib.plain_calls)}")
    print(f"  row-stochastic taps: wl+wc+wr = "
          f"{float((wl + wc + wr).mean()):.6f} (exactly 1)")

    # --- 2. each direction equals the dense Eq.-4 form --------------------
    worst = 0.0
    for i, d in enumerate(DIRECTIONS):
        canon = [G._to_canonical(a, d) for a in (x, wl[i], wc[i], wr[i],
                                                 lam[i])]
        dense = G._from_canonical(R.gspn_dense_oracle(*canon), d)
        worst = max(worst, float((hidden[i] - dense).abs().max()))
    print(f"  max |scan - dense Eq.4| over the 4 directions = {worst:.2e}")
    assert worst < 1e-5, worst

    # --- 3. the GSPN-2 attention module -----------------------------------
    cfg = G.GSPNAttentionConfig(dim=32, proxy_dim=8)
    attn = G.GSPNAttention(cfg, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    img = torch.randn((b, h, w, 32), generator=gen, device=dev)
    y = attn(img)
    print(f"GSPN-2 attention: {tuple(img.shape)} -> {tuple(y.shape)} "
          f"(proxy C {cfg.dim}->{cfg.proxy_dim}, "
          f"directions={list(cfg.directions)})")

    # --- 4. gradients through the scan's adjoint --------------------------
    loss = (attn(img) ** 2).sum()
    loss.backward()
    gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                           for p in attn.parameters()))
    print(f"grad norm through the scan's adjoint: {float(gnorm):.3f}")
    assert torch.isfinite(gnorm)
    print("quickstart OK")


if __name__ == "__main__":
    main()
