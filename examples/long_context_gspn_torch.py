"""Beyond-paper showcase on the PyTorch port: GSPN-2 as an O(√L)-state
long-context decoder, the twin of ``examples/long_context_gspn.py``.

    PYTHONPATH=src python examples/long_context_gspn_torch.py --ctx 4096
    PYTHONPATH=src python examples/long_context_gspn_torch.py --ctx 256 \\
        --device cpu

The GSPN sequence mixer folds the token stream into a √L × √L grid; decode
keeps only the previous grid row and the within-row state (DESIGN.md §4).
This script prefills a prompt of ``--ctx`` tokens, then streams
``--stream`` tokens while printing the cache footprint (constant in the
context length for a fixed row width) beside the KV cache an attention
layer of the same heads would hold, and checks that the streamed logits
equal the full forward pass's.  On the card the scans run kernel #1.
"""

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import (LM, LMConfig, apply_lm, lm_decode_step,
                                   lm_prefill)


def cache_bytes(caches) -> int:
    return sum(a.numel() * a.element_size() for sub in caches.values()
               for a in sub.values())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--stream", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    row_w = 1 << max(2, (args.ctx.bit_length() // 2))
    cfg = LMConfig(name="gspn-long", family="dense", n_layers=2,
                   d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                   vocab=512, gspn_proxy_dim=4, gspn_row_width=row_w,
                   unit=(("gspn", 2),), n_units=1, remat="none")
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))

    total = args.ctx + args.stream
    toks = torch.randint(0, cfg.vocab, (1, total), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))
    with torch.no_grad():
        logits_full = apply_lm(model, toks)
        _, caches = lm_prefill(model, toks[:, :args.ctx], total)
        kv = args.ctx * cfg.n_layers * 2 * cfg.n_kv_heads * 16 * 2
        print(f"context {args.ctx} tokens folded into rows of {row_w}; "
              f"decode cache = {cache_bytes(caches) / 1e3:.1f} KB "
              f"(vs {kv / 1e3:.1f} KB for an equivalent KV cache)")
        outs = []
        for t in range(args.ctx, total):
            lg, caches = lm_decode_step(model, toks[:, t:t + 1], caches)
            outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               logits_full[:, args.ctx:].float().cpu().numpy(),
                               rtol=5e-2, atol=5e-2)
    print(f"streamed {args.stream} tokens at position {args.ctx}: "
          f"outputs match full forward ✓")
    return got


if __name__ == "__main__":
    main()
