#!/usr/bin/env python3
"""The f32 rounding noise of ``zamba2-2.7b`` and ``xlstm-1.3b`` at full
width and depth with seeded weights, on one CUDA card (TF32 off).

    python3 tools/ssm_f32_noise.py [--smoke]

For each model, as ``chip_smoke.py``'s ``lm ssm`` phase (b) builds it
(the f32 policy, weights from seed 1, 2064 tokens from seed 2), it
prints, each as the largest difference over the largest logit: a prefill
of 2048 tokens and 16 decode steps against ``apply_lm`` over the 2064;
and three changes that leave the function as it is and move only its
f32 rounding: ``apply_lm`` over two copies of the tokens against one
(other matrix-product shapes), over the first 2048 tokens against the
2064 (other chunk lengths), and over the embeddings times (1 + 1e-7
noise).  ``--smoke`` runs the reduced configs on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_arch, with_precision  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.smoke else "cuda"
    n_pre, n = (24, 27) if args.smoke else (2048, 2064)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for arch in ("zamba2-2.7b", "xlstm-1.3b"):
        entry = get_arch(arch)
        cfg = with_precision(entry.reduced() if args.smoke else entry.full(),
                             "f32")
        gen = torch.Generator(device=device)
        model = lm.LM(cfg, device=device, generator=gen.manual_seed(1))
        toks = torch.randint(0, cfg.vocab, (1, n), device=device,
                             generator=gen.manual_seed(2))
        with torch.no_grad():
            full = lm.apply_lm(model, toks)
            logits, caches = lm.lm_prefill(model, toks[:, :n_pre], n)
            steps = []
            for i in range(n_pre, n):
                s, caches = lm.lm_decode_step(model, toks[:, i:i + 1], caches)
                steps.append(s)
            del caches
            print(f"{arch}: prefill vs apply_lm "
                  f"{rel(logits, full[:, :n_pre]):.3e}; decode vs apply_lm "
                  f"{rel(torch.cat(steps, 1), full[:, n_pre:]):.3e}",
                  flush=True)
            two = lm.apply_lm(model, toks.expand(2, n))[:1]
            short = lm.apply_lm(model, toks[:, :n_pre])
            x = model.embed_tokens(toks)
            x = x * (1 + 1e-7 * torch.randn(x.shape, device=device,
                                            generator=gen.manual_seed(5)))
            for _, _, block in model.walk():
                x = block(x)
            print(f"{arch}: apply_lm over 2 copies vs 1 {rel(two, full):.3e};"
                  f" over {n_pre} vs {n} tokens "
                  f"{rel(short, full[:, :n_pre]):.3e}; embeddings x (1 + "
                  f"1e-7 noise) {rel(model.logits(x), full):.3e}", flush=True)
        del model, full, logits, steps, two, short, x
        if device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
