#!/usr/bin/env python3
"""Time ``xlstm-1.3b``'s (or ``zamba2-2.7b``'s) train step at full width
over sequence lengths, on one CUDA card.

    python3 tools/ssm_train_lengths.py [--arch xlstm-1.3b] \\
        [--seqs 1024 2048 4096]

For each length, at batch 2, under the config's own policy and
``remat="unit"`` with AdamW, it prints the host-clock seconds and the
card's peak memory of: one mLSTM (or mamba) block's and, for xlstm, one
sLSTM block's forward and backward alone; ``lm_loss`` without gradients;
``lm_loss`` and all gradients; and ``build_train_step``'s step, each
twice (the first call warms up).  It picks the longest length whose step
keeps ``chip_smoke.py``'s ``lm ssm`` phase in its budget; the sLSTM's
token loop sets that length.  ``--smoke`` runs the reduced config on the
CPU at 16 and 32 tokens, to check the script.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, host_batch,  # noqa: E402
                                       to_device)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import (build_train_step,  # noqa: E402
                                   init_train_state)

GiB = 2**30


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--seqs", type=int, nargs="+", default=[1024, 2048, 4096])
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.smoke else "cuda"
    entry = get_arch(args.arch)
    cfg = entry.reduced() if args.smoke else entry.full()
    seqs = [16, 32] if args.smoke else args.seqs
    cuda = device == "cuda"
    model = lm.LM(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(4))
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    if cuda:
        print(torch.cuda.get_device_name(0), flush=True)

    def timed(what, fn):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        peak = (f", peak {torch.cuda.max_memory_allocated() / GiB:.2f} GiB"
                if cuda else "")
        print(f"{what}: {time.perf_counter() - t0:.3f} s{peak}", flush=True)
        return out

    for seq in seqs:
        b = to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                            global_batch=2), 0), device)
        x = torch.randn((2, seq, cfg.d_model), device=device,
                        dtype=cfg.compute_dtype, requires_grad=True)
        for key in model.stages:
            blk = model.stages[key][0][0]
            for i in range(2):
                timed(f"seq {seq} {key} block forward and backward #{i}",
                      lambda: blk(x).float().sum().backward())
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            timed(f"seq {seq} lm_loss without gradients",
                  lambda: lm.lm_loss(model, b))
        for i in range(2):
            timed(f"seq {seq} lm_loss and gradients #{i}",
                  lambda: torch.autograd.grad(lm.lm_loss(model, b)[0],
                                              list(model.parameters())))
        for i in range(2):
            state, _ = timed(f"seq {seq} train step #{i}",
                             lambda: step(state, b))


if __name__ == "__main__":
    main()
