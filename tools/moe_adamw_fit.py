#!/usr/bin/env python3
"""Does a whole ``build_train_step`` step with AdamW fit one CUDA card at
``grok-1-314b``'s full width, cut to one attn_moe layer under ``bf16``?

    python3 tools/moe_adamw_fit.py [--seq 4096] [--state-dtype bf16]

It builds the cut (6 530 598 912 parameters, 13.1 GB) from a seeded
generator, initialises AdamW's moments in ``--state-dtype``, and runs one
step at 1 x ``--seq`` tokens under ``remat="unit"``.  It prints the
card's name and power limit, the memory held after the state's
initialisation, and either the step's ms and peak memory or, when the
card runs out of memory, the peak reached before it did.  Besides the
parameters, their gradients and both moments, AdamW holds one leaf's
clipped gradient and temporaries at a time.  ``--smoke`` runs the
reduced config on the CPU, to check the script.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import (get_arch, resolve_dtype,  # noqa: E402
                                      with_precision)
from repro_torch.data.pipeline import (DataConfig, host_batch,  # noqa: E402
                                       to_device)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import (build_train_step,  # noqa: E402
                                   init_train_state)

GiB = 2**30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--state-dtype", default="bf16")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    entry = get_arch("grok-1-314b")
    if args.smoke:
        device, cfg, seq = "cpu", entry.reduced(), 16
    else:
        if not torch.cuda.is_available():
            print("FAIL: no CUDA device is available", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        device, cfg, seq = "cuda", entry.full(), args.seq
    cfg = with_precision(dataclasses.replace(
        cfg, unit=(("attn_moe", 1),), n_layers=1, remat="unit"), "bf16")
    model = lm.LM(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(4))
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100,
                       state_dtype=resolve_dtype(args.state_dtype))
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    batch = to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                            global_batch=1), 0), device)
    on_card = device == "cuda"
    held = torch.cuda.memory_allocated() / GiB if on_card else 0.0
    print(f"{cfg.name} 1 x {seq}: {lm.count_params(model)} parameters, "
          f"moments in {args.state_dtype}; held after the state's "
          f"initialisation {held:.3f} GiB", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state, metrics = step(state, batch)
        if on_card:
            torch.cuda.synchronize()
    except torch.OutOfMemoryError as exc:
        peak = torch.cuda.max_memory_allocated() / GiB
        print(f"out of memory: peak {peak:.3f} GiB before it; "
              f"{str(exc).splitlines()[0]}", flush=True)
        return 0
    peak = torch.cuda.max_memory_allocated() / GiB if on_card else 0.0
    print(f"the step fits: {(time.perf_counter() - t0) * 1e3:.3f} ms, peak "
          f"{peak:.3f} GiB, loss {float(metrics['loss']):.6g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
