"""Training launcher: train an LM architecture of the registry on the
synthetic token stream with the fault-tolerant trainer, on the card
unless ``--device`` names another device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b-gspn \\
        --steps 20 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b-gspn \\
        --reduced --device cpu --steps 4 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 20 --batch 2 --seq 4096

``--reduced`` trains the architecture's small config; ``--precision``
rewrites the dtype policy (DESIGN.md §10), and a low-precision parameter
dtype turns on the f32 master copy and dynamic loss scaling, as in the
reference.  ``--ckpt-dir`` holds the checkpoints (the run resumes from
the latest there), ``--ckpt-every`` sets their interval and
``--grad-accum`` the microbatches per step.  The reference launcher's
multi-pod, production-mesh, distributed, gradient-compression and tuning
flags are not ported yet (ROADMAP.md §1 items 2 and 6) and do not parse.
"""

from __future__ import annotations

import argparse
import logging
import pathlib

import torch

from repro_torch.configs.base import get_arch, with_precision
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import cuda_lib
from repro_torch.launch import args as largs
from repro_torch.models.lm import count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import LossScaleConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# Checkpoints go under the checkout's build directory unless --ckpt-dir
# names another.
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build"


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: build/ckpt/<arch> "
                         "in the checkout)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    largs.add_precision_args(ap)
    largs.add_device_arg(ap)
    largs.add_observability_args(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    largs.setup_observability(args)
    entry = get_arch(args.arch)
    cfg = entry.reduced() if args.reduced else entry.full()
    mp_kwargs = {}
    if args.precision:
        cfg = with_precision(cfg, args.precision)
        if cfg.param_dtype != torch.float32:
            # low-precision params need the f32 master + loss-scale loop
            mp_kwargs = dict(master_weights=True,
                             loss_scaling=LossScaleConfig())

    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch),
        TrainerConfig(ckpt_dir=args.ckpt_dir or str(BUILD / "ckpt" /
                                                     args.arch),
                      ckpt_every=args.ckpt_every),
        device=args.device, grad_accum=args.grad_accum, **mp_kwargs)
    start = trainer.init_or_restore()
    print(f"[train] {cfg.name} on {trainer.device}: "
          f"{count_params(trainer.model)} parameters, from step {start}")
    cuda_lib.clear_counts()
    hist = trainer.run(args.steps)
    largs.finish_observability(args, "train")
    print(f"[train] {args.arch}: loss {hist[0]:.4f} -> {hist[-1]:.4f}, "
          f"recoveries={trainer.recoveries}")
    print(f"[train] scan launches {dict(cuda_lib.launch_counts)}, plain "
          f"scan calls {dict(cuda_lib.plain_calls)}")
    return trainer


if __name__ == "__main__":
    main()
