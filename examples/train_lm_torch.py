"""End-to-end LM training on the PyTorch port: config -> train
step -> fault-tolerant trainer with checkpointing -> loss curve.  The twin
of ``examples/train_lm.py``, through ``repro_torch`` (no JAX).

    PYTHONPATH=src python examples/train_lm_torch.py --preset small --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --preset small \\
        --steps 4 --batch 2 --seq 64 --device cpu

``--mixer gspn`` (the default here) runs the paper's GSPN-2 sequence
mixer; on the card its scans run the hand-written CUDA kernels, forward
and adjoint, and ``--device cpu`` runs their plain versions.
``--mixer attn``, the reference's default, runs GQA attention with rope
(plain PyTorch products, the blockwise softmax past 512 tokens).  The
run resumes from the latest checkpoint in ``--ckpt-dir``.
"""

import argparse
import logging
import pathlib

from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import cuda_lib
from repro_torch.models.lm import LMConfig, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    # ~7M params: fast on CPU
    "small": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                  d_ff=1024, vocab=8192),
    # ~100M params: a few hundred steps in minutes on the card
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=3072, vocab=32768),
}
BUILD = pathlib.Path(__file__).resolve().parents[1] / "build"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mixer", default="gspn", choices=["attn", "gspn"])
    ap.add_argument("--ckpt-dir", default=str(BUILD / "lm_ckpt"))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when not given")
    return ap.parse_args(argv)


def run(args) -> Trainer:
    """Train for ``args.steps`` more steps; returns the trainer."""
    p = PRESETS[args.preset]
    cfg = LMConfig(
        name=f"{args.preset}-{args.mixer}", family="dense",
        unit=((args.mixer, p["n_layers"]),), n_units=1,
        gspn_proxy_dim=8, gspn_row_width=32, remat="none", **p)
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch),
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10),
        device=args.device, grad_accum=args.grad_accum)
    start = trainer.init_or_restore()
    print(f"model: {cfg.name}  params={count_params(trainer.model) / 1e6:.1f}M"
          f"  mixer={args.mixer}  device={trainer.device}  from step "
          f"{start}", flush=True)
    cuda_lib.clear_counts()
    hist = trainer.run(args.steps)
    print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps "
          f"({trainer.recoveries} recoveries, {trainer.stragglers} "
          f"straggler events)")
    print(f"scan launches {dict(cuda_lib.launch_counts)}, plain scan calls "
          f"{dict(cuda_lib.plain_calls)}", flush=True)
    return trainer


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
