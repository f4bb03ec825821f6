"""Training launcher: train an LM architecture of the registry on the
synthetic token stream with the fault-tolerant trainer, on the card
unless ``--device`` names another device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b-gspn \\
        --steps 20 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b-gspn \\
        --reduced --device cpu --steps 4 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 20 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
        --reduced --device cpu --steps 2 --batch 2 --seq 32

``--reduced`` trains the architecture's small config; ``--precision``
rewrites the dtype policy (DESIGN.md §10), and a low-precision parameter
dtype turns on the f32 master copy and dynamic loss scaling, as in the
reference.  ``--ckpt-dir`` holds the checkpoints (the run resumes from
the latest there), ``--ckpt-every`` sets their interval and
``--grad-accum`` the microbatches per step, ``--grad-compression
int8_ef`` quantises the reduced gradients with error feedback, and
``--tune-cache`` layers a tuning cache over the seed cache (DESIGN.md
§11).

``--distributed`` is the per-rank entry point of parallel training:
started as ``torchrun`` starts ranks (``RANK``, ``WORLD_SIZE``,
``MASTER_PORT``), each rank joins the process group
(``launch.mesh.init_distributed``: NCCL when every rank has a card, gloo
when they share one or run on the CPU), builds the mesh over the world,
reads its slice of each global batch and trains with the elastic
trainer::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --distributed --arch qwen2-1.5b-gspn --steps 3 --batch 2 --seq 4096

As the reference's, its mesh is ``make_mesh_for_devices(world,
model_parallel=min(16, world))``, every rank it can on the model axis
(2 ranks: ``(data 1, model 2)``, every layer tensor-parallel), and the
config is ``full(n_model_shards=tp)`` (the MoE's slabs laid out for that
axis); the parameters, gradients and moments are split over the model
axis and sharded over the data axis where it has more than one rank
(``train.step``), and the elastic trainer re-meshes at the same model
extent.  Every architecture trains so, ``zamba2-2.7b``, ``xlstm-1.3b``,
``whisper-base`` (its encoder frames in every batch) and ``qwen2-vl-72b``
(its vision embeddings in half of each sequence's positions) among
them::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --distributed --arch zamba2-2.7b --steps 3 --batch 2 --seq 4096
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --distributed --arch whisper-base --steps 3 --batch 4 --seq 448

``--production-mesh`` (with ``--multi-pod``) builds the reference's
16 x 16 (2 x 16 x 16) mesh, which needs 256 (512) ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import pathlib

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_arch, with_precision
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib
from repro_torch.launch import args as largs
from repro_torch.launch import mesh as lmesh
from repro_torch.models.lm import count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import GRAD_COMPRESSION, LossScaleConfig
from repro_torch.train.trainer import ElasticTrainer, Trainer, TrainerConfig

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
    ap.add_argument("--grad-compression", default="none",
                    choices=list(GRAD_COMPRESSION))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun describes in the "
                         "environment and train data-parallel over it")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 / 2x16x16 production mesh "
                         "(requires 256/512 ranks)")
    largs.add_precision_args(ap)
    largs.add_tuning_args(ap)
    largs.add_device_arg(ap)
    largs.add_observability_args(ap)
    args = ap.parse_args(argv)
    if (args.production_mesh or args.multi_pod) and not args.distributed:
        ap.error("--production-mesh and --multi-pod build a mesh over the "
                 "ranks of --distributed")
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_PORT")
               if v not in os.environ]
    if args.distributed and missing:
        ap.error(f"--distributed needs {', '.join(missing)} in the "
                 f"environment, as torchrun sets them")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    largs.setup_observability(args)
    largs.load_tune_cache(args, "train")
    entry = get_arch(args.arch)
    device = resolve_device(args.device)
    rank, mesh, mesh_kw, tp = 0, None, {}, 1
    if args.distributed:
        device = lmesh.init_distributed(device)
        rank, world = dist.get_rank(), dist.get_world_size()
        if args.production_mesh:
            mesh = lmesh.make_production_mesh(multi_pod=args.multi_pod,
                                              device_type=device.type)
        else:
            mesh = lmesh.make_mesh_for_devices(
                range(world), model_parallel=min(16, world),
                device_type=device.type)
        mesh_kw = dict(mesh=mesh, dp_axes=lmesh.dp_axes_for(mesh))
        tp = lmesh.seq_axis_size(mesh, "model")
    cfg = entry.reduced() if args.reduced else entry.full()
    cfg = dataclasses.replace(cfg, n_model_shards=tp)
    mp_kwargs = {}
    if args.precision:
        cfg = with_precision(cfg, args.precision)
        if cfg.param_dtype != torch.float32:
            # low-precision params need the f32 master + loss-scale loop
            mp_kwargs = dict(master_weights=True,
                             loss_scaling=LossScaleConfig())

    data_cfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        vision_len=args.seq // 2 if cfg.family == "vlm" else 0,
        enc_len=cfg.enc_len if cfg.family == "audio" else 0,
        d_model=cfg.d_model)
    trainer = (ElasticTrainer if args.distributed else Trainer)(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps),
        data_cfg,
        TrainerConfig(ckpt_dir=args.ckpt_dir or str(BUILD / "ckpt" /
                                                     args.arch),
                      ckpt_every=args.ckpt_every),
        device=device, grad_accum=args.grad_accum,
        grad_compression=args.grad_compression, **mesh_kw, **mp_kwargs)
    tag = f"[train {rank}]" if args.distributed else "[train]"
    try:
        start = trainer.init_or_restore()
        if rank == 0:
            layout = "" if mesh is None else ", mesh " + str(dict(zip(
                mesh.mesh_dim_names, list(mesh.mesh.shape))))
            print(f"{tag} {cfg.name} on {trainer.device}{layout}: "
                  f"{count_params(trainer.model)} parameters a rank, from "
                  f"step {start}", flush=True)
        cuda_lib.clear_counts()
        hist = trainer.run(args.steps)
        largs.finish_observability(args, "train")
        if rank == 0:
            print(f"{tag} {args.arch}: loss {hist[0]:.4f} -> "
                  f"{hist[-1]:.4f}, recoveries={trainer.recoveries}, "
                  f"step {trainer.step}, losses {hist}", flush=True)
        print(f"{tag} scan launches {dict(cuda_lib.launch_counts)}, plain "
              f"scan calls {dict(cuda_lib.plain_calls)}", flush=True)
    finally:
        if args.distributed:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
