"""Train a (reduced) GSPN-2 vision classifier with the PyTorch port on
synthetic class-conditional images; held-out accuracy climbs well above
chance.  The twin of ``examples/train_vision.py``: the same model, data,
schedule and check, through ``repro_torch`` (no JAX).

    PYTHONPATH=src python examples/train_vision_torch.py               # on the card
    PYTHONPATH=src python examples/train_vision_torch.py --device cpu  # plain path

On the card the scans run the hand-written CUDA kernels, forward and
backward; ``--device cpu`` runs their plain versions.
"""

import argparse

import torch

from repro_torch.configs.gspn2_vision import reduced_vision
from repro_torch.data.pipeline import DataConfig, synth_images, to_device
from repro_torch.models.vision import GSPNVision, apply_vision, vision_loss
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when not given")
    return ap.parse_args(argv)


def make_step(model: GSPNVision, ocfg: AdamWConfig):
    """The training step: the loss of one batch, its gradients and one
    AdamW update of ``model``'s parameters in place.  Returns
    ``step(batch) -> loss`` and the optimizer state it updates."""
    params = dict(model.named_parameters())
    opt = adamw_init(ocfg, params)

    def step(batch: dict) -> torch.Tensor:
        loss, _ = vision_loss(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        adamw_update(ocfg, dict(zip(params, grads)), opt, params)
        return loss.detach()

    return step, opt


def accuracy(model: GSPNVision, batch: dict) -> float:
    logits = apply_vision(model, batch["images"])
    return (logits.argmax(-1) == batch["labels"]).float().mean().item()


def run(args) -> float:
    """Train for ``args.steps`` steps, printing the loss and the held-out
    accuracy every 10 steps and at the last; returns the last accuracy."""
    cfg = reduced_vision()
    model = GSPNVision(cfg, device=args.device,
                       generator=torch.Generator().manual_seed(0))
    device = next(model.parameters()).device
    n_params = sum(p.numel() for p in model.parameters())
    print(f"GSPN-2 classifier ({cfg.name}): {n_params / 1e3:.0f}K params, "
          f"C_proxy={cfg.proxy_dim}, img {cfg.img_size}², on {device}")

    ocfg = AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps,
                       weight_decay=0.01)
    step, _ = make_step(model, ocfg)
    dcfg = DataConfig(vocab=1, seq_len=1, global_batch=args.batch)
    acc = 0.0
    for s in range(args.steps):
        batch = to_device(synth_images(dcfg, s, cfg.img_size, cfg.n_classes),
                          device)
        loss = step(batch)
        if s % 10 == 0 or s == args.steps - 1:
            test = to_device(synth_images(dcfg, 10_000 + s, cfg.img_size,
                                          cfg.n_classes), device)
            acc = accuracy(model, test)
            print(f"step {s:4d}  loss {loss.item():.3f}  held-out acc "
                  f"{acc:.2f} (chance {1 / cfg.n_classes:.2f})", flush=True)
    return acc


def main(argv=None) -> float:
    acc = run(parse_args(argv))
    n_classes = reduced_vision().n_classes
    if not acc > 2.0 / n_classes:
        raise AssertionError(f"no learning: held-out accuracy {acc:.2f} "
                             f"is not above {2.0 / n_classes:.2f}")
    print("vision training OK")
    return acc


if __name__ == "__main__":
    main()
