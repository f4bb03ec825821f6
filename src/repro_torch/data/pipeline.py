"""Deterministic synthetic image batches, numpy only.

Every batch derives purely from ``(seed, step)``, so a run regenerates the
same images for any step; the numbers equal the reference package's bit
for bit.  This port runs one process, so a host's batch is the global one.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # Stable across restarts: the seed folds in the step only.
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def synth_images(cfg: DataConfig, step: int, img_size: int,
                 n_classes: int) -> dict:
    """Synthetic image classification batch, NHWC float32 images and int32
    labels: class-conditional blobs so a model can actually learn."""
    rng = _batch_rng(cfg, step)
    b = cfg.global_batch
    labels = rng.integers(0, n_classes, b).astype(np.int32)
    xs = rng.standard_normal((b, img_size, img_size, 3)).astype(np.float32)
    # inject a class-dependent low-frequency pattern
    yy, xx = np.meshgrid(np.linspace(0, 1, img_size),
                         np.linspace(0, 1, img_size), indexing="ij")
    for i, c in enumerate(labels):
        freq = 1 + (c % 5)
        phase = (c // 5) * 0.7
        xs[i, :, :, c % 3] += 2.0 * np.sin(
            freq * 2 * np.pi * (yy + xx) + phase)
    return {"images": xs, "labels": labels}
