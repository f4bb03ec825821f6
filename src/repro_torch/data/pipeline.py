"""Deterministic synthetic data, numpy only: token batches for the LM and
image batches for the vision model.

Every batch derives purely from ``(seed, step)``, so a restarted job
regenerates the same stream for any step; the numbers equal the reference
package's bit for bit, the vision and audio stubs' embeddings included.
This port runs one process, so a host's batch is the global one (host
sharding comes with ROADMAP.md §1 item 6).  Token
streams are Zipf-distributed with a Markov skeleton, so models have
learnable structure (losses fall in the examples' training runs); the
reference's uniform streams have no caller.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    vision_len: int = 0            # Qwen2-VL stub: vision positions
    d_model: int = 0               # width of the vision and audio stubs
    enc_len: int = 0               # whisper stub: encoder frames


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # Stable across restarts: the seed folds in the step only.
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def synth_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """Global batch of tokens (global_batch, seq_len + 1), int32; callers
    slice inputs [:-1] and labels [1:]."""
    rng = _batch_rng(cfg, step)
    b, s, v = cfg.global_batch, cfg.seq_len + 1, cfg.vocab
    # Markov skeleton: next token = (prev * a + noise) mod small_band, then
    # mapped through a Zipf-ish permutation for a realistic marginal.
    band = min(v, 4096)
    a = 31
    x = np.empty((b, s), np.int64)
    x[:, 0] = rng.integers(0, band, b)
    noise = rng.integers(0, 7, (b, s))
    for t in range(1, s):
        x[:, t] = (x[:, t - 1] * a + noise[:, t]) % band
    # Zipf-ify: token id -> floor(band * u^1.5) spreads mass toward low ids.
    u = x.astype(np.float64) / band
    return (np.floor((u ** 1.5) * min(v, band * 8)) % v).astype(np.int32)


def host_batch(cfg: DataConfig, step: int) -> dict:
    """The batch of ``step`` as numpy: ``tokens`` and ``labels``
    (global_batch, seq_len), the labels shifted one token left; with
    ``vision_len``, ``vision_embeds`` (global_batch, vision_len, d_model)
    and with ``enc_len``, ``enc_frames`` (global_batch, enc_len, d_model),
    standard normal f32 drawn in that order from a fresh generator of the
    step, as the reference draws them."""
    toks = synth_tokens(cfg, step)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rng = _batch_rng(cfg, step)
    for name, n in (("vision_embeds", cfg.vision_len),
                    ("enc_frames", cfg.enc_len)):
        if n:
            batch[name] = rng.standard_normal(
                (cfg.global_batch, n, cfg.d_model)).astype(np.float32)
    return batch


def to_device(batch: dict, device) -> dict:
    """A numpy batch as torch tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


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
