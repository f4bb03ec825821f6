"""Deterministic synthetic data, numpy only: token batches for the LM and
image batches for the vision model.

Every batch derives purely from ``(seed, step)``, so a restarted job
regenerates the same stream for any step; the numbers equal the reference
package's bit for bit, the vision and audio stubs' embeddings included.
Each host (a rank of the data-parallel trainer) takes its positional
slice of the global batch, rows ``host_id * host_batch`` on, so a
re-sharded job reads the same global stream.  :class:`Prefetcher` builds
the next step's host batch and copies it to the device on a thread while
the current step runs.  Token
streams are Zipf-distributed with a Markov skeleton, so models have
learnable structure (losses fall in the examples' training runs); the
reference's uniform streams have no caller.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    vision_len: int = 0            # Qwen2-VL stub: vision positions
    d_model: int = 0               # width of the vision and audio stubs
    enc_len: int = 0               # whisper stub: encoder frames

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


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
    """This host's slice of the batch of ``step`` as numpy: ``tokens`` and
    ``labels`` (host_batch, seq_len), the labels shifted one token left;
    with ``vision_len``, ``vision_embeds`` (host_batch, vision_len,
    d_model) and with ``enc_len``, ``enc_frames`` (host_batch, enc_len,
    d_model), standard normal f32 drawn for the whole global batch in that
    order from a fresh generator of the step, as the reference draws
    them."""
    lo = cfg.host_id * cfg.host_batch
    hi = lo + cfg.host_batch
    toks = synth_tokens(cfg, step)[lo:hi]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rng = _batch_rng(cfg, step)
    for name, n in (("vision_embeds", cfg.vision_len),
                    ("enc_frames", cfg.enc_len)):
        if n:
            batch[name] = rng.standard_normal(
                (cfg.global_batch, n, cfg.d_model)).astype(np.float32)[lo:hi]
    return batch


class Prefetcher:
    """One-step lookahead: a thread builds each step's host batch from
    ``start_step`` on and copies it to ``device``, at most two ahead.
    ``next(p)`` returns (step, batch) in step order."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device=None):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = host_batch(cfg, step)
                if device is not None:
                    batch = to_device(batch, device)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the thread and wait for it."""
        self._stop.set()
        self._thread.join()


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
