"""Fault-tolerant training loop, the port of the reference's
``train/trainer.py`` on one device.

* **Checkpoint/restart**: asynchronous atomic checkpoints every
  ``ckpt_every`` steps and one of the last step, which is on disk when
  :meth:`run` returns; on any step failure the trainer restores the latest committed checkpoint
  (or, before the first, the seeded initial state) and replays from there,
  up to ``max_retries`` failures in a row.  The data pipeline regenerates
  the same stream for any step, so the replay is exactly-once: the loss
  history holds one loss per step and equals an uninterrupted run's.
* **Straggler detection**: the step's wall time is tracked with an EWMA;
  a step slower than ``straggler_factor`` times it is counted and logged.
* **Failure injection**: ``failure_injector(step)`` raising before a step
  exercises the recovery path in tests.

The reference's ``ElasticTrainer`` re-meshes on a changed device set and
comes with parallelism (ROADMAP.md §1 item 6).

Observability (DESIGN.md §13): spans ``train.data`` and ``train.step``;
events ``train.recovery``, ``train.straggler`` and ``train.loss_scale``
(on a scale change or a non-finite step); counters
``train_steps_total``, ``train_recoveries_total``,
``train_stragglers_total`` and ``train_nonfinite_steps_total``; the
histogram ``train_step_seconds``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, host_batch, to_device
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM, LMConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (LossScaleConfig, build_train_step,
                                    init_train_state)

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    straggler_warmup: int = 5
    max_retries: int = 3
    log_every: int = 10


class Trainer:
    """Trains an :class:`LM` of ``model_cfg`` on ``data_cfg``'s synthetic
    tokens with :func:`build_train_step`, on ``device`` (the card unless
    the caller asks for another).  Weights are drawn from a generator
    seeded with ``init_or_restore``'s ``seed``."""

    def __init__(self, model_cfg: LMConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, *, device=None,
                 grad_accum: int = 1, master_weights: bool = False,
                 loss_scaling: Optional[LossScaleConfig] = None,
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.grad_accum = grad_accum
        self.master_weights = master_weights
        self.loss_scaling = loss_scaling
        self.failure_injector = failure_injector
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.model: Optional[LM] = None
        self.state = None
        self.step = 0
        self.seed = 0
        self.ewma = None
        self.stragglers = 0
        self.recoveries = 0
        self.history: list = []
        self._first_step = 0
        self._last_scale = None

    # -- state management ---------------------------------------------------
    def _init(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = LM(self.model_cfg, device=self.device, generator=gen)
        self.state = init_train_state(self.model, self.opt_cfg,
                                      master_weights=self.master_weights,
                                      loss_scaling=self.loss_scaling)
        self._train_step = build_train_step(
            self.model, self.opt_cfg, grad_accum=self.grad_accum,
            master_weights=self.master_weights,
            loss_scaling=self.loss_scaling)
        self.step = 0

    def init_or_restore(self, seed: int = 0) -> int:
        """Build the model and state from ``seed``, then load the latest
        committed checkpoint if there is one.  Returns the step."""
        self.seed = seed
        self._init(seed)
        latest = self.ckpt.latest_step()
        if latest is not None:
            self._restore(latest)
        self._first_step = self.step
        return self.step

    def _restore(self, ckpt_step: int):
        self.ckpt.wait()
        self.state, self.step = self.ckpt.restore(step=ckpt_step,
                                                  target=self.state)
        log.warning("restored checkpoint at step %d", self.step)

    def _recover(self):
        """Back to the latest committed checkpoint, or to the seeded
        initial state before the first: the step may have updated the
        state in place before it failed.  Forget the losses of the steps
        that will be replayed."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            self._restore(latest)
        else:
            self._init(self.seed)
        del self.history[max(self.step - self._first_step, 0):]

    def _save(self):
        self.ckpt.save(self.step, self.state)

    def _note_loss_scale(self, metrics):
        """Emit a loss-scale trace event on every scale change or
        non-finite-gradient step (DESIGN.md §13).  No-op for runs without
        dynamic loss scaling (step metrics lack the keys)."""
        if "loss_scale" not in metrics:
            return
        scale = float(metrics["loss_scale"])
        finite = float(metrics.get("grads_finite", 1.0))
        if scale != self._last_scale or finite < 1.0:
            obs.event("train.loss_scale", step=self.step, scale=scale,
                      grads_finite=finite)
            if finite < 1.0:
                obs.counter("train_nonfinite_steps_total").inc()
        self._last_scale = scale

    # -- main loop ------------------------------------------------------------
    def run(self, n_steps: int) -> list:
        """Run ``n_steps`` more steps; returns the loss history."""
        if self.state is None:
            self.init_or_restore()
        end = self.step + n_steps
        retries = 0
        while self.step < end:
            with obs.trace("train.data", step=self.step):
                batch = to_device(host_batch(self.data_cfg, self.step),
                                  self.device)
            t0 = obs.monotonic()
            try:
                if self.failure_injector is not None:
                    self.failure_injector(self.step)
                with obs.trace("train.step", step=self.step):
                    self.state, metrics = self._train_step(self.state, batch)
                    # Reading the loss waits for the whole step.
                    loss = float(metrics["loss"])
            except Exception as exc:  # noqa: BLE001 — any step failure
                retries += 1
                self.recoveries += 1
                obs.counter("train_recoveries_total").inc()
                obs.event("train.recovery", step=self.step, retry=retries,
                          error=type(exc).__name__)
                log.warning("step %d failed (%s); recovering (retry %d)",
                            self.step, exc, retries)
                if retries > self.tcfg.max_retries:
                    raise
                self._recover()
                continue
            retries = 0
            dt = obs.monotonic() - t0
            obs.counter("train_steps_total").inc()
            obs.histogram("train_step_seconds").observe(dt)
            self._note_loss_scale(metrics)

            if self.step > self.tcfg.straggler_warmup:
                if self.ewma is not None and dt > \
                        self.tcfg.straggler_factor * self.ewma:
                    self.stragglers += 1
                    obs.counter("train_stragglers_total").inc()
                    obs.event("train.straggler", step=self.step,
                              dt_ms=round(dt * 1e3, 3),
                              ewma_ms=round(self.ewma * 1e3, 3))
                    log.warning("straggler step %d: %.3fs vs ewma %.3fs",
                                self.step, dt, self.ewma)
                self.ewma = dt if self.ewma is None else \
                    0.9 * self.ewma + 0.1 * dt

            self.step += 1
            self.history.append(loss)
            if self.step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", self.step, loss, dt)
            if self.step % self.tcfg.ckpt_every == 0:
                self._save()
        # The last step is on disk when run returns; a step the loop just
        # saved is not written a second time.
        if self.step % self.tcfg.ckpt_every:
            self._save()
        self.ckpt.wait()
        return self.history
