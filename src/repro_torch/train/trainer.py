"""Fault-tolerant training loop, the port of the reference's
``train/trainer.py``: on one device, or over a mesh's ``data`` (and
``pod``) axis and its ``model`` axis, one process a rank.

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
  exercises the recovery path in tests.  On a mesh the ranks agree on it
  (one all-reduce of a flag), so every rank recovers together and none
  waits in a collective of the step.
* **Parallelism**: with ``mesh``, every rank draws the same full model
  from the seed, keeps its shards (``train.step.make_train_setup``) and
  reads its slice of each global batch (``DataConfig.n_hosts`` and
  ``host_id`` from its place on the data axes; the model axis's ranks
  read the same slice); each rank of the mesh is a checkpoint host and
  writes its own shards.
* **Elastic re-mesh**: :class:`ElasticTrainer` polls ``device_monitor()``
  (the live ranks); on a change it saves, builds the new mesh over the
  live ranks at the model extent it started with, rebuilds the step and
  restores under the new placements.  Ranks outside the new mesh leave
  the loop.

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
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, host_batch, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (dp_axes_for, make_mesh_for_devices)
from repro_torch.models.lm import LM, LMConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import LossScaleConfig, make_train_setup

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


def _place(mesh, axes) -> tuple:
    """(the number of ranks over ``axes`` of ``mesh``, this rank's index
    among them, row-major)."""
    names = mesh.mesh_dim_names
    n, idx = 1, 0
    for a in axes:
        i = names.index(a)
        n, idx = n * mesh.size(i), idx * mesh.size(i) + mesh.get_local_rank(i)
    return n, idx


def _model_extent(mesh) -> int:
    names = mesh.mesh_dim_names if mesh is not None else ()
    return mesh.size(names.index("model")) if "model" in names else 1


def _mesh_group(mesh):
    """A group of every rank of ``mesh`` (its data group when that is all
    of it)."""
    names = mesh.mesh_dim_names
    if mesh.size(names.index("data")) == mesh.size():
        return mesh.get_group(names.index("data"))
    return dist.new_group(sorted(mesh.mesh.flatten().tolist()))


class Trainer:
    """Trains an :class:`LM` of ``model_cfg`` on ``data_cfg``'s synthetic
    tokens with :func:`build_train_step`, on ``device`` (the card unless
    the caller asks for another), data-parallel over ``mesh`` when one is
    given (``dp_axes``: its data-parallel axes; ``grad_compression``:
    ``"none"`` or ``"int8_ef"``).  Weights are drawn from a generator
    seeded with ``init_or_restore``'s ``seed``."""

    def __init__(self, model_cfg: LMConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig, *, device=None,
                 mesh=None, dp_axes=None, grad_compression: str = "none",
                 grad_accum: int = 1, master_weights: bool = False,
                 loss_scaling: Optional[LossScaleConfig] = None,
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dp_axes = dp_axes
        self.grad_compression = grad_compression
        self.grad_accum = grad_accum
        self.master_weights = master_weights
        self.loss_scaling = loss_scaling
        self.failure_injector = failure_injector
        self._group = None
        self.ckpt = self._manager()
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
    def _manager(self) -> CheckpointManager:
        """The checkpoint manager of this rank's place on the mesh; on a
        mesh, ``data_cfg``'s ``n_hosts`` and ``host_id`` become the
        data-parallel size and this rank's index there, and every rank of
        the mesh is a checkpoint host."""
        host_id, n_hosts = self.data_cfg.host_id, self.data_cfg.n_hosts
        if self.mesh is not None:
            axes = tuple(self.dp_axes or dp_axes_for(self.mesh))
            n, idx = _place(self.mesh, axes)
            self.data_cfg = dataclasses.replace(self.data_cfg, n_hosts=n,
                                                host_id=idx)
            n_hosts, host_id = _place(self.mesh, self.mesh.mesh_dim_names)
            self._group = _mesh_group(self.mesh)
        return CheckpointManager(self.tcfg.ckpt_dir, keep=self.tcfg.keep,
                                 host_id=host_id, n_hosts=n_hosts,
                                 group=self._group)

    def _init(self, seed: int):
        self.model = self.state = None
        setup = make_train_setup(
            self.model_cfg, self.opt_cfg, mesh=self.mesh,
            dp_axes=self.dp_axes, grad_compression=self.grad_compression,
            device=self.device, seed=seed, grad_accum=self.grad_accum,
            master_weights=self.master_weights,
            loss_scaling=self.loss_scaling)
        self.model, self.state = setup.model, setup.state
        self._train_step = setup.train_step
        self.placements = setup.state_placements
        self.skip = setup.state_skip
        self.step = 0

    def init_or_restore(self, seed: int = 0) -> int:
        """Build the model and state from ``seed``, then load the latest
        committed checkpoint if there is one.  Returns the step."""
        self.seed = seed
        self._init(seed)
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is not None:
            self._restore(latest)
        self._first_step = self.step
        return self.step

    def _restore(self, ckpt_step: int):
        self.ckpt.wait()
        self.state, self.step = self.ckpt.restore(
            step=ckpt_step, target=self.state, placements=self.placements)
        log.warning("restored checkpoint at step %d", self.step)

    def _recover(self):
        """Back to the latest committed checkpoint, or to the seeded
        initial state before the first: the step may have updated the
        state in place before it failed.  Forget the losses of the steps
        that will be replayed."""
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is not None:
            self._restore(latest)
        else:
            self._init(self.seed)
        del self.history[max(self.step - self._first_step, 0):]

    def _save(self):
        if self.placements:
            self.ckpt.save(self.step, self.state, placements=self.placements,
                           skip=self.skip)
        else:
            self.ckpt.save(self.step, self.state)

    def _failed_before_step(self) -> Optional[Exception]:
        """What ``failure_injector`` raised for this step, on any rank: on
        a mesh the ranks agree (an all-reduce of a flag), so all of them
        recover together."""
        exc = None
        if self.failure_injector is not None:
            try:
                self.failure_injector(self.step)
            except Exception as e:  # noqa: BLE001 — any injected failure
                exc = e
        if self._group is not None:
            flag = torch.tensor([float(exc is not None)])
            if dist.get_backend(self._group) == "nccl":
                flag = flag.to(self.device)
            dist.all_reduce(flag, group=self._group)
            if flag.item() and exc is None:
                exc = RuntimeError("a failure on another rank")
        return exc

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
                failed = self._failed_before_step()
                if failed is not None:
                    raise failed
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


class ElasticTrainer(Trainer):
    """A data-parallel trainer that rebuilds itself on a changed rank set.

    ``device_monitor()`` returns the live ranks (by default the whole
    world); when they change, :meth:`maybe_remesh` saves (the state is on
    disk when ``run`` returns a chunk), builds ``mesh_builder(ranks)``
    (by default ``launch.mesh.make_mesh_for_devices`` at the model extent
    of the mesh it started on, as the reference's launcher re-meshes at
    its ``tp``) on every rank of the old world, rebuilds the step and
    restores under the new placements.  A rank outside the new mesh sets
    ``active`` False and leaves :meth:`run`."""

    def __init__(self, *args, device_monitor=None, mesh_builder=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.device_monitor = device_monitor or (
            lambda: list(range(dist.get_world_size())))
        tp = _model_extent(self.mesh)
        self.mesh_builder = mesh_builder or (
            lambda ranks: make_mesh_for_devices(
                ranks, model_parallel=tp, device_type=self.device.type))
        self._ranks = list(self.device_monitor())
        self.active = True

    def maybe_remesh(self) -> bool:
        ranks = list(self.device_monitor())
        if ranks == self._ranks:
            return False
        log.warning("elastic: ranks %s -> %s; re-meshing", self._ranks,
                    ranks)
        if self.ckpt.latest_step() != self.step:
            self._save()
        self.ckpt.wait()
        self._ranks = ranks
        mesh = self.mesh_builder(ranks)
        if dist.get_rank() not in ranks:
            self.active = False
            self.model = self.state = None
            return True
        self.mesh = mesh
        self.ckpt = self._manager()
        self._init(self.seed)
        self._restore(self.ckpt.latest_step())
        return True

    def run(self, n_steps: int, remesh_every: int = 10) -> list:
        """Run ``n_steps`` more steps in chunks of ``remesh_every``,
        re-meshing between chunks; returns the loss history."""
        if self.state is None:
            self.init_or_restore()
        done = 0
        while done < n_steps and self.active:
            chunk = min(remesh_every, n_steps - done)
            super().run(chunk)
            done += chunk
            self.maybe_remesh()
        return self.history
