"""Checkpoint manager: atomic, asynchronous, retention-limited; the port
of the reference's ``checkpoint/manager.py`` for states of torch tensors.

Layout (one directory per step), the reference's::

    <dir>/step_000000123/
        meta.json            — step, flat-key manifest (shapes, dtypes)
        host_000.npz         — the tensors by flat key (the port runs one
                               process, so one host file)
        COMMIT               — written last; a checkpoint without COMMIT is
                               ignored on restore (atomicity)

A state is a nested dict whose leaves are tensors or Python numbers; its
flat keys join the dict keys with ``/`` (``params/embed``,
``opt/m/ln_f.scale``, ``opt/step``).

* **Async**: ``save`` copies every tensor to host memory synchronously
  (the train step updates the state in place right after) and writes to
  disk on a background thread.
* **Rewrite**: saving a step that is already on disk first removes its
  ``COMMIT``, so a write cut short leaves that step uncommitted, never a
  committed checkpoint with a torn file.
* **Retention**: keeps the newest ``keep`` committed checkpoints.
* **Restore**: fills a target state in place, by flat key; a missing key
  or a shape that differs raises.
* **bf16**: numpy has no bfloat16, so a bf16 tensor is stored as its
  ``uint16`` bits and ``meta.json`` records its dtype; a round trip gives
  the same bits.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

HOST_FILE = "host_000.npz"


def flatten(state, prefix: str = "") -> dict:
    """{flat key: leaf} of a nested dict, keys joined with ``/``."""
    flat = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a numpy copy of a leaf, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), dtype
        return t.numpy(), dtype
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = str(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(self.dir, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def committed_steps(self) -> list:
        steps = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMIT")):
                steps.append(int(name.split("_")[1]))
        return steps

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    # -- save -------------------------------------------------------------
    def wait(self):
        """Join the background write, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save(self, step: int, state: Any, extra_meta: dict | None = None):
        """Snapshot ``state`` to host memory now; write it in the
        background (if async)."""
        self.wait()
        host, dtypes = {}, {}
        for k, leaf in flatten(state).items():
            host[k], dtypes[k] = _to_host(leaf)
        meta = {
            "step": step,
            "n_hosts": 1,
            "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                     for k, v in host.items()},
            "extra": extra_meta or {},
            "time": time.time(),
        }

        def write():
            sdir = self._step_dir(step)
            os.makedirs(sdir, exist_ok=True)
            commit = os.path.join(sdir, "COMMIT")
            if os.path.exists(commit):
                os.remove(commit)
            np.savez(os.path.join(sdir, HOST_FILE), **host)
            with open(os.path.join(sdir, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(commit, "w") as f:
                f.write(str(step))
            self._gc()

        def write_async():
            try:
                write()
            except Exception as exc:  # noqa: BLE001 — raised in wait()
                self._error = exc

        if self.async_save:
            self._thread = threading.Thread(target=write_async, daemon=True)
            self._thread.start()
        else:
            write()

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, step: Optional[int] = None, target: Any = None):
        """Load checkpoint ``step`` (the latest committed by default) into
        ``target``, a state of the saved structure: each tensor leaf is
        overwritten in place (cast to its dtype, on its device), each
        number leaf replaced.  Returns (target, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        sdir = self._step_dir(step)
        with open(os.path.join(sdir, "meta.json")) as f:
            keys = json.load(f)["keys"]
        with np.load(os.path.join(sdir, HOST_FILE)) as npz:
            data = {k: npz[k] for k in npz.files}
        flat = flatten(target)
        missing = set(flat) - set(data)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}")
        for k, tgt in flat.items():
            shape = tuple(tgt.shape) if isinstance(tgt, torch.Tensor) else ()
            if tuple(data[k].shape) != shape:
                raise ValueError(f"{k}: checkpoint {data[k].shape} != target "
                                 f"{shape}")
        _fill(target, data, keys)
        return target, step


def _fill(target: dict, data: dict, keys: dict, prefix: str = ""):
    for k, tgt in target.items():
        key = f"{prefix}{k}"
        if isinstance(tgt, dict):
            _fill(tgt, data, keys, key + "/")
        elif isinstance(tgt, torch.Tensor):
            with torch.no_grad():
                tgt.copy_(_from_host(data[key], keys[key]["dtype"]))
        else:
            target[k] = type(tgt)(data[key].item())
