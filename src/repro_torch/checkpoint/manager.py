"""Checkpoint manager: atomic, asynchronous, retention-limited and
elastic; the port of the reference's ``checkpoint/manager.py`` for states
of torch tensors.

Layout (one directory per step), the reference's::

    <dir>/step_000000123/
        meta.json            — step, flat-key manifest (global shapes,
                               dtypes and, with several hosts, which host
                               holds which slice of each leaf)
        host_000.npz         — host 0's tensors by flat key
        host_001.npz, ...    — with several hosts (data-parallel ranks),
        host_001.json          each host's own shards and their slices
        COMMIT               — written last; a checkpoint without COMMIT is
                               ignored on restore (atomicity)

**Sharded states.**  A rank of a mesh holds a slice of each sharded
leaf (``placements``: flat key -> (dim, parts, index), or a tuple of
such where a data and a model axis both slice it) and the whole of each
replicated one.  Each host writes its own shards (less those another
host of the same slice writes, ``skip``), and host 0 the replicated
leaves, into ``host_{id:03d}.npz``, with the slices in
``host_{id:03d}.json``.  The write is asynchronous; the commit waits for
every host: at the next :meth:`wait` (which every save starts with) the
hosts agree that their files are written (one all-reduce of an error
flag), then host 0 merges the slices into ``meta.json`` and writes
``COMMIT``, and the hosts meet again, so none reads the directory before
the commit.  The reference has every host write every leaf whole; a
full-width state is 16.7 GB, so here each host writes its part.
**Restore** assembles each leaf from the host files that hold it and
copies out the slice the target holds, so a state saved on 2 hosts
restores on 1 or on 4 (the elastic path), and one saved over a
``(data, model)`` mesh on any other layout.  A one-host checkpoint keeps
the single-file layout and reads as before.

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
import torch.distributed as dist

HOST_FILE = "host_000.npz"


def host_file(host_id: int, ext: str = "npz") -> str:
    return f"host_{host_id:03d}.{ext}"


def slice_bounds(size: int, parts: int, index: int) -> tuple:
    """[start, stop) of part ``index`` of ``parts`` equal parts of
    ``size``."""
    if size % parts:
        raise ValueError(f"a dim of {size} does not split in {parts}")
    step = size // parts
    return index * step, (index + 1) * step


def placement_parts(placement) -> tuple:
    """A placement as a tuple of (dim, parts, index) triples: empty for
    None, one for a single triple."""
    if placement is None:
        return ()
    if isinstance(placement[0], int):
        return (tuple(placement),)
    return tuple(tuple(p) for p in placement)


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


def _agree(failed: bool, group) -> bool:
    """True iff some host of ``group`` failed (one all-reduce)."""
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    flag = torch.tensor([float(failed)], device=device)
    dist.all_reduce(flag, group=group)
    return bool(flag.item())


class CheckpointManager:
    """``host_id`` of ``n_hosts`` hosts, which meet over ``group`` (the
    default group when None) to commit; one host needs no group."""

    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1, async_save: bool = True, group=None):
        self.dir = str(directory)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.group = group
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._pending: Optional[tuple] = None
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
        """Join the background write, and raise what it raised.  With
        several hosts, commit the pending checkpoint once every host's
        file is written; every host must call it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self.n_hosts > 1 and self._pending is not None:
            step, meta = self._pending
            self._pending = None
            if _agree(err is not None, self.group):
                raise RuntimeError(f"checkpoint write of step {step} failed "
                                   f"on some host") from err
            if self.host_id == 0:
                self._commit(step, meta)
            dist.barrier(group=self.group)
        if err is not None:
            raise RuntimeError("checkpoint write failed") from err

    def _commit(self, step: int, meta: dict):
        """Host 0: merge every host's slices into meta.json, then COMMIT."""
        sdir = self._step_dir(step)
        for h in range(self.n_hosts):
            with open(os.path.join(sdir, host_file(h, "json"))) as f:
                for k, part in json.load(f).items():
                    meta["keys"][k].setdefault("parts", []).append([h, part])
        with open(os.path.join(sdir, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(sdir, "COMMIT"), "w") as f:
            f.write(str(step))
        self._gc()

    def save(self, step: int, state: Any, extra_meta: dict | None = None,
             placements: dict | None = None, skip=()):
        """Snapshot ``state`` to host memory now; write it in the
        background (if async).  ``placements`` ({flat key: (dim, parts,
        index) or a tuple of them}) names the leaves of which this host
        holds a slice; the others are whole, and with several hosts host
        0 writes them.  ``skip`` names sliced leaves that another host
        holding the same slice writes."""
        self.wait()
        placements = placements or {}
        host, dtypes, shapes, slices = {}, {}, {}, {}
        for k, leaf in flatten(state).items():
            if k in skip or (k not in placements and self.host_id != 0):
                continue
            host[k], dtypes[k] = _to_host(leaf)
            shape = list(host[k].shape)
            slices[k] = []
            for dim, parts, index in placement_parts(placements.get(k)):
                shape[dim] *= parts
                slices[k].append([dim, *slice_bounds(shape[dim], parts,
                                                     index)])
            shapes[k] = shape
        meta = {
            "step": step,
            "n_hosts": self.n_hosts,
            "keys": {k: {"shape": shapes[k], "dtype": dtypes[k]}
                     for k in host},
            "extra": extra_meta or {},
            "time": time.time(),
        }
        if self.n_hosts > 1:
            self._pending = (step, meta)

        def write():
            sdir = self._step_dir(step)
            os.makedirs(sdir, exist_ok=True)
            commit = os.path.join(sdir, "COMMIT")
            if os.path.exists(commit):
                os.remove(commit)
            np.savez(os.path.join(sdir, host_file(self.host_id)), **host)
            if self.n_hosts > 1:
                with open(os.path.join(sdir, host_file(self.host_id,
                                                       "json")), "w") as f:
                    json.dump(slices, f)
                return
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
    def restore(self, step: Optional[int] = None, target: Any = None,
                placements: dict | None = None):
        """Load checkpoint ``step`` (the latest committed by default) into
        ``target``, a state of the saved structure: each tensor leaf is
        overwritten in place (cast to its dtype, on its device), each
        number leaf replaced.  A leaf named in ``placements`` ({flat key:
        (dim, parts, index)}) receives that slice of the saved leaf,
        whichever hosts saved it.  Returns (target, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        sdir = self._step_dir(step)
        with open(os.path.join(sdir, "meta.json")) as f:
            meta = json.load(f)
        keys = meta["keys"]
        placements = placements or {}
        flat = flatten(target)
        missing = set(flat) - set(keys)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}")
        files = {}
        try:
            def npz(h):
                if h not in files:
                    files[h] = np.load(os.path.join(sdir, host_file(h)))
                return files[h]

            for k, tgt in flat.items():
                arr = _part(keys[k], placements.get(k), npz, k)
                shape = tuple(tgt.shape) if isinstance(tgt, torch.Tensor) \
                    else ()
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{k}: checkpoint {arr.shape} != "
                                     f"target {shape}")
                _put(target, k.split("/"), arr, keys[k]["dtype"])
        finally:
            for f in files.values():
                f.close()
        return target, step


def _saved_parts(entry: dict) -> list:
    """[(host, ((dim, start, stop), ...))] of a saved leaf: ``parts``
    holds [host, [[dim, start, stop], ...]] each (the single-axis layout
    wrote [host, dim, start, stop], dim None for a whole leaf)."""
    out = []
    for part in entry.get("parts") or ():
        if len(part) == 2:
            out.append((part[0], tuple(tuple(s) for s in part[1])))
        else:
            out.append((part[0], () if part[1] is None
                        else (tuple(part[1:]),)))
    return out


def _index(ndim: int, slices) -> tuple:
    index = [slice(None)] * ndim
    for dim, lo, hi in slices:
        index[dim] = slice(lo, hi)
    return tuple(index)


def _part(entry: dict, placement, npz, key: str) -> np.ndarray:
    """The slice ``placement`` (None: the whole) of a saved leaf, read
    from the one host file that holds exactly that slice where there is
    one, else cut from the assembled leaf."""
    want = sorted((dim, *slice_bounds(entry["shape"][dim], parts, index))
                  for dim, parts, index in placement_parts(placement))
    for h, slices in _saved_parts(entry):
        if sorted(slices) == want:
            return npz(h)[key]
    arr = _assemble(entry, npz, key)
    return arr[_index(arr.ndim, want)]


def _assemble(entry: dict, npz, key: str) -> np.ndarray:
    """The whole saved leaf: from host 0's file, or from a host file that
    holds it whole, or its slices from the hosts' files."""
    parts = _saved_parts(entry)
    whole = [h for h, slices in parts if not slices]
    if not parts or whole:
        return npz(whole[0] if whole else 0)[key]
    out = None
    for h, slices in parts:
        piece = npz(h)[key]
        if out is None:
            out = np.empty(entry["shape"], dtype=piece.dtype)
        out[_index(out.ndim, slices)] = piece
    return out


def _put(target: dict, path: list, arr: np.ndarray, dtype: str):
    *outer, last = path
    for k in outer:
        target = target[k]
    tgt = target[last]
    if isinstance(tgt, torch.Tensor):
        with torch.no_grad():
            tgt.copy_(_from_host(np.ascontiguousarray(arr), dtype))
    else:
        target[last] = type(tgt)(arr.item())
