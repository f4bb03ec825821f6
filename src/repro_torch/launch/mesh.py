"""Device meshes over ``torch.distributed``, the twin of the sequence-
parallel helpers of ``repro.launch.mesh``.

Axes (DESIGN.md §5, §8): ``data`` (the scan's G dimension) and ``seq``
(the scan's rows, ``parallel.gspn_sp``).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh``, built after the process
group is up (:func:`init_distributed`), on every rank.

The backend is chosen, never tried: NCCL where every rank has a card of
its own, gloo on the CPU and where ranks share a card (NCCL refuses two
ranks on one device).  Nothing here touches ``torch.distributed`` at
import.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DP_AXES = ("pod", "data")


def backend_for(device: torch.device, world_size: int) -> str:
    """``nccl`` when ``device`` is a card and the host has one for every
    rank, else ``gloo``."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device: torch.device) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) over :func:`backend_for`'s backend, and return the
    device this rank computes on: under NCCL its own card
    (``LOCAL_RANK``), else ``device`` itself."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = backend_for(device, world)
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, rank=rank, world_size=world,
        init_method=f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                    f"{os.environ['MASTER_PORT']}")
    return device


def make_sp_mesh(n_seq: int | None = None, *, n_data: int = 1) -> DeviceMesh:
    """A ``("seq",)`` mesh over the first ``n_seq`` ranks (all of them by
    default), or with ``n_data`` > 1 a ``("data", "seq")`` mesh of
    ``n_data`` × ``n_seq`` ranks: rank r is block r % n_seq of data shard
    r // n_seq.  Its device type follows the group's backend."""
    n_seq = n_seq or dist.get_world_size() // n_data
    shape = (n_seq,) if n_data == 1 else (n_data, n_seq)
    names = ("seq",) if n_data == 1 else ("data", "seq")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(n_data * n_seq).reshape(shape),
                      mesh_dim_names=names)


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def dp_axes_for(mesh) -> tuple:
    """The mesh's data-parallel axes, of ``("pod", "data")``."""
    return tuple(a for a in _names(mesh) if a in DP_AXES)


def seq_axis_size(mesh, axis: str = "seq") -> int:
    """Extent of the sequence-parallel axis, or of any axis named (1
    without a mesh or that axis)."""
    names = _names(mesh)
    return mesh.size(names.index(axis)) if axis in names else 1
