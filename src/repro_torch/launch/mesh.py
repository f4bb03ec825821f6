"""Device meshes over ``torch.distributed``, the port of
``repro.launch.mesh``.

Axes (DESIGN.md §5, §8): ``pod`` (outer data parallelism), ``data``
(data parallelism and FSDP; for the sharded scan, its G dimension),
``seq`` (the scan's rows, ``parallel.gspn_sp``, carved out of the data
extent) and ``model`` (tensor parallelism).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks, built after the
process group is up (:func:`init_distributed`), on every rank of the
default group.  :data:`HW` is the card's table for the roofline
(``roofline.analysis``), the counterpart of the reference's TPU table.

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
    elif device.type == "cuda":
        # Ranks that share a card: select it now, so a "cuda" DeviceMesh
        # keeps it instead of taking LOCAL_RANK as a card index.
        torch.cuda.set_device(device.index or 0)
        torch.cuda.init()
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
    return _mesh(range(n_data * n_seq), shape, names)


def _mesh(ranks, shape, names, device_type=None) -> DeviceMesh:
    """A mesh whose device type is ``device_type`` or, by default, the
    group's backend's (gloo: the CPU).  Under gloo a ``"cuda"`` mesh
    places FSDP2's shards on the card while gloo carries the
    collectives."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=names)


def mesh_dims_for(n: int, *, model_parallel: int = 16,
                  seq_parallel: int = 1) -> tuple:
    """(shape, axis names) of the reference's best (data[, seq], model)
    mesh over ``n`` ranks: the model extent halves until it divides
    ``n``, the seq extent until it divides the data extent."""
    tp = model_parallel
    while n % tp != 0:
        tp //= 2
    dp = n // tp
    sp = seq_parallel
    while dp % sp != 0:
        sp //= 2
    if sp > 1:
        return (dp // sp, sp, tp), ("data", "seq", "model")
    return (dp, tp), ("data", "model")


def make_mesh_for_devices(ranks, *, model_parallel: int = 16,
                          seq_parallel: int = 1,
                          device_type: str | None = None) -> DeviceMesh:
    """The elastic helper: the best ``("data", "model")`` or ``("data",
    "seq", "model")`` mesh over ``ranks`` (a list of global ranks), as
    :func:`mesh_dims_for` sizes it, on ``device_type`` (:func:`_mesh`).
    Every rank of the default group calls it (a ``DeviceMesh`` builds its
    groups collectively)."""
    ranks = list(ranks)
    shape, names = mesh_dims_for(len(ranks), model_parallel=model_parallel,
                                 seq_parallel=seq_parallel)
    return _mesh(ranks, shape, names, device_type)


def production_mesh_dims(*, multi_pod: bool = False,
                         seq_parallel: int = 1) -> tuple:
    """(shape, axis names) of the reference's production mesh: 16 x 16 =
    256 ranks a pod, ``("data", "model")``, or ``("data", "seq",
    "model")`` with the seq extent carved out of the 16-wide data extent;
    ``multi_pod`` puts two pods on a leading ``pod`` axis (512)."""
    data = 16
    if data % seq_parallel:
        raise ValueError(f"seq_parallel={seq_parallel} does not divide the "
                         f"data extent {data}")
    shape: tuple = (data // seq_parallel, 16)
    names: tuple = ("data", "model")
    if seq_parallel > 1:
        shape = (data // seq_parallel, seq_parallel, 16)
        names = ("data", "seq", "model")
    if multi_pod:
        shape, names = (2,) + shape, ("pod",) + names
    return shape, names


def make_production_mesh(*, multi_pod: bool = False, seq_parallel: int = 1,
                         device_type: str | None = None) -> DeviceMesh:
    """The production mesh over the whole world, which must hold exactly
    its 256 (512 with ``multi_pod``) ranks."""
    shape, names = production_mesh_dims(multi_pod=multi_pod,
                                        seq_parallel=seq_parallel)
    need = 1
    for d in shape:
        need *= d
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"the production mesh {dict(zip(names, shape))} "
                         f"needs {need} ranks; the world has {world}")
    return _mesh(range(need), shape, names, device_type)


# The NVIDIA H100 SXM5 80 GB (700 W) that the roofline charges: datasheet
# constants, not measurements.  The f32 peak is the CUDA cores' (the port
# runs with TF32 off); bf16 is the dense tensor-core peak.  ``link_bw``:
# the production mesh's 16-wide model axis spans two nodes of 8 cards, so
# its collectives cross the one 400 Gb/s NIC of each card (50 GB/s a
# direction), not NVLink (450 GB/s a direction within a node).
HW = {
    "name": "NVIDIA H100 SXM5 80GB",
    "power_limit_w": 700,
    "peak_flops_bf16": 989.4e12,
    "peak_flops_f32": 66.9e12,
    "hbm_bw": 3.35e12,
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,
    "link_bw": 50e9,
}


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
