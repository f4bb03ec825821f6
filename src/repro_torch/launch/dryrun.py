"""The shape-only dry run: every (architecture × input shape) cell on the
production mesh, rank 0's program run on ``meta`` tensors, with its
FLOPs, bytes, collective bytes and peak memory recorded for the roofline
(``roofline.analysis``).  The port of ``repro.launch.dryrun``, with its
flags, file names and JSON keys.

    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
        --mesh single --out results/dryrun
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

The reference AOT-compiles each cell on 512 forced host devices and reads
XLA's analyses.  Here a cell joins a fake process group of the mesh's
256 (``--mesh multi``: 512) ranks as rank 0 (``backend="fake"``: its
collectives move nothing and return at once), builds its model on
``meta`` (``launch.lowering``) and runs it once under
``roofline.cost.CostMode``.  It needs no card and allocates no tensor
memory: Python's dispatch of the ops is its cost.

Sweep mode (``--all``) runs each cell in a subprocess, so a failing cell
cannot take the sweep down, skips the cells whose JSON already says
``ok`` or ``skipped``, and exits 1 if any cell failed, as the
reference's does.  Every LM cell that is not skipped runs under the
model axis of 16 (``tensor_parallel.check_model_axis`` accepts each
registry config; only ``gspn_impl="sp"``, which no cell uses, waits for
ROADMAP.md §1 item 6.2).  Each cell stops after ``--timeout`` seconds, a
cell of a model with the sLSTM after :data:`TOKEN_LOOP_TIMEOUT` times
that.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback


def cell_matrix():
    """All (kind, arch, shape, skip reason) cells, the LM archs in the
    reference's order (``configs/all_archs.py``: the ten assigned, then
    the GSPN-2 LM), then the vision cells."""
    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.launch.lowering import VISION_SHAPES
    cells = []
    for arch in ASSIGNED + EXTRAS:
        entry = get_arch(arch)
        for shape in SHAPES:
            cells.append(("lm", arch, shape, entry.skip_shapes.get(shape)))
    for vshape in VISION_SHAPES:
        cells.append(("vision", "gspn2-b", vshape, None))
    return cells


# The reference's assignment (``repro/configs/all_archs.py``).
ASSIGNED = ["xlstm-1.3b", "qwen1.5-32b", "granite-3-2b", "qwen2-1.5b",
            "qwen2.5-3b", "zamba2-2.7b", "qwen2-vl-72b", "kimi-k2-1t-a32b",
            "grok-1-314b", "whisper-base"]
EXTRAS = ["qwen2-1.5b-gspn"]


def fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0: the one
    place that imports torch's fake backend."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as exc:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not have") from exc
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(mesh_mode: str):
    """The production mesh of ``mesh_mode`` ("single": 16 x 16, "multi":
    2 x 16 x 16) over a fresh fake group."""
    import math

    from repro_torch.launch.mesh import (make_production_mesh,
                                         production_mesh_dims)
    shape, _ = production_mesh_dims(multi_pod=mesh_mode == "multi")
    fake_group(math.prod(shape))
    return make_production_mesh(multi_pod=mesh_mode == "multi",
                                device_type="cpu")


def measure(cell) -> dict:
    """Run ``cell`` once under ``CostMode`` with its data-axis
    collectives and gathered weights charged: the record's cost keys."""
    from repro_torch.roofline.cost import CostMode
    mode = CostMode(resident=cell.resident)
    with mode:
        for op, payload in cell.collectives:
            mode.add_collective(op, payload)
        mode.add_resident(cell.gathered_bytes)
        cell.fn(*cell.args)
    return mode.result()


def run_cell(kind: str, arch: str, shape: str, mesh_mode: str, out_dir: str,
             remat: str | None = None, tag: str = "",
             grad_accum: int | None = None, mesh=None, **cell_kwargs):
    """Build and run one cell, write its JSON, return True when ``ok``.
    ``mesh`` (a ``DeviceMesh`` over a fake group already joined) stands in
    for the production mesh; ``cell_kwargs`` reach
    ``lowering.build_lm_cell`` (``spec=``, ``reduced=``)."""
    from repro_torch.launch.mesh import HW
    from repro_torch.parallel import collectives

    result = {"arch": arch, "shape": shape, "mesh": mesh_mode, "tag": tag,
              "status": "unknown"}
    t0 = time.perf_counter()
    try:
        if mesh is None:
            mesh = production_mesh(mesh_mode)
        names = mesh.mesh_dim_names
        result["mesh_shape"] = {n: mesh.size(i) for i, n in enumerate(names)}
        result["n_devices"] = mesh.size()
        from repro_torch.launch import lowering
        if kind == "vision":
            cell = lowering.build_vision_cell(arch, shape, mesh)
        else:
            cell = lowering.build_lm_cell(arch, shape, mesh, remat=remat,
                                          grad_accum=grad_accum,
                                          **cell_kwargs)
        result["meta"] = cell.meta
        t_lower = time.perf_counter() - t0
        collectives.clear_staged()
        cost = measure(cell)
        t_run = time.perf_counter() - t0 - t_lower
        print({k: cost[k] for k in ("flops", "bytes_hbm", "peak_bytes")})
        result.update({
            "status": "ok",
            "lower_s": round(t_lower, 2),
            "compile_s": round(t_run, 2),
            "memory": {"peak_memory_in_bytes": cost["peak_bytes"]},
            **cost,
            "trip_ratio": 1.0,
            "hw": HW,
        })
    except Exception as exc:  # noqa: BLE001
        result["status"] = "error"
        result["error"] = f"{type(exc).__name__}: {exc}"
        result["traceback"] = traceback.format_exc()[-4000:]

    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape}__{mesh_mode}{('__' + tag) if tag else ''}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[dryrun] {fname}: {result['status']} "
          f"(build {result.get('lower_s', '-')}s, "
          f"run {result.get('compile_s', '-')}s)")
    return result["status"] == "ok"


def write_skip(arch, shape, mesh_mode, reason, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape}__{mesh_mode}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump({"arch": arch, "shape": shape, "mesh": mesh_mode,
                   "status": "skipped", "reason": reason}, f, indent=1)


# A model with the sLSTM runs its token loop on ``meta`` one token's ops
# at a time, each dispatched through Python: on one CPU core
# xlstm-1.3b × train_4k took 62 min (multi) and 130 min (single), its
# prefill_32k 20-22 min.  The sweep gives its cells this many times the
# timeout.
TOKEN_LOOP_TIMEOUT = 6


def cell_timeout(kind: str, arch: str, timeout: int) -> int:
    """The sweep's timeout of one cell, in seconds."""
    from repro_torch.configs.base import get_arch
    if kind == "lm" and any(k == "slstm" for _, k, _ in
                            get_arch(arch).full().stages()):
        return timeout * TOKEN_LOOP_TIMEOUT
    return timeout


def drive_all(mesh_modes, out_dir, timeout: int = 1800):
    """Run every cell not yet ``ok`` or ``skipped`` in ``out_dir``, each
    in a subprocess stopped after :func:`cell_timeout`; True when none
    failed."""
    ok = fail = skip = cached = 0
    for kind, arch, shape, skip_reason in cell_matrix():
        for mm in mesh_modes:
            fname = os.path.join(out_dir, f"{arch}__{shape}__{mm}.json")
            if os.path.exists(fname):
                with open(fname) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    cached += 1
                    continue
            if skip_reason is not None:
                write_skip(arch, shape, mm, skip_reason, out_dir)
                skip += 1
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mm,
                   "--out", out_dir]
            if kind == "vision":
                cmd.append("--vision")
            print(f"[sweep] {arch} × {shape} × {mm} ...", flush=True)
            limit = cell_timeout(kind, arch, timeout)
            try:
                r = subprocess.run(cmd, timeout=limit)
                ok += int(r.returncode == 0)
                fail += int(r.returncode != 0)
            except subprocess.TimeoutExpired:
                write_skip(arch, shape, mm, f"run timeout {limit}s",
                           out_dir)
                fail += 1
    print(f"[sweep] done: ok={ok} fail={fail} skipped={skip} "
          f"cached={cached}")
    return fail == 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--vision", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args()

    if args.list:
        for kind, arch, shape, skip in cell_matrix():
            print(f"{kind:7s} {arch:20s} {shape:15s}"
                  f"{' SKIP: ' + skip if skip else ''}")
        return

    modes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        sys.exit(0 if drive_all(modes, args.out, args.timeout) else 1)

    ok = True
    for mm in modes:
        ok &= run_cell("vision" if args.vision else "lm", args.arch,
                       args.shape, mm, args.out, remat=args.remat,
                       tag=args.tag, grad_accum=args.grad_accum)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
