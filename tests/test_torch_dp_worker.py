"""One rank of the data-parallel CPU checks in ``test_torch_dp.py``.

Started once per rank, as ``torchrun`` starts a rank (``RANK``,
``WORLD_SIZE``, ``MASTER_PORT``), it joins a gloo group and runs every
case of its world size on the inputs the test wrote (first argument);
rank 0 writes the results to the ``.npz`` named by the second argument.
The third argument is a scratch directory the test keeps (the
checkpoints of the 2-rank run, which the 4-rank run restores).  It
imports no JAX.

    RANK=0 WORLD_SIZE=2 MASTER_PORT=29500 \\
        python tests/test_torch_dp_worker.py inputs.npz out.npz scratch/
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_arch, with_precision
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import init_distributed, make_mesh_for_devices
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import collectives as C
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import sharded_dim
from repro_torch.train import step as tstep
from repro_torch.train.trainer import ElasticTrainer, TrainerConfig

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ELASTIC_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEPS = 2


def config():
    """The reduced GSPN LM under the f32 policy, remat "unit"."""
    return dataclasses.replace(
        with_precision(get_arch("qwen2-1.5b-gspn").reduced(), "f32"),
        remat="unit")


def elastic_config():
    return with_precision(get_arch("qwen2-1.5b-gspn").reduced(), "f32")


def gather(local, placement, group=None):
    """The whole tensor of which ``local`` is part ``placement`` (None:
    already whole)."""
    if placement is None:
        return local.detach().clone()
    dim, parts, _ = placement
    pieces = [torch.empty_like(local) for _ in range(parts)]
    dist.all_gather(pieces, local.detach().contiguous(), group=group)
    return torch.cat(pieces, dim=dim)


def gathered_state(setup, key="params"):
    return {n: gather(t, setup.state_placements.get(f"{key}/{n}"))
            for n, t in setup.state[key].items()}


def load_full(setup, full: dict):
    """Copy whole parameters into a (sharded) setup's local tensors."""
    with torch.no_grad():
        for n, t in setup.state["params"].items():
            src = full[n]
            pl = setup.state_placements.get(f"params/{n}")
            if pl is not None:
                dim, parts, idx = pl
                size = src.shape[dim] // parts
                src = src.narrow(dim, idx * size, size)
            t.copy_(src)


def batch_of(inp, step, lo=None, hi=None):
    return {k: torch.from_numpy(np.ascontiguousarray(
        inp[f"batch/{step}/{k}"][lo:hi])) for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# World size 2.
# ---------------------------------------------------------------------------

def collective_cases(inp, out, rank):
    fn = C.compressed_allreduce(make_mesh_for_devices(
        range(2), model_parallel=1), "data")
    for case in ("random", "zero", "one_zero"):
        g = torch.from_numpy(inp[f"comp/{case}"][rank])
        gh, e = fn({"g": g}, {"g": torch.zeros_like(g)})
        out[f"comp/{case}/g"] = gh["g"].numpy()
        out[f"comp/{case}/e"] = gather(e["g"], (0, 2, rank)).numpy()
    # The counted collectives FSDP2 takes on a shared card, on CPU tensors.
    g = torch.from_numpy(inp["comp/random"][rank])
    ag = torch.empty(2 * g.shape[0], g.shape[1])
    C.CountedAllGather()(ag, g, dist.group.WORLD)
    rs = torch.empty(g.shape[0] // 2, g.shape[1])
    C.CountedReduceScatter()(rs, g, dist.group.WORLD, dist.ReduceOp.SUM)
    out["counted/ag"], out["counted/rs"] = ag.numpy(), rs.numpy()
    out["counted/ar"] = C.all_reduce_counted(g.clone()).numpy()
    out["counted/bytes"] = sum(C.staged_bytes.values())


def placements_case(out, rank, mesh):
    """Seeded setup: every local shape is the global shape divided as the
    spec says; replicated leaves are whole and equal on both ranks; the
    gathered weights equal an unsharded model's from the same seed."""
    cfg = config()
    ocfg = AdamWConfig(**OPT)
    setup = tstep.make_train_setup(cfg, ocfg, mesh=mesh, device="cpu",
                                   grad_compression="int8_ef", seed=3)
    ref = tstep.make_train_setup(cfg, ocfg, device="cpu", seed=3)
    bad = []
    for key in ("params", "errors"):
        for n, t in setup.state[key].items():
            want = list(ref.state["params"][n].shape)
            d = sharded_dim(setup.param_specs[n], "data")
            if d is not None:
                want[d[0]] //= 2
            if list(t.shape) != want:
                bad.append((key, n, list(t.shape), want))
    for mom in ("m", "v"):
        for n, t in setup.state["opt"][mom].items():
            if t.shape != setup.state["params"][n].shape:
                bad.append((mom, n))
    sums = torch.tensor([float(t.double().sum()) for n, t in
                         sorted(setup.state["params"].items())
                         if f"params/{n}" not in setup.state_placements])
    both = [torch.empty_like(sums) for _ in range(2)]
    dist.all_gather(both, sums)
    full = gathered_state(setup)
    seed_equal = all(torch.equal(full[n], p)
                     for n, p in ref.state["params"].items())
    out["placements"] = json.dumps({
        "bad": bad, "replicated_equal": bool(torch.equal(*both)),
        "n_sharded": sum(1 for k in setup.state_placements
                         if k.startswith("params/")),
        "n_params": len(setup.state["params"]), "seed_equal": seed_equal})


def step_cases(inp, out, rank, mesh):
    """2 steps of the sharded step (and its int8_ef twin) from the
    reference's weights on each rank's half of the batch, and the
    one-rank step on the whole batch; then the sharded state saved."""
    cfg = config()
    ocfg = AdamWConfig(**OPT)
    full = {k[7:]: torch.from_numpy(v) for k, v in inp.items()
            if k.startswith("params/")}
    for comp in ("none", "int8_ef"):
        sh = tstep.make_train_setup(cfg, ocfg, mesh=mesh, device="cpu",
                                    grad_compression=comp)
        one = tstep.make_train_setup(cfg, ocfg, device="cpu",
                                     grad_compression=comp)
        load_full(sh, full)
        load_full(one, full)
        for s in range(STEPS):
            _, m = sh.train_step(sh.state, batch_of(inp, s, 2 * rank,
                                                    2 * rank + 2))
            _, m1 = one.train_step(one.state, batch_of(inp, s))
            for k in ("loss", "grad_norm"):
                out[f"{comp}/{s}/{k}"] = float(m[k])
                out[f"{comp}/one/{s}/{k}"] = float(m1[k])
            for n, t in gathered_state(sh).items():
                out[f"{comp}/{s}/p/{n}"] = t.numpy()
                out[f"{comp}/one/{s}/p/{n}"] = \
                    one.state["params"][n].detach().numpy().copy()
            if comp == "int8_ef":
                for n, t in gathered_state(sh, "errors").items():
                    out[f"{comp}/{s}/e/{n}"] = t.numpy()
                    out[f"{comp}/one/{s}/e/{n}"] = \
                        one.state["errors"][n].numpy().copy()
        if comp == "none":
            ck = CheckpointManager(str(pathlib.Path(sys.argv[3]) / "ck2"),
                                   host_id=rank, n_hosts=2)
            ck.save(STEPS, sh.state, placements=sh.state_placements)
            ck.wait()
            for key in ("params", "errors"):
                if key in sh.state:
                    for n, t in gathered_state(sh, key).items():
                        out[f"saved/{key}/{n}"] = t.numpy()
            for mom in ("m", "v"):
                for n, t in sh.state["opt"][mom].items():
                    pl = sh.state_placements.get(f"opt/{mom}/{n}")
                    out[f"saved/opt/{mom}/{n}"] = gather(t, pl).numpy()


# ---------------------------------------------------------------------------
# World size 4.
# ---------------------------------------------------------------------------

def restore_case(out, rank, mesh):
    """The 2-rank checkpoint restored on 4 ranks, gathered."""
    setup = tstep.make_train_setup(config(), AdamWConfig(**OPT), mesh=mesh,
                                   device="cpu", seed=11)
    ck = CheckpointManager(str(pathlib.Path(sys.argv[3]) / "ck2"),
                           host_id=rank, n_hosts=4)
    _, step = ck.restore(target=setup.state,
                         placements=setup.state_placements)
    out["restored/step"] = step
    out["restored/opt_step"] = setup.state["opt"]["step"]
    for n, t in gathered_state(setup).items():
        out[f"restored/params/{n}"] = t.numpy()
    for mom in ("m", "v"):
        for n, t in setup.state["opt"][mom].items():
            pl = setup.state_placements.get(f"opt/{mom}/{n}")
            out[f"restored/opt/{mom}/{n}"] = gather(t, pl).numpy()


def elastic_case(inp, out, rank):
    """4 ranks, then 2 from step 8 of 20; a failure injected on rank 1 at
    step 3 is agreed and recovered by every rank."""
    fired = set()

    def injector(step):
        if step == 3 and rank == 1 and not fired:
            fired.add(step)
            raise RuntimeError("injected")

    polls = {"n": 0}

    def monitor():
        polls["n"] += 1
        return [0, 1, 2, 3] if polls["n"] == 1 else [0, 1]

    d = pathlib.Path(sys.argv[3]) / "elastic"
    tr = ElasticTrainer(
        elastic_config(), AdamWConfig(**ELASTIC_OPT),
        DataConfig(vocab=512, seq_len=16, global_batch=4),
        TrainerConfig(ckpt_dir=str(d), ckpt_every=5, log_every=1000),
        device="cpu", mesh=make_mesh_for_devices(range(4), model_parallel=1),
        failure_injector=injector, device_monitor=monitor)
    hist = tr.run(20, remesh_every=8)
    if rank == 0:
        out["elastic/history"] = np.array(hist)
        out["elastic/meta"] = json.dumps({
            "step": tr.step, "recoveries": tr.recoveries,
            "mesh": tr.mesh.size(), "n_hosts": tr.data_cfg.n_hosts})
    out[f"elastic/active/{rank}"] = tr.active


def pipeline_case(inp, out, rank):
    mesh = make_mesh_for_devices(range(4), model_parallel=1)
    ws = torch.from_numpy(inp["pipe/ws"])
    x = torch.from_numpy(inp["pipe/x"])
    y = pipeline_apply(mesh, "data", lambda w, a: torch.tanh(a @ w["w"]),
                       {"w": ws[rank]}, x, n_micro=x.shape[0])
    out["pipe/y"] = y.numpy()
    ref = x
    for i in range(4):
        ref = torch.tanh(ref @ ws[i])
    out["pipe/seq"] = ref.numpy()


def mesh_case(out):
    for n in (1, 2, 4):
        for mp, sp in ((16, 1), (2, 1), (1, 2), (2, 2)):
            mesh = make_mesh_for_devices(range(n), model_parallel=mp,
                                         seq_parallel=sp)
            out[f"mesh/{n}/{mp}/{sp}"] = json.dumps([
                list(mesh.mesh.shape), list(mesh.mesh_dim_names)])


def pod_case(inp, out, rank):
    """A ("pod", "data") mesh of 2 x 2: sharded over data, replicated over
    pod (hybrid FSDP); one step on each rank's row of the batch, gathered
    over its data group."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("pod", "data"))
    full = {k[7:]: torch.from_numpy(v) for k, v in inp.items()
            if k.startswith("params/")}
    sh = tstep.make_train_setup(config(), AdamWConfig(**OPT), mesh=mesh,
                                device="cpu")
    load_full(sh, full)
    _, m = sh.train_step(sh.state, batch_of(inp, 0, rank, rank + 1))
    data = mesh.get_group("data")
    out["pod/loss"], out["pod/grad_norm"] = float(m["loss"]), \
        float(m["grad_norm"])
    whole = {n: gather(t, sh.state_placements.get(f"params/{n}"), data)
             for n, t in sh.state["params"].items()}
    for n, t in whole.items():
        out[f"pod/p/{n}"] = t.numpy()
    sums = torch.tensor([t.double().sum().item() for t in whole.values()],
                        dtype=torch.float64)
    every = [torch.empty_like(sums) for _ in range(4)]
    dist.all_gather(every, sums)
    out["pod/replicas_equal"] = all(torch.equal(e, every[0]) for e in every)


def main():
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    inp = dict(np.load(sys.argv[1]))
    init_distributed(torch.device("cpu"))
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    mesh = make_mesh_for_devices(range(world), model_parallel=1)
    if world == 2:
        collective_cases(inp, out, rank)
        placements_case(out, rank, mesh)
        step_cases(inp, out, rank, mesh)
    else:
        restore_case(out, rank, mesh)
        pod_case(inp, out, rank)
        pipeline_case(inp, out, rank)
        mesh_case(out)
        elastic_case(inp, out, rank)
        flags = [torch.zeros(1) for _ in range(world)]
        dist.all_gather(flags, torch.tensor([float(
            out.pop(f"elastic/active/{rank}"))]))
        out["elastic/active"] = torch.cat(flags).numpy()
    if rank == 0:
        np.savez(sys.argv[2], **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
