"""One rank of the sequence-parallel CPU checks in ``test_torch_sp.py``.

Started once per rank, as ``torchrun`` starts a rank (``RANK``,
``WORLD_SIZE``, ``MASTER_PORT``), it joins a gloo group, runs every case
of ``test_torch_sp.py`` on a ``("seq",)`` mesh of all ranks (and, with
four ranks, the hybrid ``("data", "seq")`` mesh of 2 x 2) and, on rank 0,
writes each output, gradient, collective record and counter delta to
the ``.npz`` named by its second argument.  The first argument is the
inputs file the test wrote.  It imports no JAX.

    RANK=0 WORLD_SIZE=2 MASTER_PORT=29500 \\
        python tests/test_torch_sp_worker.py \\
        inputs.npz out.npz
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import gspn as G
from repro_torch.launch.mesh import init_distributed, make_sp_mesh
from repro_torch.models.lm import Ctx
from repro_torch.models.vision import GSPNVision, GSPNVisionConfig, vision_loss
from repro_torch.parallel import gspn_sp as sp

COUNTERS = ("sp_exchanges_total", "sp_collective_ops_total",
            "sp_boundary_bytes_total", "sp_activation_bytes_total",
            "sp_pair_fused_exchanges_total")
STRATEGIES = ("auto", "ppermute", "allgather")


def _exchanges(tape):
    """The exchange collectives of a record, the assembling gathers left
    out, as JSON."""
    return json.dumps([list(c) for c in tape if c[0] != "assemble"])


class Runner:
    def __init__(self, inp, k):
        self.inp, self.k, self.out = inp, k, {}

    def args(self, prefix, names):
        return [torch.tensor(self.inp[f"{prefix}/{n}"], requires_grad=True)
                for n in names]

    def run(self, name, fn, args, loss=None, grads=True):
        """The forward (and its exchange record), then with ``grads`` the
        gradients of ``loss`` (sum of sin) (and the record of forward and
        backward together)."""
        loss = loss or (lambda o: torch.sin(o).sum())
        with torch.no_grad():
            out, tape = sp.collectives(fn, *args)
        self.out[f"{name}/out"] = out.numpy()
        self.out[f"{name}/tape"] = _exchanges(tape)
        if not grads:
            return

        def fwd_bwd():
            return torch.autograd.grad(loss(fn(*args)), args)
        gs, tape = sp.collectives(fwd_bwd)
        for i, g in enumerate(gs):
            self.out[f"{name}/g{i}"] = g.numpy()
        self.out[f"{name}/grad_tape"] = _exchanges(tape)

    def counters(self, name, fn, args):
        before = [obs.counter(c).value for c in COUNTERS]
        with torch.no_grad():
            fn(*args)
        self.out[f"{name}/counters"] = np.array(
            [obs.counter(c).value - b for c, b in zip(COUNTERS, before)])


def run_cases(r: Runner, mesh, k: int):
    five = ("x", "wl", "wc", "wr", "lam")
    # All four directions at H = 21, W = 12 (cpw 3), each strategy.
    for s in STRATEGIES:
        r.run(f"{k}/dirs/{s}", lambda *a, s=s: G.directional_scan(
            *a, G.DIRECTIONS, impl="sp", mesh=mesh, sp_strategy=s),
            r.args("dirs", five))
    # Gradients read at the grid's edges, heights K does not divide.
    for h in (19, 9):
        for row in (0, h - 1):
            for s in ("ppermute", "allgather"):
                r.run(f"{k}/edge/{h}/{row}/{s}",
                      lambda *a, s=s: sp.gspn_scan_sp(*a, mesh=mesh,
                                                      strategy=s),
                      r.args(f"edge/{h}", five),
                      loss=lambda o, row=row: torch.sin(o[:, row]).sum())
    # The fused pair, and its per-direction fallback.
    for i in (0, 1):
        args = r.args(f"pair/{i}", five)
        r.run(f"{k}/pair/{i}", lambda *a: sp.gspn_scan_sp_pair(
            *a, mesh=mesh), args)
        r.run(f"{k}/pair/{i}/allgather", lambda *a: sp.gspn_scan_sp_pair(
            *a, mesh=mesh, strategy="allgather"), args, grads=False)
    for m in sp.EXCHANGE_MODES:
        r.run(f"{k}/modes/{m}", lambda *a, m=m: sp.gspn_scan_sp_pair(
            *a, mesh=mesh, exchange_mode=m), r.args("modes", five),
            grads=m == "serial")
    # The wire dtypes.
    for s in ("ppermute", "allgather"):
        for wire in ("float32", "bfloat16"):
            r.run(f"{k}/wire/{s}/{wire}", lambda *a, s=s, wire=wire:
                  sp.gspn_scan_sp(*a, mesh=mesh, strategy=s,
                                  boundary_dtype=getattr(torch, wire)),
                  r.args("wire", five), grads=False)
    r.run(f"{k}/wire/pair/bfloat16", lambda *a: sp.gspn_scan_sp_pair(
        *a, mesh=mesh, boundary_dtype=torch.bfloat16),
        r.args("pair/0", five), grads=False)
    # The sp_* counters of one call of each kind.
    for name, fn, prefix in (
            ("ppermute", lambda *a: sp.gspn_scan_sp(
                *a, mesh=mesh, strategy="ppermute"), "wire"),
            ("allgather", lambda *a: sp.gspn_scan_sp(
                *a, mesh=mesh, strategy="allgather",
                boundary_dtype=torch.bfloat16), "wire"),
            ("pair", lambda *a: sp.gspn_scan_sp_pair(*a, mesh=mesh),
             "pair/0"),
            ("pair_bf16", lambda *a: sp.gspn_scan_sp_pair(
                *a, mesh=mesh, boundary_dtype=torch.bfloat16), "pair/0"),
            ("pair_skip", lambda *a: sp.gspn_scan_sp_pair(
                *a, mesh=mesh, exchange_mode="skip"), "pair/0")):
        r.counters(f"{k}/counters/{name}", fn, r.args(prefix, five))
    run_layers(r, mesh, k)


def _load(module, inp, prefix):
    module.load_state_dict({
        n[len(prefix) + 1:]: torch.from_numpy(inp[n]) for n in inp.files
        if n.startswith(prefix + "/")})
    return module


def run_layers(r: Runner, mesh, k: int):
    """The layer wiring through the reference's parameters: the attention
    module, the sequence mixer and a small vision backbone, forward; the
    backbone's loss gradients against its unsharded twin."""
    inp = r.inp
    attn = _load(G.GSPNAttention(G.GSPNAttentionConfig(
        dim=16, proxy_dim=2, impl="sp"), device="cpu"), inp, "attn")
    mixer = _load(G.GSPNSeqMixer(G.GSPNSeqConfig(
        dim=16, proxy_dim=2, row_width=8, impl="sp"), device="cpu"), inp,
        "mixer")
    vcfg = GSPNVisionConfig(name="t", img_size=16, n_classes=4, dims=(8, 12),
                            depths=(1, 1), proxy_dim=2, impl="sp")
    vision = _load(GSPNVision(vcfg, device="cpu"), inp, "vision")
    with torch.no_grad():
        for name, fn, x in (
                ("attn", lambda x: attn(x, mesh=mesh), "layers/xv"),
                ("mixer", lambda x: mixer(x, mesh=mesh), "layers/xt"),
                ("vision", lambda x: vision(x, mesh=mesh), "layers/img")):
            out, tape = sp.collectives(fn, torch.from_numpy(inp[x]))
            r.out[f"{k}/layers/{name}/out"] = out.numpy()
            r.out[f"{k}/layers/{name}/tape"] = _exchanges(tape)
    plain = GSPNVision(dataclasses.replace(vcfg, impl="torch"),
                       device="cpu")
    plain.load_state_dict(vision.state_dict())
    batch = {"images": torch.from_numpy(inp["layers/img"]),
             "labels": torch.from_numpy(inp["layers/labels"])}
    for name, model, c in (("sp", vision, Ctx(mesh=mesh)),
                           ("plain", plain, None)):
        loss, _ = vision_loss(model, batch, ctx=c)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        r.out[f"{k}/vision_train/{name}/loss"] = loss.detach().numpy()
        for (n, _), g in zip(model.named_parameters(), grads):
            r.out[f"{k}/vision_train/{name}/{n}"] = g.numpy()


def run_hybrid(r: Runner):
    mesh = make_sp_mesh(2, n_data=2)
    r.run("hybrid", lambda *a: sp.gspn_scan_sp(*a, mesh=mesh),
          r.args("hybrid", ("x", "wl", "wc", "wr", "lam")))


def main(inputs: str, out: str):
    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"))
    k = dist.get_world_size()
    r = Runner(np.load(inputs), k)
    run_cases(r, make_sp_mesh(k), k)
    if k == 4:
        run_hybrid(r)
    if dist.get_rank() == 0:
        np.savez(out, **r.out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
