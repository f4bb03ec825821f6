"""One rank of the tensor-parallel CPU checks in ``test_torch_tp.py``.

Started once per rank, as ``torchrun`` starts a rank (``RANK``,
``WORLD_SIZE``, ``MASTER_PORT``), it joins a gloo group and runs every
case of its world size on the inputs the test wrote (first argument);
rank 0 writes the results, every tensor gathered whole, to the ``.npz``
named by the second argument.  The third argument is a scratch
directory the test keeps (the checkpoint saved on ``(data 1, model
2)``).  It runs the sharded prefill and decode cases of its world size
(``SERVE``: at 4 the whole-path xLSTM twin, the 2-head whisper twin and
qwen2-vl with its cache split by positions).  It
imports no JAX: the reference's parameters arrive as numpy
leaves under their pytree paths.

    RANK=0 WORLD_SIZE=2 MASTER_PORT=29500 \\
        python tests/test_torch_tp_worker.py inputs.npz out.npz scratch/
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
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint.manager import CheckpointManager, placement_parts
from repro_torch.configs.base import get_arch, with_precision
from repro_torch.launch.mesh import init_distributed
from repro_torch.models import lm
from repro_torch.models.convert import lm_state_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.data_parallel import DataParallel
from repro_torch.parallel.sharding import sharded_dim
from repro_torch.parallel.tensor_parallel import ModelAxis, shard_model
from repro_torch.train import step as tstep

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# The steps' architectures and meshes, by world size.
# qwen2-1.5b at (1, 4): 6 heads of 8 over 4 ranks of 12 columns, so a
# rank's rows of wo read one and a half heads, and K/V's 16 columns split
# in half heads: both gathered whole.  zamba2 (8 heads) and xlstm (4)
# run each rank's own heads; the 2-head xlstm twin at (1, 4) runs its
# mixers whole on every rank, its split leaves gathered.  whisper's
# encoder, self- and cross-attention and qwen2-vl's M-RoPE split their
# heads; the 2-head whisper twin at (1, 4) holds half a head a rank in
# all three, and the 509-token whisper twin keeps its embedding and head
# whole (509 is prime).
STEPS = {2: (("qwen2-1.5b-gspn", (1, 2)), ("qwen2-1.5b", (1, 2)),
             ("zamba2-2.7b", (1, 2)), ("xlstm-1.3b", (1, 2)),
             ("whisper-base", (1, 2)), ("qwen2-vl-72b", (1, 2)),
             ("whisper-base-v509", (1, 2))),
         4: (("qwen2-1.5b-gspn", (2, 2)), ("qwen2-1.5b", (2, 2)),
             ("qwen2-1.5b", (1, 4)), ("zamba2-2.7b", (2, 2)),
             ("xlstm-1.3b", (2, 2)), ("xlstm-1.3b-2h", (1, 4)),
             ("whisper-base", (2, 2)), ("qwen2-vl-72b", (2, 2)),
             ("whisper-base-2h", (1, 4)))}
# Reduced twins of a registry arch: name -> (arch, config changes).  The
# xlstm with 2 heads: at a model axis of 4 the rules still split its
# in_proj, w_in and out_proj, and no rank holds a whole head.  The
# whisper with 2 heads of 32: at 4 each rank's 16 rows of wo (and 16
# columns of enc_kv_proj) are half a head.
TWINS = {"xlstm-1.3b-2h": ("xlstm-1.3b", {"n_heads": 2, "n_kv_heads": 2}),
         "whisper-base-2h": ("whisper-base", {"n_heads": 2,
                                              "n_kv_heads": 2}),
         "whisper-base-v509": ("whisper-base", {"vocab": 509})}
# The int8_ef steps: each global leaf's scale from a MAX over the axes
# that slice it, the model axis's among them.
INT8 = {2: (("qwen2-1.5b-gspn", (1, 2)), ("qwen2-1.5b", (1, 2))),
        4: (("qwen2-1.5b-gspn", (2, 2)), ("qwen2-1.5b", (2, 2)))}
# The MoE cases: (name, arch, model extent, config changes).
MOE = {2: (("grok2", "grok-1-314b", 2, {}),
           ("kimi2", "kimi-k2-1t-a32b", 2, {})),
       4: (("grok4", "grok-1-314b", 4, {}),
           ("e2", "grok-1-314b", 4, {"n_experts": 2, "top_k": 1}))}


# The sharded prefill and decode cases by world size, (name, arch, config
# changes): the GSPN mixer whole on each rank; qwen2-1.5b's 2 kv heads
# split over the axis; one kv head, so the cache splits its positions;
# grok's expert-parallel MoE at M = 2; zamba2's and xlstm's own heads a
# rank (zamba2's shared attention block beside them); whisper from
# lm_encode's enc_kv, its self- and cross-attention caches split by kv
# heads; qwen2-vl with vision embeddings; at M = 4 the 2-head xlstm whole
# on each rank, the 2-head whisper (half a head a rank, its caches split
# by positions) and qwen2-vl, whose 2 kv heads leave the cache split by
# positions.
SERVE = {2: (("gspn", "qwen2-1.5b-gspn", {}), ("heads", "qwen2-1.5b", {}),
             ("seq", "qwen2-1.5b", {"n_kv_heads": 1}),
             ("moe", "grok-1-314b", {}), ("zamba2", "zamba2-2.7b", {}),
             ("xlstm", "xlstm-1.3b", {}), ("whisper", "whisper-base", {}),
             ("vl", "qwen2-vl-72b", {})),
         4: (("xlstm_whole", "xlstm-1.3b", TWINS["xlstm-1.3b-2h"][1]),
             ("whisper_2h", "whisper-base", TWINS["whisper-base-2h"][1]),
             ("vl_seq", "qwen2-vl-72b", {}))}
# The cache leaves that the model axis keeps whole on every rank: all
# but the attention kinds' KV caches.
SPLIT_LEAVES = ("k", "v")
# Prompt tokens, the caches' max_len and the decode steps after them;
# the VL prompt's vision positions.
PROMPT, MAX_LEN, DECODE_STEPS, VISION = 12, 16, 3, 4
# The batch's leaves besides tokens and labels, by family.
EXTRA = ("vision_embeds", "enc_frames")


def config(arch, **changes):
    """The arch's (or twin's) reduced config under the f32 policy, remat
    "unit"."""
    arch, twin = TWINS.get(arch, (arch, {}))
    return dataclasses.replace(
        with_precision(get_arch(arch).reduced(), "f32"), remat="unit",
        **twin, **changes)


def mesh_of(shape):
    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(
        shape), mesh_dim_names=("data", "model"))


def tree(inp, prefix):
    """The nested dict of the reference's parameters saved under
    ``prefix/<path>``."""
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            *outer, last = k[len(prefix) + 1:].split("/")
            d = out
            for p in outer:
                d = d.setdefault(p, {})
            d[last] = v
    return out


def gather(local, placement, spec, mesh, axes=("data", "model")):
    """The tensor of which ``local`` is part ``placement`` (its leaf's
    spec ``spec`` says which axis slices which dim), whole over
    ``axes``."""
    t = local.detach().contiguous()
    for dim, parts, _ in placement_parts(placement):
        axis = next(a for a in ("data", "model")
                    if (sharded_dim(spec, a) or (None,))[0] == dim)
        if axis not in axes:
            continue
        pieces = [torch.empty_like(t) for _ in range(parts)]
        dist.all_gather(pieces, t, group=mesh.get_group(axis))
        t = torch.cat(pieces, dim=dim)
    return t


def whole_state(setup, key="params", axes=("data", "model")):
    return {n: gather(t, setup.state_placements.get(f"{key}/{n}"),
                      setup.param_specs[n], setup.mesh, axes)
            for n, t in setup.state[key].items()}


def load_whole(setup, full: dict):
    """Copy whole parameters into a sharded setup's local tensors."""
    with torch.no_grad():
        for n, t in setup.state["params"].items():
            src = full[n]
            for dim, parts, idx in placement_parts(
                    setup.state_placements.get(f"params/{n}")):
                size = src.shape[dim] // parts
                src = src.narrow(dim, idx * size, size)
            t.copy_(src)


def batch_of(inp, key, lo=None, hi=None):
    """Rows [lo, hi) of the batch saved under ``key``: tokens, labels and
    the family's vision embeddings or encoder frames."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        inp[f"{key}/{k}"][lo:hi])) for k in ("tokens", "labels") + EXTRA
        if f"{key}/{k}" in inp}


def _data_index(mesh):
    return mesh.get_local_rank(0)


# ---------------------------------------------------------------------------
# Cases.
# ---------------------------------------------------------------------------

def step_case(inp, out, arch, shape, comp="none"):
    """One AdamW step of the sharded setup from the reference's weights on
    this rank's rows of the batch (under ``grad_compression=comp``):
    loss, grad_norm, every parameter (and int8 residual) gathered; local
    shapes against the specs, the leaves the model axis splits against
    the rules; the converted shard (``lm_state_from_jax(model_rank=)``)
    against the setup's slices."""
    mesh = mesh_of(shape)
    tag = f"{'step' if comp == 'none' else comp}/{arch}/{shape[0]}x{shape[1]}"
    full = lm_state_from_jax(tree(inp, f"jax/{arch}"))
    setup = tstep.make_train_setup(config(arch), AdamWConfig(**OPT),
                                   mesh=mesh, device="cpu",
                                   grad_compression=comp)
    load_whole(setup, full)
    rank_m = mesh.get_local_rank(1)
    shard = lm_state_from_jax(tree(inp, f"jax/{arch}"),
                              n_model_shards=shape[1], model_rank=rank_m)
    bad = []
    for n, t in setup.state["params"].items():
        want = list(full[n].shape)
        for dim, parts, _ in placement_parts(
                setup.state_placements.get(f"params/{n}")):
            want[dim] //= parts
        if list(t.shape) != want:
            bad.append((n, list(t.shape), want))
    # The model axis splits the leaves the rules split over it.
    rules = {n: d[0] for n, s in setup.param_specs.items()
             if (d := sharded_dim(s, "model")) is not None}
    split = {n: pl[0] for n, pl in setup.model.tp_placements.items()}
    if rules != split:
        bad.append(("model axis", sorted(set(rules.items())
                                         ^ set(split.items()))))
    # The converted shard is the setup's model-local slice.
    for n, t in whole_state(setup, axes=("data",)).items():
        if not torch.equal(t, shard[n]):
            bad.append((n, "converted shard"))
    n_model = sum(1 for n in setup.state["params"] if sharded_dim(
        setup.param_specs[n], "model"))
    i, n_data = _data_index(mesh), shape[0]
    rows = inp[f"batch/{arch}/tokens"].shape[0] // n_data
    _, m = setup.train_step(setup.state, batch_of(inp, f"batch/{arch}",
                                                  i * rows, (i + 1) * rows))
    out[f"{tag}/loss"] = float(m["loss"])
    out[f"{tag}/grad_norm"] = float(m["grad_norm"])
    for n, t in whole_state(setup).items():
        out[f"{tag}/p/{n}"] = t.numpy()
    if comp == "int8_ef":
        for n, t in whole_state(setup, "errors").items():
            out[f"{tag}/e/{n}"] = t.numpy()
    out[f"{tag}/meta"] = json.dumps({
        "bad": bad, "n_model_sharded": n_model,
        "n_params": len(setup.state["params"]),
        "vocab_parallel": setup.model.tp is not None})


def moe_case(inp, out, name, arch, m, changes):
    """Loss, aux and gradients of the MoE model over a model axis of m
    (the reference's weights at n_model_shards=m, converted whole, then
    sharded), gathered."""
    mesh = mesh_of((1, m))
    cfg = config(arch, n_model_shards=m, **changes)
    model = lm.LM(cfg, device="meta")
    model.load_state_dict(lm_state_from_jax(tree(inp, f"jax/{name}")),
                          assign=True)
    dp = DataParallel(model, mesh).shard()
    placements = dp.placements()
    assert not dp.fsdp
    loss, metrics = lm.lm_loss(model, batch_of(inp, f"batch/{name}"),
                               ctx=lm.Ctx(mesh=mesh))
    loss.backward()
    out[f"moe/{name}/loss"] = float(loss.detach())
    out[f"moe/{name}/aux"] = float(metrics["aux"].detach())
    for n, p in model.named_parameters():
        out[f"moe/{name}/g/{n}"] = gather(p.grad, placements.get(n),
                                          dp.specs[n], mesh).numpy()


def ce_case(inp, out, m):
    """The vocab-parallel loss and its gradient, with and without a
    mask, over m ranks."""
    axis = ModelAxis.of(mesh_of((1, m)))
    logits = torch.from_numpy(inp["ce/logits"])
    v = logits.shape[-1] // m
    for masked in (False, True):
        part = logits[..., axis.rank * v:(axis.rank + 1) * v].clone() \
            .requires_grad_()
        mask = torch.from_numpy(inp["ce/mask"]) if masked else None
        loss = axis.cross_entropy(part, torch.from_numpy(inp["ce/labels"]),
                                  mask)
        loss.backward()
        out[f"ce/{m}/{masked}/loss"] = float(loss.detach())
        out[f"ce/{m}/{masked}/grad"] = axis.all_gather(part.grad, -1).numpy()
    tokens = torch.from_numpy(inp["ce/labels"])
    table = torch.from_numpy(inp["ce/table"])
    vt = table.shape[0] // m
    rows = axis.reduce(axis.embed(table[axis.rank * vt:(axis.rank + 1) * vt],
                                  tokens))
    out[f"ce/{m}/embed_equal"] = bool(torch.equal(rows, table[tokens.long()]))


def _bits_agree(t, axis) -> bool:
    """Whether every rank of ``axis`` holds ``t``'s bits (and shape: the
    gather needs one shape on every rank)."""
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return all(torch.equal(p, t) for p in parts)


def caches_agree(caches, axis, enc_kv=()) -> bool:
    """Whether every rank of ``axis`` holds each cache leaf at one shape,
    and the bits of each leaf the axis keeps whole and of ``enc_kv``."""
    ok = all(_bits_agree(t, axis) for t in enc_kv)
    for sub in caches.values():
        for n, t in sub.items():
            ok &= _bits_agree(t, axis) or n in SPLIT_LEAVES
    return bool(ok)


def serve_case(inp, out, name, arch, changes):
    """``lm_prefill`` of the prompt, then ``DECODE_STEPS`` decode steps of
    the given tokens, on (data 1, model M) from the reference's weights at
    n_model_shards=1 (re-laid for M where the model has a MoE): every
    logit (gathered over the vocabulary by the entry points), this rank's
    cache shapes, each KV cache gathered whole along its split dim, the
    recurrent kinds' cache leaves (whole on every rank), whether every
    rank holds the same whole leaves after the prefill and each decode
    step (and of whisper's ``enc_kv`` from ``lm_encode``, recorded), and
    the exception with which ``lm_prefill_chunk`` and the engine refuse
    the sharded model.  The VL prompt's first ``VISION`` positions are
    vision embeddings."""
    from repro_torch.serve.engine import ServeEngine

    m = dist.get_world_size()
    mesh = mesh_of((1, m))
    moe = arch == "grok-1-314b"
    cfg = config(arch, n_model_shards=m if moe else 1, **changes)
    model = lm.LM(cfg, device="meta")
    model.load_state_dict(lm_state_from_jax(
        tree(inp, f"jax/serve_{name}"), n_model_shards=m if moe else None),
        assign=True)
    shard_model(model, mesh)
    ctx = lm.Ctx(mesh=mesh)
    tokens = torch.from_numpy(inp[f"serve/{name}/tokens"]).long()
    tag = f"serve/{name}"
    axis = model.model_axis
    extra = {k: torch.from_numpy(inp[f"serve/{name}/{k}"]) for k in EXTRA
             if f"serve/{name}/{k}" in inp}
    with torch.no_grad():
        enc_kv = None
        if "enc_frames" in extra:
            enc_kv = lm.lm_encode(model, extra["enc_frames"])
            for n, t in zip("kv", enc_kv):
                out[f"{tag}/enc_kv/{n}"] = t.numpy()
        logits, caches = lm.lm_prefill(
            model, tokens[:, :PROMPT], MAX_LEN, ctx=ctx, enc_kv=enc_kv,
            vision_embeds=extra.get("vision_embeds"))
        agree = [caches_agree(caches, axis, enc_kv or ())]
        out[f"{tag}/prefill"] = logits.numpy()
        out[f"{tag}/shapes"] = json.dumps({
            k: {n: list(v.shape) for n, v in sub.items()}
            for k, sub in caches.items()})
        for i in range(DECODE_STEPS):
            logits, caches = lm.lm_decode_step(
                model, tokens[:, PROMPT + i:PROMPT + i + 1], caches, ctx=ctx,
                enc_kv=enc_kv)
            agree.append(caches_agree(caches, axis, enc_kv or ()))
            out[f"{tag}/decode{i}"] = logits.numpy()
    out[f"{tag}/agree"] = json.dumps(agree)
    for key, sub in caches.items():
        for n in ("k", "v"):
            if n in sub:
                t = sub[n]
                dim = -2 if t.shape[-2] < cfg.n_kv_heads else -3
                out[f"{tag}/cache/{key}/{n}"] = axis.all_gather(t, dim) \
                    .numpy()
        if key.endswith(("_mamba", "_mlstm", "_slstm")):
            for n, t in sub.items():
                out[f"{tag}/cache/{key}/{n}"] = t.numpy()
    refused = {}
    for what, call in (
            ("chunk", lambda: lm.lm_prefill_chunk(
                model, tokens[:, :4], caches, 0, ctx=ctx)),
            ("engine", lambda: ServeEngine(model, max_len=MAX_LEN))):
        try:
            call()
        except (NotImplementedError, ValueError) as exc:
            refused[what] = type(exc).__name__
    out[f"{tag}/refused"] = json.dumps(refused)


def checkpoint_case(inp, out, rank):
    """A state saved on (data 1, model 2) after a step, then restored on
    (data 2, model 1) and gathered."""
    arch = "qwen2-1.5b-gspn"
    d = pathlib.Path(sys.argv[3]) / "ck_tp"
    setup = tstep.make_train_setup(config(arch), AdamWConfig(**OPT),
                                   mesh=mesh_of((1, 2)), device="cpu",
                                   seed=3)
    setup.train_step(setup.state, batch_of(inp, f"batch/{arch}"))
    ck = CheckpointManager(str(d), host_id=rank, n_hosts=2)
    ck.save(1, setup.state, placements=setup.state_placements,
            skip=setup.state_skip)
    ck.wait()
    for key in ("params",):
        for n, t in whole_state(setup, key).items():
            out[f"ck/saved/{key}/{n}"] = t.numpy()
    for mom in ("m", "v"):
        for n, t in setup.state["opt"][mom].items():
            out[f"ck/saved/opt/{mom}/{n}"] = gather(
                t, setup.state_placements.get(f"opt/{mom}/{n}"),
                setup.param_specs[n], setup.mesh).numpy()
    other = tstep.make_train_setup(config(arch), AdamWConfig(**OPT),
                                   mesh=mesh_of((2, 1)), device="cpu",
                                   seed=5)
    _, step = CheckpointManager(str(d), host_id=rank, n_hosts=2).restore(
        target=other.state, placements=other.state_placements)
    out["ck/restored/step"] = step
    for n, t in whole_state(other).items():
        out[f"ck/restored/params/{n}"] = t.numpy()
    for mom in ("m", "v"):
        for n, t in other.state["opt"][mom].items():
            out[f"ck/restored/opt/{mom}/{n}"] = gather(
                t, other.state_placements.get(f"opt/{mom}/{n}"),
                other.param_specs[n], other.mesh).numpy()


def main():
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    inp = dict(np.load(sys.argv[1]))
    init_distributed(torch.device("cpu"))
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for arch, shape in STEPS[world]:
        step_case(inp, out, arch, shape)
    for arch, shape in INT8[world]:
        step_case(inp, out, arch, shape, "int8_ef")
    for case in MOE[world]:
        moe_case(inp, out, *case)
    ce_case(inp, out, world)
    for case in SERVE.get(world, ()):
        serve_case(inp, out, *case)
    if world == 2:
        checkpoint_case(inp, out, rank)
    if rank == 0:
        np.savez(sys.argv[2], **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
