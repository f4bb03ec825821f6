"""Pipeline parallelism: the GPipe microbatched stage executor over one
mesh axis, the port of the reference's ``parallel/pipeline.py`` over
``torch.distributed``.

Each rank of the axis holds one *stage* (a contiguous slice of layers).
The schedule runs ``n_micro + n_stages - 1`` ticks; at every tick each
rank runs its stage on one microbatch and passes the result to the next
rank around the ring (a send/recv pair, ``batch_isend_irecv``).  Stage 0
injects microbatch t (zeros after the last), the last stage writes
microbatch ``t - (n_stages - 1)``, and the outputs reach every rank by an
all-reduce of the last stage's masked outputs (the reference's ``psum``).
The bubble is (S - 1) / (M + S - 1).  Forward only, as the reference's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _axis(mesh, axis):
    i = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i)


def pipeline_apply(mesh, axis: str, stage_fn: Callable, stage_params,
                   x_micro, n_micro: int, *, via_host: bool = False):
    """Run a pipeline over mesh axis ``axis``.

    stage_fn(params, x) -> x     one stage's forward
    stage_params: this rank's stage parameters (the reference passes
                  every stage's, stacked along a leading dim sharded
                  over ``axis``; here each rank holds its own slice)
    x_micro: (n_micro, mb, ...) microbatched input, the same on every rank
    Returns the last stage's outputs (n_micro, mb, ...) on every rank.
    ``via_host`` moves each exchange through host memory (gloo between
    ranks that share a card: its send and receive take no CUDA
    tensor).
    """
    if n_micro < 1:
        raise ValueError(f"n_micro must be at least 1, got {n_micro}")
    group, n_stages, stage = _axis(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]
    mb_shape = x_micro.shape[1:]
    buf = torch.zeros(mb_shape, dtype=x_micro.dtype, device=x_micro.device)
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        if stage == 0:
            cur = x_micro[t] if t < n_micro else torch.zeros_like(buf)
        else:
            cur = buf
        out = stage_fn(stage_params, cur)
        idx = t - (n_stages - 1)
        if idx >= 0 and stage == n_stages - 1:
            outputs[idx] = out
        buf = _ring_shift(out, nxt, prv, group, via_host)
    if stage != n_stages - 1:
        outputs.zero_()
    dist.all_reduce(outputs, group=group)
    return outputs


def _ring_shift(out, nxt, prv, group, via_host):
    """``out`` to the next rank, the previous rank's ``out`` back."""
    if dist.get_world_size(group) == 1:
        return out
    staged = via_host and out.device.type != "cpu"
    send = out.cpu() if staged else out.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group)])
    for r in reqs:
        r.wait()
    return recv.to(out.device) if staged else recv
