"""Distributed-optimisation collectives over ``torch.distributed``: int8
error-feedback gradient compression, the port of the reference's
``parallel/collectives.py``, and the counted gathers and reductions of
the data-parallel step.

``compressed_psum_tree`` is the classic error-feedback scheme: each rank
quantises ``g + e`` to int8 with a per-tensor scale shared across the
group (one all-reduce MAX), sums the int8 payloads as int32 (one
all-reduce), divides by the group's size and keeps its quantisation
residual in ``e`` for the next step.  Rounding is half to even, as
``jnp.round``'s.

Where the ranks share a card, NCCL refuses the group and gloo carries
it; gloo moves a CUDA payload through pinned host memory.
:class:`CountedAllGather`, :class:`CountedReduceScatter` (FSDP2's
custom-collective hooks) and :func:`all_reduce_counted` run those
collectives synchronously and count the bytes that pass through host
memory (:data:`staged_bytes`) and their host time
(:data:`staged_seconds`).  The model axis's collectives
(:func:`model_all_reduce`, :func:`model_all_gather`, which
``parallel.tensor_parallel`` runs inside its autograd Functions) are
counted the same way under their own names, ``model_all_reduce`` and
``model_all_gather``, when their payload lies on a card.

Whatever the backend and the device, every counted collective also adds
the bytes it puts on this rank's links to :data:`link_bytes`, under the
reference's op names and ring multipliers (``repro/roofline/hlo.py``):
an all-reduce twice its payload, an all-gather its output, a
reduce-scatter its input.  The roofline's collective term reads them
(``roofline.cost``).  Only a gloo group stages a card's payload through
host memory: under any other backend (``"fake"``, the dry run's, over
``meta`` tensors) a collective runs directly and counts no staged bytes.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

# Bytes of device payloads that the counted collectives move through host
# memory (in and out), and their host-clock seconds, by collective, since
# the last clear_staged().
staged_bytes: collections.Counter = collections.Counter()
staged_seconds: collections.Counter = collections.Counter()
# Bytes on this rank's links by the reference's op name, ring multipliers
# applied, since the last clear_staged().
link_bytes: collections.Counter = collections.Counter()
link_calls: collections.Counter = collections.Counter()
RING = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
        "all-to-all": 1.0, "collective-permute": 1.0}


def clear_staged():
    staged_bytes.clear()
    staged_seconds.clear()
    link_bytes.clear()
    link_calls.clear()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def quantize_int8(x):
    """Per-tensor symmetric int8 quantisation.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def _compress_one(g, e, group):
    gf = g.float() + e
    # A scale shared by every rank (one scalar all-reduce), so the int32
    # sum of the payloads is the exact sum of the quantised values.
    amax = gf.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    # An all-zero gradient on every rank pins the scale to 1/127: q, the
    # sum and the residual are then exact zeros (a denormal floor would
    # amplify by ~1e14 and a zero scale would give NaN).
    scale = torch.where(amax > 0.0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, group=group)
    n = dist.get_world_size(group)
    g_hat = q_sum.float() * scale / n                     # mean gradient
    new_e = gf - q.float() * scale                        # local residual
    return g_hat.to(g.dtype), new_e


def compressed_psum_tree(grads: dict, errors: dict, group=None):
    """int8 error-feedback mean all-reduce over ``group`` of every leaf of
    ``grads`` ({name: tensor}), with residuals ``errors`` (same names,
    f32).  Returns (reduced grads, new errors)."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        out_g[name], out_e[name] = _compress_one(g, errors[name], group)
    return out_g, out_e


def init_error_state(grads: dict) -> dict:
    """f32 zeros beside every gradient (or parameter)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def _group(mesh, axis):
    return mesh.get_group(mesh.mesh_dim_names.index(axis))


def compressed_allreduce(mesh, axis: str):
    """``fn(grads, errors) -> (mean grads, new errors)`` over mesh axis
    ``axis``: each rank passes its local gradients (no leading shard dim,
    which the reference's ``shard_map`` needs) and gets the compressed
    mean and its own residuals."""
    group = _group(mesh, axis)

    def fn(grads, errors):
        return compressed_psum_tree(grads, errors, group)

    return fn


# ---------------------------------------------------------------------------
# Counted collectives for gloo (FSDP2's Comm protocol: allocate + __call__).
# ---------------------------------------------------------------------------

def _count(what, t0, group, op, payload, *tensors):
    """Add ``op``'s link bytes (its ``payload`` times its ring
    multiplier), the card tensors' bytes where gloo carries ``group``
    (it copies each through pinned host memory) and the host seconds
    since ``t0`` to the counters."""
    link_bytes[op] += RING[op] * payload
    link_calls[op] += 1
    if dist.get_backend(group) == "gloo":
        staged_bytes[what] += sum(_nbytes(t) for t in tensors if t.is_cuda)
    staged_seconds[what] += time.perf_counter() - t0


class _Counted:
    def allocate(self, size, *, dtype, device):
        return torch.empty(size, dtype=dtype, device=device)


class CountedAllGather(_Counted):
    """``all_gather_into_tensor``, synchronous, with its bytes through
    host memory and its host time counted."""

    def __call__(self, output_tensor, input_tensor, group, async_op=False):
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(output_tensor, input_tensor, group=group)
        _count("all_gather", t0, group, "all-gather", _nbytes(output_tensor),
               input_tensor, output_tensor)
        return None


class CountedReduceScatter(_Counted):
    """``reduce_scatter_tensor``, as :class:`CountedAllGather`."""

    def __call__(self, output_tensor, input_tensor, group, op,
                 async_op=False):
        t0 = time.perf_counter()
        dist.reduce_scatter_tensor(output_tensor, input_tensor, op=op,
                                   group=group)
        _count("reduce_scatter", t0, group, "reduce-scatter",
               _nbytes(input_tensor), input_tensor, output_tensor)
        return None


def all_reduce_counted(t, group=None, op=dist.ReduceOp.SUM,
                       what: str = "all_reduce"):
    """``all_reduce`` of ``t`` in place, counted as the classes above."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    _count(what, t0, group, "all-reduce", _nbytes(t), t, t)
    return t


# ---------------------------------------------------------------------------
# The model axis's collectives (tensor parallelism).
# ---------------------------------------------------------------------------

def model_all_reduce(t, group, op=dist.ReduceOp.SUM):
    """``all_reduce`` of ``t`` in place over the model-axis ``group``
    (SUM or MAX), counted as ``model_all_reduce``."""
    return all_reduce_counted(t, group, op, "model_all_reduce")


def model_all_gather(t, group, dim: int):
    """The ``group``'s pieces of ``t`` concatenated along ``dim`` in rank
    order (every piece of ``t``'s shape), counted as
    ``model_all_gather``."""
    t0 = time.perf_counter()
    t = t.contiguous()
    pieces = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(pieces, t, group=group)
    out = torch.cat(pieces, dim=dim)
    _count("model_all_gather", t0, group, "all-gather", _nbytes(out), t, out)
    return out
