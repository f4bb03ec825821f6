"""The mixture-of-experts layer, the port of ``repro.models.moe``.

The experts' weights keep the reference's per-shard slab layout
``(M, E_loc, D, F_loc)`` (``gate_slab``, ``up_slab``; ``down_slab`` is
``(M, E_loc, F_loc, D)``), M = ``n_shards``, so converted parameters map
one to one: slab ``m`` holds experts ``(m // tp) · E_loc`` onwards, and
of each the hidden slice ``m % tp``.  With M = 1 a call runs the
reference's single-shard body:

* ``route``: f32 router logits from compute-dtype operands (a hand VJP
  whose backward contracts in the compute dtype, :class:`_RouterMatmul`),
  softmax, the top-k experts of each token (the lower index first among
  equal probabilities, as ``jax.lax.top_k``), their gates renormalised,
  and the Switch auxiliary loss ``E · Σ(frac_tokens · frac_probs)`` over
  the top-1 choices;
* dispatch: each (token, slot) pair ranked within its expert in
  token-major order (a stable argsort); the first ``cap`` pairs of an
  expert keep a row of its ``(E, cap, D)`` capacity buffer, the rest are
  dropped, with ``cap = ceil(k · t / E · capacity_factor)`` over the t
  tokens of the call (:func:`capacity`);
* the experts: a batched SwiGLU over the buffer in the compute dtype;
* combine: each kept pair's row gathered back (0 for a dropped one),
  times its gate in the compute dtype, summed over the k slots.

The buffer is dense: every expert's product runs over all ``cap`` rows
whatever the tokens chose, as in the reference.  The optional shared
expert (a :class:`~repro_torch.models.layers.SwiGLU` under ``shared``)
reads the layer's input and adds to the routed output.

With M > 1 the layer runs the reference's sharded branch (its
``shard_map`` body) over a model axis of M ranks (``tp``,
``parallel.tensor_parallel``), each holding slab ``m`` = its rank: every
rank routes its data-local tokens with the replicated router (the same
gates, ranks and capacity on each), keeps the slots whose expert lies in
its group ``m // tp``, runs its slab over them, and one all-reduce SUM
over the axis assembles the output; the aux loss is the ranks' mean.
Without that axis an M > 1 layer raises: the reference then runs shard
0's slab alone, a wrong output.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (DTypePolicy, SwiGLU, dense_init,
                                       trunc_normal)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``: ``d_ff`` is each expert's hidden
    width, ``n_shards`` the model-axis size M over which ``ep = min(E, M)``
    expert groups and ``tp = M // ep`` hidden-width splits lay out the
    slabs."""
    dim: int
    n_experts: int
    top_k: int
    d_ff: int
    n_shards: int = 1
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0      # 0 = no shared expert
    renorm_gates: bool = True
    aux_loss_coef: float = 0.01

    @property
    def ep(self) -> int:
        return min(self.n_experts, self.n_shards)

    @property
    def tp(self) -> int:
        assert self.n_shards % self.ep == 0, (self.n_shards, self.n_experts)
        return self.n_shards // self.ep

    @property
    def e_loc(self) -> int:
        assert self.n_experts % self.ep == 0
        return self.n_experts // self.ep

    @property
    def f_loc(self) -> int:
        assert self.d_ff % self.tp == 0
        return self.d_ff // self.tp


def capacity(cfg: MoEConfig, t: int) -> int:
    """Rows of each expert's buffer in a call over ``t`` tokens: the
    reference's expression, in its order, at least 1.  The float product
    at an exact integer decides whether a pair is dropped."""
    return max(int(math.ceil(cfg.top_k * t / cfg.n_experts
                             * cfg.capacity_factor)), 1)


class _RouterMatmul(torch.autograd.Function):
    """The reference's ``_router_matmul``: f32 logits of x (T, D) against
    the router cast to x's dtype (products of bf16 values are exact in
    f32, so ``x.float() @ w.float()`` gives the f32-accumulated product);
    the backward casts the logits' cotangent to x's dtype before both
    contractions, and dw returns in the router's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w.to(x.dtype).float()

    @staticmethod
    def backward(ctx, dlogits):
        x, w = ctx.saved_tensors
        dl = dlogits.to(x.dtype)
        return dl @ w.to(x.dtype).T, (x.T @ dl).to(w.dtype)


def route(x, router, cfg: MoEConfig):
    """x (T, D) -> (gates (T, k) f32, experts (T, k) int64, the aux loss
    before ``aux_loss_coef``).  Among equal probabilities the lower expert
    index comes first (a stable descending sort), as ``jax.lax.top_k``
    orders them; the order of the k slots sets the ranking and the aux
    loss's top-1."""
    probs = torch.softmax(_RouterMatmul.apply(x, router), dim=-1)
    top_v, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[:, :cfg.top_k], top_i[:, :cfg.top_k]
    if cfg.renorm_gates:
        top_v = top_v / top_v.sum(-1, keepdim=True).clamp_min(1e-9)
    frac_tokens = F.one_hot(top_i[:, 0], cfg.n_experts).float().mean(0)
    aux = cfg.n_experts * (frac_tokens * probs.mean(0)).sum()
    return top_v, top_i, aux


def dispatch(experts, cap: int, n_experts: int):
    """(each (token, slot) pair's row in the flat (E · cap) buffer, kept)
    for experts (T, k): a pair's rank within its expert follows the
    token-major order of the flattened pairs (a stable argsort, then the
    position minus the expert's start), and the first ``cap`` pairs of an
    expert keep their rows.  A dropped pair points at row E · cap, one
    past the buffer."""
    eflat = experts.reshape(-1)
    order = torch.argsort(eflat, stable=True)
    # bincount's output length depends on the data; this has n_experts
    # entries on any device, ``meta`` included.
    counts = torch.zeros(n_experts, dtype=eflat.dtype,
                         device=eflat.device).index_add_(
        0, eflat, torch.ones_like(eflat))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(eflat)
    rank[order] = torch.arange(eflat.numel(), device=eflat.device) \
        - starts[eflat[order]]
    kept = rank < cap
    return torch.where(kept, eflat * cap + rank, n_experts * cap), kept


class MoE(nn.Module):
    """The layer's parameters in the reference's names (``router`` (D, E)
    in f32 under every policy, the three slabs in ``param_dtype``,
    ``shared``), its single-shard call and, over a model axis (``tp``),
    its sharded branch.  A call with ``n_shards`` > 1 and no model axis
    of that extent raises: the reference then runs shard 0's slab alone,
    a wrong output.

    The slabs are drawn one expert at a time on the generator's device
    (truncated normal times 1/√D, the down slab times 1/√d_ff), so a
    full-width layer never holds an f32 copy of a whole slab."""

    tp = None

    def __init__(self, cfg: MoEConfig, policy: DTypePolicy, *, generator,
                 device):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        m, el, fl, d = cfg.n_shards, cfg.e_loc, cfg.f_loc, cfg.dim
        self.router = dense_init(d, cfg.n_experts, generator, device,
                                 torch.float32)
        pd = policy.param_dtype
        self.gate_slab = _slab((m, el, d, fl), 1 / math.sqrt(d), generator,
                               device, pd)
        self.up_slab = _slab((m, el, d, fl), 1 / math.sqrt(d), generator,
                             device, pd)
        self.down_slab = _slab((m, el, fl, d), 1 / math.sqrt(cfg.d_ff),
                               generator, device, pd)
        if cfg.shared_expert_ff:
            self.shared = SwiGLU(d, cfg.shared_expert_ff, policy,
                                 generator=generator, device=device)

    def forward(self, x):
        """x (B, S, D) -> (y (B, S, D) in x's dtype, the aux loss times
        ``aux_loss_coef``), over the B · S tokens of the call."""
        cfg, cd, tp = self.cfg, self.policy.compute_dtype, self.tp
        if cfg.n_shards > 1 and (tp is None or tp.size != cfg.n_shards):
            raise NotImplementedError(
                f"an attn_moe layer over n_model_shards={cfg.n_shards} runs "
                f"its slabs over a model axis of {cfg.n_shards} ranks "
                f"(parallel.tensor_parallel.shard_model); without one the "
                f"reference runs shard 0's slab alone (ROADMAP.md §1 item "
                f"6.2)")
        b, s, d = x.shape
        x2d = x.reshape(-1, d)
        router = self.router
        if tp is not None:
            # Each rank's experts take a part of the routed output: the
            # gradients of the tokens and the router sum over the axis.
            x2d, router = tp.copy(x2d), tp.copy(router)
        t, k, e = x2d.shape[0], cfg.top_k, cfg.n_experts
        cap = capacity(cfg, t)
        gates, experts, aux = route(x2d, router, cfg)
        row, kept = dispatch(experts, cap, e)
        if tp is not None:
            # This rank's group of experts: rows of its (E_loc, cap)
            # buffer, every other slot dropped here.
            e, lo = cfg.e_loc, tp.rank // cfg.tp * cfg.e_loc
            eflat = experts.reshape(-1)
            kept = kept & (eflat >= lo) & (eflat < lo + e)
            row = torch.where(kept, row - lo * cap, e * cap)

        xc = x2d.to(cd)
        tok = torch.arange(t, device=x.device).repeat_interleave(k)
        buf = xc.new_zeros((e * cap + 1, d)).index_copy(0, row, xc[tok])
        buf = buf[:e * cap].view(e, cap, d)
        h = F.silu(torch.bmm(buf, self.gate_slab[0].to(cd))) \
            * torch.bmm(buf, self.up_slab[0].to(cd))
        # Without autograd the buffer's block, one row larger than ``out``,
        # is free for it: at cap = t a kimi buffer holds 11.4 GB.
        del buf
        out = torch.bmm(h, self.down_slab[0].to(cd)).view(e * cap, d)

        slots = torch.where(kept[:, None], out[row.clamp(max=e * cap - 1)],
                            0.0)
        y = (slots * gates.reshape(-1, 1).to(cd)).view(t, k, d).sum(1)
        y = y.view(b, s, d).to(x.dtype)
        if tp is not None:
            y, aux = tp.reduce(y), tp.mean(aux)
        if cfg.shared_expert_ff:
            y = y + self.shared(x)
        return y, aux * cfg.aux_loss_coef


def moe_per_expert(moe: MoE, x):
    """The plain version of ``moe(x)``'s output, a loop over the experts
    that the checks hold the layer against: the same routing, then for
    each expert the pairs that chose it in token-major order, the first
    ``cap`` of them kept, their tokens through the expert's SwiGLU in the
    compute dtype, times their gates, added into their tokens' rows in
    f32; the sum cast to the compute dtype, then the shared expert added.
    Returns (y in x's dtype, the dropped pairs, the pairs)."""
    cfg, cd = moe.cfg, moe.policy.compute_dtype
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t, k = x2d.shape[0], cfg.top_k
    cap = capacity(cfg, t)
    probs = torch.softmax(x2d.float() @ moe.router.to(x2d.dtype).float(), -1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    if cfg.renorm_gates:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    dropped = 0
    for e in range(cfg.n_experts):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        dropped += max(tok.numel() - cap, 0)
        tok, slot = tok[:cap], slot[:cap]
        xe = x2d[tok].to(cd)
        h = F.silu(xe @ moe.gate_slab[0, e].to(cd)) \
            * (xe @ moe.up_slab[0, e].to(cd))
        ye = (h @ moe.down_slab[0, e].to(cd)) * gates[tok, slot, None].to(cd)
        y.index_add_(0, tok, ye.float())
    y = y.to(cd).view(b, s, d).to(x.dtype)
    if cfg.shared_expert_ff:
        y = y + moe.shared(x)
    return y, dropped, t * k


def _slab(shape, scale, generator, device, dtype) -> nn.Parameter:
    """A (M, E_loc, a, b) slab, truncated normal times ``scale``, drawn
    one (a, b) expert matrix at a time; left empty on the meta device."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, device="meta", dtype=dtype))
    p = torch.empty(shape, device=device, dtype=dtype)
    draw = trunc_normal(scale)
    for m in range(shape[0]):
        for i in range(shape[1]):
            p[m, i] = draw(shape[2:], generator)
    return nn.Parameter(p)


def moe_param_count(cfg: MoEConfig) -> int:
    n = cfg.dim * cfg.n_experts
    n += 3 * cfg.n_experts * cfg.dim * cfg.d_ff
    if cfg.shared_expert_ff:
        n += 3 * cfg.dim * cfg.shared_expert_ff
    return n


def moe_active_param_count(cfg: MoEConfig) -> int:
    """The router, the top-k experts and the shared expert: the 6·N·D
    convention's N of one layer."""
    n = cfg.dim * cfg.n_experts
    n += 3 * cfg.top_k * cfg.dim * cfg.d_ff
    if cfg.shared_expert_ff:
        n += 3 * cfg.dim * cfg.shared_expert_ff
    return n
