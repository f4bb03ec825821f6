"""Grouped-query attention with a blockwise (flash-style) softmax and a
KV-cache decode, the port of ``repro.models.attention``.

Four functions, each the reference's twin:

* :func:`full_attention`, the materialised attention (short sequences);
* :func:`chunked_attention`, the online softmax over key blocks with the
  reference's recomputing two-sweep adjoint (memory O(S·block) in both
  directions), used when the keys outnumber ``block_k``;
* :func:`chunk_prefill_attention`, a prompt chunk at an offset against
  the padded KV cache that already holds it;
* :func:`decode_attention`, one query per sequence against the cache,
  masked to each sequence's length.

GQA layout: q (B, S, Hq, D), k and v (B, S, Hkv, D), Hq = G·Hkv.  q is
reshaped to (B, S, Hkv, G, D), so query head h reads kv head h // G (a
``repeat`` of k and v would pair it with h % Hkv).  Every product and the
softmax run in f32 whatever the inputs' dtype, as in the reference; the
dense paths divide the logits by √D after the product, the blockwise,
chunk and decode paths divide q before it.  The products are plain
``matmul``/``einsum``: the reference has no Pallas kernel for attention.
The dense and blockwise paths are causal unless ``causal=False`` (whisper's
encoder and its cross-attention); queries start at position 0: the
reference's ``q_offset`` has no caller outside its own module and is not
ported.

With tracing on (``obs.enable()``) each call enters an ``attention.*``
span, which is a ``torch.profiler.record_function`` range: a profile
reads attention's device time from the spans (``attention.blockwise``
and ``attention.blockwise_bwd`` in training; ``attention.chunk`` and
``attention.decode`` in serving; the dense path's backward runs in
autograd, outside its span).

:class:`Attention` is the layer (``init_attention``, ``_project_qkv``,
``_apply_positions``, ``apply_attention`` and ``apply_attention_decode``
of the reference), with rope or M-RoPE on q and k, and cross-attention
over pre-projected keys and values; :func:`init_kv_cache` its cache.
"""

from __future__ import annotations

import dataclasses
import math
import torch
from torch import nn

from repro_torch import obs
from repro_torch.models.layers import (DTypePolicy, apply_mrope, apply_rope,
                                       dense_init, new_param, zeros)

NEG_INF = -1e30


def _group_q(q, hkv: int):
    b, s, hq, d = q.shape
    return q.reshape(b, s, hkv, hq // hkv, d)


def full_attention(q, k, v, *, causal: bool = True):
    """Reference attention.  q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D);
    query i sees key j iff j <= i, or every key when not ``causal``."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    with obs.trace("attention.dense"):
        qg = _group_q(q, hkv).float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              k.float()) / math.sqrt(d)
        if causal:
            iq = torch.arange(sq, device=q.device)[:, None]
            ik = torch.arange(k.shape[1], device=q.device)[None, :]
            logits = torch.where(ik <= iq, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# The blockwise path.  Operands in head-major f32 layouts: q scaled by
# 1/√D as (B, Hkv, G, Sq, D), k and v as (B, Hkv, Sk, D), so each block's
# products are one batched matmul.
# ---------------------------------------------------------------------------

def _heads_q(q, hkv: int):
    """(B, Sq, Hq, D) -> (B, Hkv, G, Sq, D) f32, contiguous."""
    return _group_q(q, hkv).permute(0, 2, 3, 1, 4).float().contiguous()


def _heads_kv(k):
    """(B, Sk, Hkv, D) -> (B, Hkv, Sk, D) f32, contiguous."""
    return k.permute(0, 2, 1, 3).float().contiguous()


def _block_logits(qh, kb, lo: int, iq):
    """Logits (B, Hkv, G, Sq, bk) of the scaled queries at positions iq
    (Sq,) against the key block kb (B, Hkv, bk, D) that starts at key
    ``lo``, causally masked; unmasked when ``iq`` is None."""
    b, hkv, g, sq, d = qh.shape
    bk = kb.shape[2]
    logits = (qh.reshape(b, hkv, g * sq, d) @ kb.transpose(-1, -2)).view(
        b, hkv, g, sq, bk)
    if iq is None:
        return logits
    ik = lo + torch.arange(bk, device=qh.device)
    return torch.where(ik[None, :] <= iq[:, None], logits, NEG_INF)


def _pv(p, vb):
    """p (B, Hkv, G, Sq, bk) @ vb (B, Hkv, bk, D) -> (B, Hkv, G, Sq, D)."""
    b, hkv, g, sq, bk = p.shape
    return (p.reshape(b, hkv, g * sq, bk) @ vb).view(b, hkv, g, sq, -1)


def _query_positions(sq: int, causal: bool, device):
    """The queries' positions for the causal mask, None without one."""
    return torch.arange(sq, device=device) if causal else None


def _fwd_blocks(qh, kh, vh, block_k: int, causal: bool):
    """The online-softmax sweep over key blocks: (unnormalised output,
    running maximum, running sum), (B, Hkv, G, Sq, D) / (B, Hkv, G, Sq)."""
    b, hkv, g, sq, d = qh.shape
    iq = _query_positions(sq, causal, qh.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=qh.device)
    s = torch.zeros((b, hkv, g, sq), device=qh.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=qh.device)
    for lo in range(0, kh.shape[2], block_k):
        logits = _block_logits(qh, kh[:, :, lo:lo + block_k], lo, iq)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        scale = torch.exp(m - m_new)
        s = s * scale + p.sum(-1)
        acc = acc * scale[..., None] + _pv(p, vh[:, :, lo:lo + block_k])
        m = m_new
    return acc, m, s


def _flash_fwd(q, k, v, block_k: int, causal: bool):
    """(output (B, Sq, Hq, D) in q's dtype, log-sum-exp (B, Hkv, G, Sq))."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qh = _heads_q(q, hkv) / math.sqrt(d)
    acc, m, s = _fwd_blocks(qh, _heads_kv(k), _heads_kv(v), block_k, causal)
    out = acc / torch.clamp(s[..., None], min=1e-30)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype), lse


def _flash_bwd(q, k, v, lse, dout, block_k: int, causal: bool):
    """The reference's FlashAttention-2-style adjoint: sweep 1 recomputes
    the output blockwise from (q, k, v, lse) for delta = rowsum(dout ·
    out), sweep 2 recomputes each block's probabilities and accumulates
    dq, dk and dv.  Nothing of size Sq × Sk is kept."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qh = _heads_q(q, hkv) / math.sqrt(d)
    kh, vh = _heads_kv(k), _heads_kv(v)
    do = _heads_q(dout, hkv)                              # (B,Hkv,G,Sq,D)
    iq = _query_positions(sq, causal, q.device)
    g = qh.shape[2]
    blocks = range(0, kh.shape[2], block_k)

    out = torch.zeros_like(qh)
    for lo in blocks:
        p = torch.exp(_block_logits(qh, kh[:, :, lo:lo + block_k], lo, iq)
                      - lse[..., None])
        out = out + _pv(p, vh[:, :, lo:lo + block_k])
    delta = (do * out).sum(-1)                            # (B,Hkv,G,Sq)
    del out

    dq = torch.zeros_like(qh)
    dks, dvs = [], []
    for lo in blocks:
        kb, vb = kh[:, :, lo:lo + block_k], vh[:, :, lo:lo + block_k]
        bk = kb.shape[2]
        p = torch.exp(_block_logits(qh, kb, lo, iq) - lse[..., None])
        p2 = p.reshape(b, hkv, g * sq, bk)
        do2 = do.reshape(b, hkv, g * sq, d)
        dvs.append(p2.transpose(-1, -2) @ do2)            # (B,Hkv,bk,D)
        dp = (do2 @ vb.transpose(-1, -2)).view(b, hkv, g, sq, bk)
        ds = (p * (dp - delta[..., None])).reshape(b, hkv, g * sq, bk)
        # The logits are linear in k with coefficient q/√D, so dk takes
        # the scaled q; dq takes the extra 1/√D after the sweep.
        dks.append(ds.transpose(-1, -2) @ qh.reshape(b, hkv, g * sq, d))
        dq = dq + (ds @ kb).view(b, hkv, g, sq, d)
    dq = (dq / math.sqrt(d)).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attention`` custom VJP: the forward saves
    only (q, k, v, lse), and the backward is :func:`_flash_bwd`; both
    carry the ``causal`` flag."""

    @staticmethod
    def forward(ctx, q, k, v, block_k, causal):
        with obs.trace("attention.blockwise"):
            out, lse = _flash_fwd(q, k, v, block_k, causal)
        ctx.save_for_backward(q, k, v, lse)
        ctx.block_k, ctx.causal = block_k, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        with obs.trace("attention.blockwise_bwd"):
            grads = _flash_bwd(q, k, v, lse, dout, ctx.block_k, ctx.causal)
        return (*grads, None, None)


def chunked_attention(q, k, v, *, causal: bool = True, block_k: int = 512):
    """Flash-style attention, causal unless told otherwise: the
    online-softmax forward over key blocks and the recomputing two-sweep
    backward.  ``block_k`` halves until it divides Sk, as in the
    reference: a 1000-token prompt runs 125 blocks of 8, and whisper's
    1500 frames 375 blocks of 4."""
    sk = k.shape[1]
    while sk % block_k:
        block_k //= 2
    return _FlashAttention.apply(q, k, v, block_k, causal)


def chunk_prefill_attention(q, k_cache, v_cache, q_offset):
    """A T-token prompt chunk at absolute offset ``q_offset`` against the
    padded cache (B, S, Hkv, D) that already holds the chunk's own keys
    and values: key j is visible to query i iff j <= q_offset + i, which
    equals one-shot causal prefill restricted to these T rows.  Dense over
    the cache, like :func:`decode_attention`."""
    b, t, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    with obs.trace("attention.chunk"):
        qg = _group_q(q, hkv).float() / math.sqrt(d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float())
        iq = q_offset + torch.arange(t, device=q.device)
        mask = torch.arange(s, device=q.device)[None, :] <= iq[:, None]
        p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-step decode.  q (B, 1, Hq, D); caches (B, S, Hkv, D);
    ``cache_len`` (B,) or a scalar: the valid entries of each sequence,
    the new token included (the caller has written it)."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    with obs.trace("attention.decode"):
        qg = _group_q(q, hkv).float() / math.sqrt(d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float())
        lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
        valid = torch.arange(s, device=q.device)[None, :] < lens  # (B,S)
        logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def decode_attention_split(q, k_cache, v_cache, cache_len, axis):
    """:func:`decode_attention` over a cache whose positions are split
    over ``axis`` (a ``ModelAxis``): q (B, 1, Hq, D) whole, the caches
    this rank's (B, S/M, Hkv, D) slice, ``cache_len`` (B,) the valid
    entries counted from the slice's start (at most 0: none).  The
    logits' maximum is taken over the axis (all-reduce MAX), then the
    sum of exponentials and the weighted values (all-reduce SUM); a
    slice with no valid entry adds exact zeros."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    with obs.trace("attention.decode"):
        qg = _group_q(q, hkv).float() / math.sqrt(d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float())
        lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
        valid = torch.arange(s, device=q.device)[None, :] < lens  # (B,S)
        logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
        m = axis.max(logits.amax(-1, keepdim=True))
        e = torch.exp(logits - m)
        total = axis.all_reduce(e.sum(-1, keepdim=True))
        out = axis.all_reduce(torch.einsum("bhgqk,bkhd->bqhgd", e,
                                           v_cache.float()))
        out = out / total.permute(0, 3, 1, 2, 4)
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# The layer: projections, rope, attention, output projection.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """The reference's ``AttentionConfig``: rope, or M-RoPE over three
    position planes with ``mrope_sections`` (Qwen2-VL's (16, 24, 24)), and
    ``causal`` (False in whisper's encoder).  Its ``use_chunked`` has one
    value in the port, True."""
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int = 0              # 0 => dim // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple | None = None
    causal: bool = True
    block_k: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads


class Attention(nn.Module):
    """GQA attention with rope or M-RoPE: ``wq``, ``wk``, ``wv``, ``wo``
    (d_in, d_out) and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``.
    Parameters are cast to the policy's compute dtype at use, the input
    too; the output returns in the input's dtype.  As cross-attention
    (``forward``'s ``kv``) the layer reads pre-projected keys and values
    and never uses its own ``wk``, ``wv`` (nor ``bk``, ``bv``): their
    gradients are exact zeros, as in the reference, which projects them
    and throws them away.

    Under a model axis (``tp``, ``parallel.tensor_parallel``) the heads
    are split: ``wo`` is row-parallel, rank r of M holding rows [r·n/M,
    (r+1)·n/M) of its n = Hq·D, and each rank computes the query heads
    those rows read and the kv heads those query heads read (query head h
    reads kv head h // G), from its own columns of ``wq``, ``wk``, ``wv``
    (and the biases) where every rank's heads are its own slice, else
    from the whole leaf gathered (the K/V columns where the kv heads do
    not divide M); the partial outputs are summed over the axis.  The
    training forward, the cross-attention (:meth:`_cross_tp`, over the
    whole ``kv`` on every rank), the prefill (:meth:`prefill_tp`) and the
    decode step run sharded, the caches split as :func:`kv_split` says."""

    tp = None

    def __init__(self, cfg: AttentionConfig, policy: DTypePolicy, *,
                 generator, device):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        hd, pd = cfg.hd, policy.param_dtype
        kw = dict(generator=generator, device=device, dtype=pd)
        self.wq = dense_init(cfg.dim, cfg.n_heads * hd, **kw)
        self.wk = dense_init(cfg.dim, cfg.n_kv_heads * hd, **kw)
        self.wv = dense_init(cfg.dim, cfg.n_kv_heads * hd, **kw)
        self.wo = dense_init(cfg.n_heads * hd, cfg.dim, **kw)
        if cfg.qkv_bias:
            for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
                setattr(self, name, new_param((n * hd,), zeros, None,
                                              device, pd))

    def _project(self, xc, w, bias, heads):
        """xc @ w (+ bias) as (B, S, heads, D), xc already cast."""
        cast = self.policy.cast
        y = xc @ cast(w)
        if self.cfg.qkv_bias:
            y = y + cast(bias)
        return y.reshape(*xc.shape[:2], heads, self.cfg.hd)

    def project_q(self, x):
        """q (B, S, Hq, D) in the compute dtype."""
        return self._project(self.policy.cast(x), self.wq,
                             getattr(self, "bq", None), self.cfg.n_heads)

    def project_qkv(self, x):
        """q (B, S, Hq, D), k and v (B, S, Hkv, D) in the compute dtype."""
        cfg = self.cfg
        xc = self.policy.cast(x)
        q = self._project(xc, self.wq, getattr(self, "bq", None),
                          cfg.n_heads)
        k = self._project(xc, self.wk, getattr(self, "bk", None),
                          cfg.n_kv_heads)
        v = self._project(xc, self.wv, getattr(self, "bv", None),
                          cfg.n_kv_heads)
        return q, k, v

    def apply_positions(self, q, k, positions):
        """The reference's ``_apply_positions``: nothing without positions;
        with ``mrope_sections``, M-RoPE at positions (3, B, S), where ids
        (B, S) stand for three equal planes; else rope at (B, S)."""
        cfg = self.cfg
        if positions is None:
            return q, k
        if cfg.mrope_sections is not None:
            if positions.ndim == 2:
                positions = positions[None].expand(3, *positions.shape)
            return tuple(apply_mrope(t, positions, cfg.mrope_sections,
                                     cfg.rope_theta) for t in (q, k))
        return tuple(apply_rope(t, positions, cfg.rope_theta) for t in (q, k))

    def attend(self, q, k, v, causal: bool | None = None):
        """Attention over the whole sequence, causal as the config says
        unless ``causal`` is given: blockwise when the keys outnumber
        ``block_k``, else dense."""
        causal = self.cfg.causal if causal is None else causal
        if k.shape[1] > self.cfg.block_k:
            return chunked_attention(q, k, v, causal=causal,
                                     block_k=self.cfg.block_k)
        return full_attention(q, k, v, causal=causal)

    def project_out(self, out, dtype):
        """(B, S, Hq, D) -> (B, S, dim) through ``wo``, in ``dtype``."""
        cast = self.policy.cast
        b, s = out.shape[:2]
        out = out.reshape(b, s, self.cfg.n_heads * self.cfg.hd)
        return (cast(out) @ cast(self.wo)).to(dtype)

    def forward(self, x, positions=None, kv=None):
        """Training / prefill forward of x (B, S, dim) at ``positions``
        ((B, S), or (3, B, S) under M-RoPE; None: no positions).  With
        ``kv``, pre-projected (k, v) (B, T, Hkv, D), it is
        cross-attention: only q is projected, nothing is rotated, and
        every query sees every key (the reference's ``causal and kv is
        None``)."""
        if kv is not None:
            k, v = kv
            if self.tp is not None:
                return self._cross_tp(x, k, v)
            return self.project_out(self.attend(self.project_q(x), k, v,
                                                 causal=False), x.dtype)
        if self.tp is not None:
            return self._forward_tp(x, positions)
        q, k, v = self.project_qkv(x)
        q, k = self.apply_positions(q, k, positions)
        return self.project_out(self.attend(q, k, v), x.dtype)

    def _tp_plan(self):
        """Every rank's (query heads [h0, h1), kv heads [k0, k1), its rows
        [c0, c1) of ``wo``) under the model axis."""
        cfg, m = self.cfg, self.tp.size
        hd, g = cfg.hd, cfg.n_heads // cfg.n_kv_heads
        per = cfg.n_heads * hd // m
        plan = []
        for r in range(m):
            c0, c1 = r * per, (r + 1) * per
            h0, h1 = c0 // hd, -(-c1 // hd)
            plan.append(((h0, h1), (h0 // g, (h1 - 1) // g + 1), (c0, c1)))
        return plan

    def _tp_project(self, xc, w, bias, ranges):
        """xc @ the columns ``ranges[rank]`` (head ranges, every rank's) of
        ``w`` (+ the bias's) as (B, S, heads, D), through ``tp.pick``."""
        cfg, cast, hd = self.cfg, self.policy.cast, self.cfg.hd
        cols = [[(a * hd, z * hd)] for a, z in ranges]
        y = xc @ cast(self.tp.pick(self, w, cols))
        if cfg.qkv_bias:
            y = y + cast(self.tp.pick(self, bias, cols))
        return y.reshape(*xc.shape[:2], -1, hd)

    def _tp_all_heads(self, xc, w, bias, heads: int):
        """xc @ the whole of ``w`` (+ the bias) as (B, S, heads, D) without
        gathering the weight: each rank's columns of it, the outputs then
        gathered over the axis (where the rules store ``w`` whole, the
        product itself)."""
        cfg, cast, tp = self.cfg, self.policy.cast, self.tp
        y = xc @ cast(getattr(self, w))
        if cfg.qkv_bias:
            y = y + cast(getattr(self, bias))
        if w in self._tp_dims:
            y = tp.all_gather(y, -1)
        return y.reshape(*xc.shape[:2], heads, cfg.hd)

    def _tp_kv_of_q(self, k, v, lo: int):
        """k, v over kv heads from ``lo`` beside this rank's query heads:
        as they are where the query heads read them evenly, else one kv
        head beside each query head."""
        g = self.cfg.n_heads // self.cfg.n_kv_heads
        (h0, h1), (k0, k1), _ = self._tp_plan()[self.tp.rank]
        if (h0 % g == 0 and h1 % g == 0) or k1 - k0 == 1:
            return k[:, :, k0 - lo:k1 - lo], v[:, :, k0 - lo:k1 - lo]
        idx = torch.tensor([h // g - lo for h in range(h0, h1)],
                           device=k.device)
        return k[:, :, idx], v[:, :, idx]

    def _tp_out(self, out, dtype, h0: int = 0):
        """This rank's rows of ``wo`` over ``out`` (B, S, heads from
        ``h0``, D), summed over the axis, in ``dtype``."""
        cast, hd = self.policy.cast, self.cfg.hd
        _, _, (c0, c1) = self._tp_plan()[self.tp.rank]
        b, s = out.shape[:2]
        out = out.reshape(b, s, -1)[..., c0 - h0 * hd:c1 - h0 * hd]
        return self.tp.reduce(cast(out) @ cast(self.wo)).to(dtype)

    def _forward_tp(self, x, positions):
        tp, cast = self.tp, self.policy.cast
        plan = self._tp_plan()
        h0 = plan[tp.rank][0][0]
        xc = tp.copy(cast(x))
        q = self._tp_project(xc, "wq", "bq", [p[0] for p in plan])
        k = self._tp_project(xc, "wk", "bk", [p[1] for p in plan])
        v = self._tp_project(xc, "wv", "bv", [p[1] for p in plan])
        q, k = self.apply_positions(q, k, positions)
        k, v = self._tp_kv_of_q(k, v, plan[tp.rank][1][0])
        return self._tp_out(self.attend(q, k, v), x.dtype, h0)

    def _cross_tp(self, x, k, v):
        """Cross-attention under the model axis over the whole pre-projected
        k, v (B, T, Hkv, D), equal on every rank: this rank's query heads,
        the kv heads they read cut from k and v, no positions and no
        mask, its rows of ``wo`` summed over the axis."""
        tp, cast = self.tp, self.policy.cast
        plan = self._tp_plan()
        q = self._tp_project(tp.copy(cast(x)), "wq", "bq",
                             [p[0] for p in plan])
        k, v = self._tp_kv_of_q(k, v, 0)
        return self._tp_out(self.attend(q, k, v, causal=False), x.dtype,
                            plan[tp.rank][0][0])

    def prefill_tp(self, x, positions, max_len: int, dtype):
        """The prefill forward of x (B, S, dim) under the model axis and
        this rank's part of the KV cache (``init_kv_cache(...,
        model_axis=)``): its kv heads where they divide the axis, else
        every kv head at its slice of the ``max_len`` positions.  The
        attention itself runs as the training forward's."""
        cfg, tp, cast = self.cfg, self.tp, self.policy.cast
        plan = self._tp_plan()
        h0 = plan[tp.rank][0][0]
        xc = cast(x)
        q = self._tp_project(xc, "wq", "bq", [p[0] for p in plan])
        split = kv_split(cfg.n_kv_heads, max_len, tp.size)
        # The cached heads: this rank's, or all of them.
        if split == "heads":
            heads = [p[1] for p in plan]
            k = self._tp_project(xc, "wk", "bk", heads)
            v = self._tp_project(xc, "wv", "bv", heads)
        else:
            heads = [(0, cfg.n_kv_heads)] * tp.size
            k = self._tp_all_heads(xc, "wk", "bk", cfg.n_kv_heads)
            v = self._tp_all_heads(xc, "wv", "bv", cfg.n_kv_heads)
        q, k = self.apply_positions(q, k, positions)
        b, s = x.shape[:2]
        cache = init_kv_cache(b, max_len, cfg, dtype, device=x.device,
                              model_axis=tp)
        lo = tp.rank * cache["k"].shape[1] if split == "seq" else 0
        hi = min(s, lo + cache["k"].shape[1])
        if hi > lo:
            cache["k"][:, :hi - lo] = k[:, lo:hi]
            cache["v"][:, :hi - lo] = v[:, lo:hi]
        cache["length"].fill_(s)
        ka, va = self._tp_kv_of_q(k, v, heads[tp.rank][0])
        return self._tp_out(self.attend(q, ka, va), x.dtype, h0), cache

    def _decode_tp(self, x, cache):
        """:meth:`decode` under the model axis, on this rank's part of the
        cache.  Split by kv heads: this rank's heads, as unsharded.  Split
        by positions: every query head over this rank's positions, the
        softmax's maximum, sum and weighted values then combined over the
        axis (a slice with no valid position adds an exact 0)."""
        cfg, tp, cast = self.cfg, self.tp, self.policy.cast
        plan = self._tp_plan()
        idx = cache["length"]
        xc = cast(x)
        if cache["k"].shape[2] < cfg.n_kv_heads:
            (h0, _), kv, _ = plan[tp.rank]
            q = self._tp_project(xc, "wq", "bq", [p[0] for p in plan])
            k_new = self._tp_project(xc, "wk", "bk", [p[1] for p in plan])
            v_new = self._tp_project(xc, "wv", "bv", [p[1] for p in plan])
            q, k_new = self.apply_positions(q, k_new, idx[:, None])
            k_cache = write_token(cache["k"], idx, k_new)
            v_cache = write_token(cache["v"], idx, v_new)
            out = decode_attention(q, k_cache, v_cache, idx + 1)
        else:
            h0 = 0
            q = self._tp_all_heads(xc, "wq", "bq", cfg.n_heads)
            k_new = self._tp_all_heads(xc, "wk", "bk", cfg.n_kv_heads)
            v_new = self._tp_all_heads(xc, "wv", "bv", cfg.n_kv_heads)
            q, k_new = self.apply_positions(q, k_new, idx[:, None])
            s_loc = cache["k"].shape[1]
            lo = tp.rank * s_loc
            at = torch.where(idx >= lo, idx - lo, s_loc)   # past: no write
            k_cache = write_token(cache["k"], at, k_new)
            v_cache = write_token(cache["v"], at, v_new)
            out = decode_attention_split(q, k_cache, v_cache, idx + 1 - lo,
                                         tp)
        return self._tp_out(out, x.dtype, h0), {
            "k": k_cache, "v": v_cache, "length": idx + 1}

    def decode(self, x, cache):
        """One token per sequence, x (B, 1, dim), against ``cache`` (k and
        v (B, S, Hkv, D), ``length`` (B,) filled entries).  Returns (y,
        new_cache): the token's k (after rope at position ``length``) and
        v written at ``length`` into fresh copies of the cache, and
        ``length + 1``.  Under a model axis the cache is this rank's part
        (:meth:`_decode_tp`)."""
        if self.tp is not None:
            return self._decode_tp(x, cache)
        q, k_new, v_new = self.project_qkv(x)
        idx = cache["length"]
        q, k_new = self.apply_positions(q, k_new, idx[:, None])
        k_cache = write_token(cache["k"], idx, k_new)
        v_cache = write_token(cache["v"], idx, v_new)
        out = decode_attention(q, k_cache, v_cache, idx + 1)
        return self.project_out(out, x.dtype), {
            "k": k_cache, "v": v_cache, "length": idx + 1}


def write_token(cache, idx, new):
    """A copy of ``cache`` (B, S, H, D) with ``new`` (B, 1, H, D) at row
    ``idx[b]`` of each sequence, cast to the cache's dtype: the
    reference's one-hot blend, which writes nothing where ``idx >= S``
    (the engine's free slots decode on, past their capacity)."""
    b, s = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    at = idx.long().clamp(max=s - 1)
    out = cache.clone()
    out[rows, at] = torch.where((idx < s)[:, None, None],
                                new[:, 0].to(cache.dtype), cache[rows, at])
    return out


def kv_split(n_kv_heads: int, max_len: int, size: int) -> str:
    """The dim of a KV cache that a model axis of ``size`` splits, as
    ``parallel.sharding.cache_shardings`` places it (``kv_cache_split``):
    ``"heads"`` or ``"seq"``; a cache that neither divides, which the
    rules would replicate, is refused."""
    from repro_torch.parallel.sharding import kv_cache_split
    split = kv_cache_split(n_kv_heads, max_len, size)
    if split is None:
        raise ValueError(f"neither the {n_kv_heads} kv heads nor max_len="
                         f"{max_len} divide the model axis of {size}")
    return split


def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig,
                  dtype=torch.bfloat16, *, device, model_axis=None):
    """Zeroed k and v (batch, max_len, Hkv, D) in ``dtype`` and the
    int32 ``length`` (batch,); over ``model_axis`` (a
    ``parallel.tensor_parallel.ModelAxis``) this rank's part, split as
    :func:`kv_split` says (``length`` counts the whole sequence)."""
    shape = [batch, max_len, cfg.n_kv_heads, cfg.hd]
    if model_axis is not None and model_axis.size > 1:
        dim = 2 if kv_split(cfg.n_kv_heads, max_len,
                            model_axis.size) == "heads" else 1
        shape[dim] //= model_axis.size
    shape = tuple(shape)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}
