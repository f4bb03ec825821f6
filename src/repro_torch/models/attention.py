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
The port's attention is causal self-attention from position 0: the
reference's ``causal=False`` and ``q_offset`` options, its M-RoPE and its
cross-attention have no caller until whisper and qwen2-vl (ROADMAP.md §1
item 3.6) and are not ported.

With tracing on (``obs.enable()``) each call enters an ``attention.*``
span, which is a ``torch.profiler.record_function`` range: a profile
reads attention's device time from the spans (``attention.blockwise``
and ``attention.blockwise_bwd`` in training; ``attention.chunk`` and
``attention.decode`` in serving; the dense path's backward runs in
autograd, outside its span).

:class:`Attention` is the layer (``init_attention``, ``_project_qkv``,
``_apply_positions``, ``apply_attention`` and ``apply_attention_decode``
of the reference), with rope on q and k; :func:`init_kv_cache` its cache.
"""

from __future__ import annotations

import dataclasses
import math
import torch
from torch import nn

from repro_torch import obs
from repro_torch.models.layers import (DTypePolicy, apply_rope, dense_init,
                                       new_param, zeros)

NEG_INF = -1e30


def _group_q(q, hkv: int):
    b, s, hq, d = q.shape
    return q.reshape(b, s, hkv, hq // hkv, d)


def full_attention(q, k, v):
    """Reference attention.  q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D);
    query i sees key j iff j <= i."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    with obs.trace("attention.dense"):
        qg = _group_q(q, hkv).float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              k.float()) / math.sqrt(d)
        iq = torch.arange(sq, device=q.device)[:, None]
        ik = torch.arange(k.shape[1], device=q.device)[None, :]
        p = torch.softmax(torch.where(ik <= iq, logits, NEG_INF), dim=-1)
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
    ``lo``, causally masked."""
    b, hkv, g, sq, d = qh.shape
    bk = kb.shape[2]
    logits = (qh.reshape(b, hkv, g * sq, d) @ kb.transpose(-1, -2)).view(
        b, hkv, g, sq, bk)
    ik = lo + torch.arange(bk, device=qh.device)
    return torch.where(ik[None, :] <= iq[:, None], logits, NEG_INF)


def _pv(p, vb):
    """p (B, Hkv, G, Sq, bk) @ vb (B, Hkv, bk, D) -> (B, Hkv, G, Sq, D)."""
    b, hkv, g, sq, bk = p.shape
    return (p.reshape(b, hkv, g * sq, bk) @ vb).view(b, hkv, g, sq, -1)


def _fwd_blocks(qh, kh, vh, block_k: int):
    """The online-softmax sweep over key blocks: (unnormalised output,
    running maximum, running sum), (B, Hkv, G, Sq, D) / (B, Hkv, G, Sq)."""
    b, hkv, g, sq, d = qh.shape
    iq = torch.arange(sq, device=qh.device)
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


def _flash_fwd(q, k, v, block_k: int):
    """(output (B, Sq, Hq, D) in q's dtype, log-sum-exp (B, Hkv, G, Sq))."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qh = _heads_q(q, hkv) / math.sqrt(d)
    acc, m, s = _fwd_blocks(qh, _heads_kv(k), _heads_kv(v), block_k)
    out = acc / torch.clamp(s[..., None], min=1e-30)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype), lse


def _flash_bwd(q, k, v, lse, dout, block_k: int):
    """The reference's FlashAttention-2-style adjoint: sweep 1 recomputes
    the output blockwise from (q, k, v, lse) for delta = rowsum(dout ·
    out), sweep 2 recomputes each block's probabilities and accumulates
    dq, dk and dv.  Nothing of size Sq × Sk is kept."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qh = _heads_q(q, hkv) / math.sqrt(d)
    kh, vh = _heads_kv(k), _heads_kv(v)
    do = _heads_q(dout, hkv)                              # (B,Hkv,G,Sq,D)
    iq = torch.arange(sq, device=q.device)
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
    only (q, k, v, lse), and the backward is :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, block_k):
        with obs.trace("attention.blockwise"):
            out, lse = _flash_fwd(q, k, v, block_k)
        ctx.save_for_backward(q, k, v, lse)
        ctx.block_k = block_k
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        with obs.trace("attention.blockwise_bwd"):
            grads = _flash_bwd(q, k, v, lse, dout, ctx.block_k)
        return (*grads, None)


def chunked_attention(q, k, v, *, block_k: int = 512):
    """Flash-style causal attention: the online-softmax forward over key
    blocks and the recomputing two-sweep backward.  ``block_k`` halves
    until it divides Sk (a 1000-token prompt runs 125 blocks of 8)."""
    sk = k.shape[1]
    while sk % block_k:
        block_k //= 2
    return _FlashAttention.apply(q, k, v, block_k)


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


# ---------------------------------------------------------------------------
# The layer: projections, rope, attention, output projection.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """The reference's ``AttentionConfig`` for causal self-attention with
    rope: its ``causal``, ``use_chunked`` and ``mrope_sections`` have one
    value in the port (True, True, None; the non-causal encoder and M-RoPE
    come with whisper and qwen2-vl, item 3.6)."""
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int = 0              # 0 => dim // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    block_k: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads


class Attention(nn.Module):
    """GQA attention with rope: ``wq``, ``wk``, ``wv``, ``wo`` (d_in,
    d_out) and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``.  Parameters are
    cast to the policy's compute dtype at use, the input too; the output
    returns in the input's dtype."""

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

    def project_qkv(self, x):
        """q (B, S, Hq, D), k and v (B, S, Hkv, D) in the compute dtype."""
        cfg, cast = self.cfg, self.policy.cast
        b, s, _ = x.shape
        xc = cast(x)
        q, k, v = xc @ cast(self.wq), xc @ cast(self.wk), xc @ cast(self.wv)
        if cfg.qkv_bias:
            q, k, v = q + cast(self.bq), k + cast(self.bk), v + cast(self.bv)
        return (q.reshape(b, s, cfg.n_heads, cfg.hd),
                k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
                v.reshape(b, s, cfg.n_kv_heads, cfg.hd))

    def apply_positions(self, q, k, positions):
        """Rope on q and k at positions (B, S)."""
        theta = self.cfg.rope_theta
        return apply_rope(q, positions, theta), apply_rope(k, positions, theta)

    def attend(self, q, k, v):
        """Causal self-attention over the whole sequence: blockwise when
        the keys outnumber ``block_k``, else dense."""
        if k.shape[1] > self.cfg.block_k:
            return chunked_attention(q, k, v, block_k=self.cfg.block_k)
        return full_attention(q, k, v)

    def project_out(self, out, dtype):
        """(B, S, Hq, D) -> (B, S, dim) through ``wo``, in ``dtype``."""
        cast = self.policy.cast
        b, s = out.shape[:2]
        out = out.reshape(b, s, self.cfg.n_heads * self.cfg.hd)
        return (cast(out) @ cast(self.wo)).to(dtype)

    def forward(self, x, positions):
        """Training / prefill forward of x (B, S, dim) at positions (B, S)."""
        q, k, v = self.project_qkv(x)
        q, k = self.apply_positions(q, k, positions)
        return self.project_out(self.attend(q, k, v), x.dtype)

    def decode(self, x, cache):
        """One token per sequence, x (B, 1, dim), against ``cache`` (k and
        v (B, S, Hkv, D), ``length`` (B,) filled entries).  Returns (y,
        new_cache): the token's k (after rope at position ``length``) and
        v written at ``length`` into fresh copies of the cache, and
        ``length + 1``."""
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


def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig,
                  dtype=torch.bfloat16, *, device):
    """Zeroed k and v (batch, max_len, Hkv, D) in ``dtype`` and the
    int32 ``length`` (batch,)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}
