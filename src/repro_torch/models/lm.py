"""The causal language model: the GSPN-2 sequence mixer and GQA
attention.

A model is described by :class:`LMConfig`, the reference's
(``repro.models.lm.LMConfig``) with torch dtypes: ``prelude``, a list of
``(kind, n)`` stages applied once, then ``unit``, a list of ``(kind, n)``
stages repeated ``n_units`` times.  The port runs two block kinds of
:data:`KINDS`: ``gspn`` (pre-norm GSPN-2 sequence mixer + pre-norm SwiGLU
FFN, ``qwen2-1.5b-gspn``) and ``attn`` (pre-norm GQA attention with rope +
pre-norm SwiGLU FFN, ``qwen2-1.5b`` and its kin); any other kind raises
and names the ROADMAP item that brings it.

Entry points, each the reference's twin over an :class:`LM` module:
:func:`apply_lm` (logits of a whole sequence), :func:`lm_loss` (the
training loss and its parts), :func:`lm_prefill` (logits
and the decode caches), :func:`lm_prefill_chunk` (one prompt chunk against
live caches, DESIGN.md §9), :func:`init_lm_cache` and
:func:`lm_decode_step` (one token per sequence: O(W) state per gspn
layer, a KV cache of ``max_len`` positions per attn layer).

Caches keep the reference's layout: a dict per stage key ``s{i}_{kind}``
whose leaves carry leading ``(n,)`` axes for a prelude stage and
``(n_units, n)`` for a unit stage before the batch axis, so
:mod:`repro_torch.serve.cache` scatters a slot along the same axis.  An
attn stage's leaves (``k``, ``v``, ``length``) sit directly under its
key, where the reference nests them one level deeper, under ``"attn"``.

Dtypes follow the reference's cast points (DESIGN.md §10): the embedding
is gathered in the compute dtype, the residual stream stays in it, the
mixer computes in ``gspn_compute_dtype`` (f32 unless a precision preset
narrows it), attention's projections in the compute dtype and its
products and softmax in f32, the FFN in the compute dtype, and the head
is ``x.to(cd) @ embed.T.to(cd)``; the decode step's mixer runs in f32,
and the KV cache holds k (after rope) and v in the compute dtype.

:func:`apply_lm` and :func:`lm_loss` run under the caller's grad mode;
with gradients on, each block is rematerialised as ``LMConfig.remat``
says (the reference's ``_maybe_remat``): ``"none"`` keeps every
activation and ``"unit"`` keeps only each block's input and runs the
block again in the backward (so the mixer's scans launch twice a step,
and attention's blockwise forward runs twice).
The reference's ``"dots"`` (keep the matrix products' outputs) has no
caller in the port until the dry-run of ROADMAP.md §1 item 8, and raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.core.gspn import (GSPNSeqConfig, GSPNSeqMixer,
                                   gspn_seq_prefill_chunk)
from repro_torch.device import resolve_device
from repro_torch.models.attention import (Attention, AttentionConfig,
                                          chunk_prefill_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (DTypePolicy, RMSNorm, SwiGLU,
                                       cross_entropy_loss, dense_init,
                                       embed_init)

# Block kinds of the reference that the port does not run yet, and the
# ROADMAP.md §1 item that brings each.
NOT_PORTED_KINDS = {
    "attn_moe": "item 3.6 (the other families: MoE)",
    "xattn": "item 3.6 (the other families: encoder-decoder)",
    "mamba": "item 3.6 (the other families: SSM)",
    "mlstm": "item 3.6 (the other families: xLSTM)",
    "slstm": "item 3.6 (the other families: xLSTM)",
}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` with torch dtypes, less the fields of
    the kinds the port does not run yet.  ``gspn_impl`` defaults to
    ``"auto"``, which resolves to the CUDA kernel #1 on the card and to
    the plain scan on the CPU; the reference's defaults to ``"xla"``, its
    plain path."""
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int                   # read by the attn kind; the gspn
    n_kv_heads: int                # kind has no heads
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    prelude: tuple = ()            # ((kind, n), ...), applied once
    unit: tuple = ()               # ((kind, n), ...), repeated n_units times
    n_units: int = 1
    # GSPN mixer.
    gspn_proxy_dim: int = 8
    gspn_row_width: int = 64
    gspn_impl: str = "auto"
    # Streamed dtype of the mixer's scans: f32 independently of
    # compute_dtype, so chunked ≡ one-shot stays exact unless a precision
    # preset (configs.base.with_precision) narrows it.
    gspn_compute_dtype: torch.dtype = torch.float32
    # The reference's sharding knob, which the configs set and nothing
    # reads yet, and the rematerialisation of each block under gradients:
    # "none" or "unit".
    n_model_shards: int = 1
    remat: str = "unit"
    attn_block_k: int = 512        # key block of the blockwise attention
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    carry_dtype: torch.dtype = torch.float32

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def policy(self) -> DTypePolicy:
        return DTypePolicy(self.param_dtype, self.compute_dtype,
                           self.carry_dtype)

    def stages(self):
        """Flattened (where, kind, n) list: prelude then unit."""
        return [("prelude", k, n) for k, n in self.prelude] + \
               [("unit", k, n) for k, n in self.unit]

    def layer_count(self) -> int:
        return sum(n for _, n in self.prelude) + \
            self.n_units * sum(n for _, n in self.unit)


@dataclasses.dataclass
class Ctx:
    """Per-call execution context, the ``ctx`` of every entry point.  The
    reference's carries the device mesh of a sharded run; the port runs
    on one device, and a mesh raises until parallelism is ported
    (ROADMAP.md §1 item 6), so a Ctx changes nothing yet."""
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "a device mesh is not supported by the port yet; "
                "parallelism comes with ROADMAP.md §1 item 6")


def gspn_config(cfg: LMConfig) -> GSPNSeqConfig:
    return GSPNSeqConfig(
        dim=cfg.d_model, proxy_dim=cfg.gspn_proxy_dim,
        row_width=cfg.gspn_row_width, impl=cfg.gspn_impl,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.gspn_compute_dtype,
        carry_dtype=cfg.carry_dtype)


def attn_config(cfg: LMConfig) -> AttentionConfig:
    return AttentionConfig(
        dim=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta, block_k=cfg.attn_block_k)


# ---------------------------------------------------------------------------
# The gspn block kind.
# ---------------------------------------------------------------------------

class GSPNBlock(nn.Module):
    """Pre-norm GSPN-2 sequence mixer + pre-norm SwiGLU FFN, with the
    reference's four paths: ``forward`` (training/scoring), ``prefill``
    (also returns the O(W) cache), ``prefill_chunk`` (resumes from it)
    and ``decode`` (one token)."""

    def __init__(self, cfg: LMConfig, *, generator, device):
        super().__init__()
        d, pd = cfg.d_model, cfg.param_dtype
        self.ln1 = RMSNorm(d, device=device, dtype=pd)
        self.mix = GSPNSeqMixer(gspn_config(cfg), device=device,
                                generator=generator)
        self.ln2 = RMSNorm(d, device=device, dtype=pd)
        self.ffn = SwiGLU(d, cfg.d_ff, cfg.policy, generator=generator,
                          device=device)

    def _ffn(self, x):
        return x + self.ffn(self.ln2(x))

    def forward(self, x):
        return self._ffn(x + self.mix(self.ln1(x)))

    def prefill(self, x, max_len: int):
        """``max_len`` sizes an attn block's cache; the O(W) state here
        does not depend on it."""
        y, cache = self.mix(self.ln1(x), return_cache=True)
        return self._ffn(x + y), cache

    def prefill_chunk(self, x, cache, off: int):
        y, new = gspn_seq_prefill_chunk(self.mix, self.ln1(x), cache,
                                        pos=off)
        return self._ffn(x + y), new

    def decode(self, x, cache):
        y, new = gspn_decode_step(self.mix, self.ln1(x), cache)
        return self._ffn(x + y), new


# ---------------------------------------------------------------------------
# The attn block kind.
# ---------------------------------------------------------------------------

def _positions(b: int, t: int, device, off: int = 0):
    return (off + torch.arange(t, dtype=torch.int32, device=device))[
        None].expand(b, t)


class AttnBlock(nn.Module):
    """Pre-norm GQA attention with rope + pre-norm SwiGLU FFN, with the
    four paths of the reference's ``attn`` kind.  Positions are
    ``arange(S)`` in ``forward`` and ``prefill``, ``off + arange(T)`` in a
    chunk and each sequence's cache length in ``decode``.  The cache is
    k (after rope) and v (B, max_len, Hkv, D) in the compute dtype and the
    int32 ``length`` (B,)."""

    def __init__(self, cfg: LMConfig, *, generator, device):
        super().__init__()
        d, pd = cfg.d_model, cfg.param_dtype
        self.cd = cfg.compute_dtype
        self.ln1 = RMSNorm(d, device=device, dtype=pd)
        self.attn = Attention(attn_config(cfg), cfg.policy,
                              generator=generator, device=device)
        self.ln2 = RMSNorm(d, device=device, dtype=pd)
        self.ffn = SwiGLU(d, cfg.d_ff, cfg.policy, generator=generator,
                          device=device)

    def _ffn(self, x):
        return x + self.ffn(self.ln2(x))

    def forward(self, x):
        b, s, _ = x.shape
        return self._ffn(x + self.attn(self.ln1(x),
                                       _positions(b, s, x.device)))

    def prefill(self, x, max_len: int):
        """The forward, and the cache of the prompt's k and v padded to
        ``max_len`` positions.  A prompt longer than ``max_len`` raises
        (the reference's pad width would go negative)."""
        b, s, _ = x.shape
        if s > max_len:
            raise ValueError(f"a prompt of {s} tokens does not fit the KV "
                             f"cache's max_len={max_len}")
        attn = self.attn
        q, k, v = attn.project_qkv(self.ln1(x))
        q, k = attn.apply_positions(q, k, _positions(b, s, x.device))
        x = x + attn.project_out(attn.attend(q, k, v), x.dtype)
        cache = init_kv_cache(b, max_len, attn.cfg, self.cd, device=x.device)
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["length"].fill_(s)
        return self._ffn(x), cache

    def prefill_chunk(self, x, cache, off: int):
        """The (B, T) chunk at offset ``off``: its k and v written into a
        copy of the cache, attention over the cache with the offset causal
        mask.  A chunk past the cache's end raises (the reference clamps
        the write offset)."""
        b, t, _ = x.shape
        max_len = cache["k"].shape[1]
        if off + t > max_len:
            raise ValueError(f"a chunk of {t} tokens at offset {off} does "
                             f"not fit the KV cache's max_len={max_len}")
        attn = self.attn
        q, k, v = attn.project_qkv(self.ln1(x))
        q, k = attn.apply_positions(q, k, _positions(b, t, x.device, off))
        kc, vc = cache["k"].clone(), cache["v"].clone()
        kc[:, off:off + t] = k
        vc[:, off:off + t] = v
        out = attn.project_out(chunk_prefill_attention(q, kc, vc, off),
                               x.dtype)
        length = torch.full((b,), off + t, dtype=torch.int32,
                            device=x.device)
        return self._ffn(x + out), {"k": kc, "v": vc, "length": length}

    def decode(self, x, cache):
        y, new = self.attn.decode(self.ln1(x), cache)
        return self._ffn(x + y), new


# The block kinds the port runs.
KINDS = {"gspn": GSPNBlock, "attn": AttnBlock}


def _check_kind(kind: str) -> None:
    """Raise unless the port runs block kind ``kind``."""
    if kind in NOT_PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not in the port yet; ROADMAP.md §1 "
            f"{NOT_PORTED_KINDS[kind]} brings it")
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# GSPN sequence-mixer decode (O(W) state: the last grid row).
# ---------------------------------------------------------------------------

def init_gspn_decode_cache(batch: int, scfg: GSPNSeqConfig, *, device):
    w = scfg.row_width or 64
    cp = scfg.proxy_dim
    return {
        "prev_row": torch.zeros((batch, cp, w), device=device),
        "cur_row": torch.zeros((batch, cp, w), device=device),
        "row_state": torch.zeros((batch, cp), device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def gspn_decode_step(mixer: GSPNSeqMixer, x, cache):
    """One-token mixer step in f32, x: (B, 1, D).  Keeps the previous grid
    row (the T→B pass) and the running within-row state: O(W) memory."""
    b = x.shape[0]
    cp = mixer.cfg.proxy_dim
    w = cache["prev_row"].shape[-1]
    xf = x[:, 0].float()                                      # (B,D)

    x_p = xf @ mixer.down.float()                             # (B,Cp)
    tap_logits = xf @ mixer.w_taps.float()                    # (B,3)
    row_g = torch.sigmoid(xf @ mixer.w_row.float())           # (B,1)
    lam = torch.sigmoid(xf @ mixer.w_lam.float())             # (B,2Cp)
    u = xf @ mixer.w_u.float()                                # (B,2Cp)

    j = cache["pos"].long() % w                               # (B,)

    def gather_col(rows, idx, valid):
        """Column idx of each row's (Cp, W) grid row, 0 where invalid."""
        idx = idx.clamp(0, w - 1)[:, None, None].expand(b, cp, 1)
        g = torch.gather(rows, -1, idx)[..., 0]
        return torch.where(valid[:, None], g, 0.0)            # (B,Cp)

    prev = cache["prev_row"]
    h_l = gather_col(prev, j - 1, j >= 1)
    h_c = gather_col(prev, j, torch.ones_like(j, dtype=torch.bool))
    h_r = gather_col(prev, j + 1, j + 1 <= w - 1)

    # The masked softmax of normalize_taps at column j.
    neg = torch.finfo(torch.float32).min
    zero = torch.zeros_like(j, dtype=torch.float32)
    mask = torch.stack([torch.where(j == 0, neg, zero), zero,
                        torch.where(j == w - 1, neg, zero)], dim=-1)
    taps = torch.softmax(tap_logits + mask, dim=-1)           # (B,3)

    h_tb = (taps[:, 0:1] * h_l + taps[:, 1:2] * h_c + taps[:, 2:3] * h_r
            + lam[:, :cp] * x_p)                              # (B,Cp)
    # Within-row: reset at the start of a row.
    at_row_start = (j == 0)[:, None]
    row_prev = torch.where(at_row_start, 0.0, cache["row_state"])
    h_row = row_g * row_prev + lam[:, cp:] * x_p

    y = u[:, :cp] * h_tb + u[:, cp:] * h_row
    y = (y @ mixer.up.float())[:, None]                       # (B,1,D)

    cur = torch.where(at_row_start[..., None],
                      torch.zeros_like(cache["cur_row"]), cache["cur_row"])
    onehot = torch.nn.functional.one_hot(j, w).float()[:, None, :]
    cur = cur * (1.0 - onehot) + h_tb[..., None] * onehot     # column j
    at_row_end = (j == w - 1)[:, None, None]
    new_prev = torch.where(at_row_end, cur, prev)
    new_cache = {"prev_row": new_prev, "cur_row": cur, "row_state": h_row,
                 "pos": cache["pos"] + 1}
    return y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------

def _stage_key(si: int, kind: str) -> str:
    return f"s{si}_{kind}"


class LM(nn.Module):
    """Embedding, the block stages, the final rmsnorm and the head (the
    embedding's transpose when ``tie_embeddings``).

    ``stages[key]`` holds a prelude stage's n blocks, or a unit stage's
    n_units lists of n blocks.  Weights are drawn from ``generator``
    (seed 0 when not given) in the order embedding, head, blocks; on the
    ``meta`` device nothing is drawn (a twin to load a ``state_dict``
    into with ``assign=True``).  ``device=None`` is the card.
    """

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = embed_init(cfg.vocab, cfg.d_model, generator, device, pd)
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=pd)
        if not cfg.tie_embeddings:
            self.head = dense_init(cfg.d_model, cfg.vocab, generator, device,
                                   pd)
        kw = dict(generator=generator, device=device)
        self.stages = nn.ModuleDict()
        for si, (where, kind, n) in enumerate(cfg.stages()):
            _check_kind(kind)

            def blocks():
                return nn.ModuleList([KINDS[kind](cfg, **kw)
                                      for _ in range(n)])
            self.stages[_stage_key(si, kind)] = (
                blocks() if where == "prelude" else
                nn.ModuleList([blocks() for _ in range(cfg.n_units)]))

    def walk(self):
        """(stage key, cache index, block) for every block in execution
        order: the prelude stages, then each unit's stages.  The cache
        index selects the block's slice of its stage's cache leaves."""
        stages = self.cfg.stages()
        for si, (where, kind, n) in enumerate(stages):
            if where == "prelude":
                key = _stage_key(si, kind)
                for i in range(n):
                    yield key, (i,), self.stages[key][i]
        for u in range(self.cfg.n_units):
            for si, (where, kind, n) in enumerate(stages):
                if where == "unit":
                    key = _stage_key(si, kind)
                    for i in range(n):
                        yield key, (u, i), self.stages[key][u][i]

    def embed_tokens(self, tokens):
        """Token embeddings (B, S, D) in the compute dtype."""
        return self.embed[tokens].to(self.cfg.compute_dtype)

    def logits(self, x):
        cd = self.cfg.compute_dtype
        x = self.ln_f(x)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return x.to(cd) @ head.to(cd)

    def forward(self, tokens):
        return apply_lm(self, tokens)


REMAT = ("none", "unit")


def _maybe_remat(cfg: LMConfig, block):
    """``block`` as the reference's ``_maybe_remat`` wraps a layer's body:
    as it is under "none" or without gradients, else under non-reentrant
    activation checkpointing."""
    if cfg.remat == "dots":
        raise NotImplementedError(
            'remat="dots" is not in the port yet; ROADMAP.md §1 item 8 (the '
            "dry-run, its only caller) brings it")
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block
    return functools.partial(checkpoint.checkpoint, block,
                             use_reentrant=False)


def apply_lm(model: LM, tokens, *, ctx: Ctx | None = None):
    """Logits (B, S, V) of tokens (B, S) int."""
    x = model.embed_tokens(tokens)
    for _, _, block in model.walk():
        x = _maybe_remat(model.cfg, block)(x)
    return model.logits(x)


def lm_loss(model: LM, batch, *, ctx: Ctx | None = None):
    """batch: dict(tokens (B, S), labels (B, S), [mask]).  Returns
    (ce + aux, {"ce", "aux"}); ``aux`` is 0, neither the gspn nor the
    attn kind having an auxiliary loss (the reference adds the MoE
    kinds' here)."""
    logits = apply_lm(model, batch["tokens"], ctx=ctx)
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux}


def init_lm_cache(cfg: LMConfig, batch: int, max_len: int, *, device):
    """Zeroed decode caches of ``batch`` sequences, in the reference's
    layout (per stage key, leading (n,) or (n_units, n) axes); an attn
    stage's KV cache holds ``max_len`` positions, a gspn stage's state
    does not depend on it."""
    caches = {}
    for si, (where, kind, n) in enumerate(cfg.stages()):
        _check_kind(kind)
        lead = (n,) if where == "prelude" else (cfg.n_units, n)
        if kind == "attn":
            one = init_kv_cache(batch, max_len, attn_config(cfg),
                                cfg.compute_dtype, device=device)
        else:
            one = init_gspn_decode_cache(batch, gspn_config(cfg),
                                         device=device)
        caches[_stage_key(si, kind)] = {
            k: v.expand(lead + v.shape).clone() for k, v in one.items()}
    return caches


def _store(caches, key, idx, layer_cache):
    for name, v in layer_cache.items():
        caches[key][name][idx].copy_(v)


def lm_prefill(model: LM, tokens, max_len: int, *, ctx: Ctx | None = None):
    """Forward over the prompt (B, S) that also fills the decode caches,
    whose KV caches hold ``max_len`` positions.  Returns (logits (B, S,
    V), caches)."""
    x = model.embed_tokens(tokens)
    caches = init_lm_cache(model.cfg, tokens.shape[0], max_len,
                           device=x.device)
    for key, idx, block in model.walk():
        x, layer_cache = block.prefill(x, max_len)
        _store(caches, key, idx, layer_cache)
    return model.logits(x), caches


def supports_chunked_prefill(cfg: LMConfig) -> bool:
    """True iff every stage kind resumes from its cache (the gspn and attn
    kinds do) and, with a gspn stage, the fold width is fixed (row_width
    > 0)."""
    kinds = {kind for _, kind, _ in cfg.stages()}
    if not kinds <= KINDS.keys():
        return False
    return "gspn" not in kinds or cfg.gspn_row_width > 0


def prefill_chunk_alignment(cfg: LMConfig) -> int:
    """Chunks start on GSPN grid-row boundaries, so chunk sizes snap to a
    multiple of the fold width when a gspn stage is present; 1 otherwise
    (an attention-only model chunks anywhere)."""
    if any(kind == "gspn" for _, kind, _ in cfg.stages()):
        return max(1, cfg.gspn_row_width)
    return 1


def lm_prefill_chunk(model: LM, tokens, caches, off: int, *,
                     ctx: Ctx | None = None, with_logits: bool = True):
    """Consume prompt tokens (B, T) at absolute offset ``off`` against
    ``caches`` shaped like :func:`init_lm_cache`'s.  Returns (logits
    (B, T, V), new_caches); a chain of chunks and then decoding equals
    :func:`lm_prefill` over the whole prompt.  ``with_logits=False``
    returns (None, new_caches) without the final norm and the vocabulary
    head: only the last chunk's logits feed sampling."""
    x = model.embed_tokens(tokens)
    new = {k: {n: torch.empty_like(v) for n, v in sub.items()}
           for k, sub in caches.items()}
    for key, idx, block in model.walk():
        layer = {n: v[idx] for n, v in caches[key].items()}
        x, layer_cache = block.prefill_chunk(x, layer, off)
        _store(new, key, idx, layer_cache)
    return (model.logits(x) if with_logits else None), new


def lm_decode_step(model: LM, token, caches, *, ctx: Ctx | None = None):
    """token: (B, 1) int.  Returns (logits (B, 1, V), new_caches)."""
    x = model.embed_tokens(token)
    new = {k: {n: torch.empty_like(v) for n, v in sub.items()}
           for k, sub in caches.items()}
    for key, idx, block in model.walk():
        layer = {n: v[idx] for n, v in caches[key].items()}
        x, layer_cache = block.decode(x, layer)
        _store(new, key, idx, layer_cache)
    return model.logits(x), new


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
