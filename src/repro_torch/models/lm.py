"""The causal language model: the GSPN-2 sequence mixer, GQA attention,
the mixture of experts, the Mamba-2 mixer, the xLSTM's two mixers, and
the vision-language and encoder-decoder variants.

A model is described by :class:`LMConfig`, the reference's
(``repro.models.lm.LMConfig``) with torch dtypes: ``prelude``, a list of
``(kind, n)`` stages applied once, then ``unit``, a list of ``(kind, n)``
stages repeated ``n_units`` times, and with ``shared_attn`` one
weight-shared attn block applied at the end of every unit (Zamba2).  The
port runs the reference's seven block kinds, :data:`KINDS`:

  gspn      pre-norm GSPN-2 sequence mixer + pre-norm FFN
            (``qwen2-1.5b-gspn``)
  attn      pre-norm GQA attention with rope (M-RoPE under
            ``mrope_sections``) + pre-norm FFN (``qwen2-1.5b`` and its
            kin, ``qwen2-vl-72b``, the shared block, kimi's first layer)
  attn_moe  pre-norm GQA attention with rope + pre-norm MoE, no dense
            FFN; its aux loss is summed over the blocks
            (``kimi-k2-1t-a32b``, ``grok-1-314b``)
  xattn     pre-norm self-attention, pre-norm cross-attention on the
            encoder's keys and values, pre-norm FFN (``whisper-base``)
  mamba     pre-norm Mamba-2 mixer, no FFN (``zamba2-2.7b``)
  mlstm     pre-norm mLSTM mixer, no FFN (``xlstm-1.3b``)
  slstm     pre-norm sLSTM mixer, no FFN (``xlstm-1.3b``)

The norms are rmsnorm or layernorm (``norm``) and the FFN SwiGLU or a
GELU MLP with biases (``mlp``), as the config says.  With
``encoder_layers`` the model has whisper's encoder: learned positions
added to the frames, non-causal self-attention blocks without rotary
positions, a final norm, and one K/V projection (``enc_kv_proj``) that
every xattn block reads.  The reference's vision and audio frontends are
stubs, and so are the port's: ``vision_embeds`` (B, S_vis, D) replace the
first S_vis token embeddings, ``enc_frames`` (B, T, D) are the encoder's
input.

Entry points, each the reference's twin over an :class:`LM` module:
:func:`apply_lm` (logits of a whole sequence), :func:`lm_loss` (the
training loss and its parts, the MoE's aux loss among them),
:func:`lm_encode` (the encoder and its keys and values),
:func:`lm_prefill` (logits and the decode caches),
:func:`lm_prefill_chunk` (one prompt chunk against live caches,
DESIGN.md §9; the gspn, attn and attn_moe kinds only, as in the
reference: the recurrent mixers' prefill starts from a zero state, so a
model with one prefills in one shot), :func:`init_lm_cache` and
:func:`lm_decode_step` (one token per sequence: O(W) state per gspn
layer, a KV cache of ``max_len`` positions per attn or attn_moe layer,
the conv tail and the SSM state per mamba layer, the (hd, hd + 1) matrix
memory per mlstm layer and (h, c, n, m) per slstm layer).  The xattn kind
has no chunk path, and an encoder-decoder model prefills in one shot
(:func:`supports_chunked_prefill`); its prefill and decode steps take the
encoder's ``enc_kv`` from :func:`lm_encode`.  An attn_moe
block's expert capacity is counted over the tokens of each call (B · S,
B · T of a chunk, B of a decode step, the engine's free slots included),
as in the reference: where slots drop, a chunk chain differs from a
one-shot prefill and decode from :func:`apply_lm`.

Caches keep the reference's layout: a dict per stage key ``s{i}_{kind}``
whose leaves carry leading ``(n,)`` axes for a prelude stage and
``(n_units, n)`` for a unit stage before the batch axis, so
:mod:`repro_torch.serve.cache` scatters a slot along the same axis.  An
attn or attn_moe stage's leaves (``k``, ``v``, ``length``) sit directly
under its key, where the reference nests them one level deeper, under
``"attn"``;
the shared attn block's caches sit under ``"shared_attn"`` with a
leading ``(n_units,)`` axis, one per application.

Dtypes follow the reference's cast points (DESIGN.md §10): the embedding
is gathered in the compute dtype, the residual stream stays in it, the
mixer computes in ``gspn_compute_dtype`` (f32 unless a precision preset
narrows it), attention's projections in the compute dtype and its
products and softmax in f32, the FFN in the compute dtype, and the head
is ``x.to(cd) @ embed.T.to(cd)``; the decode step's mixer runs in f32,
and the KV cache holds k (after rope) and v in the compute dtype.  The
recurrent mixers cast their input and output projections to the compute
dtype and run everything between them in f32.

:func:`apply_lm` and :func:`lm_loss` run under the caller's grad mode;
with gradients on, each block is rematerialised as ``LMConfig.remat``
says (the reference's ``_maybe_remat``): ``"none"`` keeps every
activation and ``"unit"`` keeps only each block's input and runs the
block again in the backward (so the mixer's scans launch twice a step,
and attention's blockwise forward runs twice); ``"dots"``, the
reference's ``dots_with_no_batch_dims_saveable``, keeps the outputs of
the products without batch dimensions (``mm``, ``addmm``, ``linear``)
and recomputes everything else, batched products (``bmm``) included
(:data:`DOTS_SAVED`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch import obs
from repro_torch.core.gspn import (GSPNSeqConfig, GSPNSeqMixer,
                                   gspn_seq_prefill_chunk)
from repro_torch.device import resolve_device
from repro_torch.models.attention import (Attention, AttentionConfig,
                                          chunk_prefill_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (DTypePolicy, GeluMLP, LayerNorm,
                                       RMSNorm, SwiGLU, cross_entropy_loss,
                                       dense_init, embed_init)
from repro_torch.models.moe import MoE, MoEConfig, moe_active_param_count
from repro_torch.models.ssm import Mamba2, Mamba2Config, init_mamba2_cache
from repro_torch.models.xlstm import (MLSTM, SLSTM, MLSTMConfig, SLSTMConfig,
                                      init_mlstm_cache, init_slstm_cache)

@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` with torch dtypes, less its
    ``max_seq``, which nothing of the port reads.  ``gspn_impl`` defaults
    to ``"auto"``, which resolves to the CUDA kernel #1 on the card and to
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
    mrope_sections: tuple | None = None   # M-RoPE's slots a plane
    norm: str = "rmsnorm"          # rmsnorm|layernorm
    mlp: str = "swiglu"            # swiglu|gelu
    tie_embeddings: bool = False
    prelude: tuple = ()            # ((kind, n), ...), applied once
    unit: tuple = ()               # ((kind, n), ...), repeated n_units times
    n_units: int = 1
    shared_attn: bool = False      # one attn block after every unit
    # The attn_moe kind: experts, top-k, each expert's hidden width (0 =>
    # d_ff), the shared expert's (0 = none) and the capacity factor.
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    # The mamba, mlstm and slstm kinds.
    ssm_state: int = 64
    ssm_head_dim: int = 64
    gla_chunk: int = 256
    # GSPN mixer.
    gspn_proxy_dim: int = 8
    gspn_row_width: int = 64
    gspn_impl: str = "auto"        # "sp" shards the folded-grid scans over
    gspn_seq_axis: str = "seq"     # the mesh's seq axis (DESIGN.md §8)
    gspn_sp_strategy: str = "auto"
    # Streamed dtype of the mixer's scans: f32 independently of
    # compute_dtype, so chunked ≡ one-shot stays exact unless a precision
    # preset (configs.base.with_precision) narrows it.
    gspn_compute_dtype: torch.dtype = torch.float32
    # The encoder (whisper): its layers and its number of frames.
    encoder_layers: int = 0
    enc_len: int = 1500
    # The reference's sharding knob, which the MoE reads (its slabs'
    # layout, run over a model axis of that extent), and the
    # rematerialisation of each block under gradients: "none" or "unit".
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
        """Blocks applied, counting each application of the shared attn
        block (one weight set)."""
        return sum(n for _, n in self.prelude) + \
            self.n_units * (sum(n for _, n in self.unit)
                            + int(self.shared_attn))


@dataclasses.dataclass
class Ctx:
    """Per-call execution context, the ``ctx`` of every entry point: the
    device mesh (a ``DeviceMesh``) that ``gspn_impl="sp"`` shards the
    mixer's scans over (``launch.mesh.make_sp_mesh``; a data axis shards
    the scans' G, ``parallel.gspn_sp``) and that the train step runs on
    (``train.step``: its ``data`` and ``pod`` axes shard the weights and
    the batch, and the blocks see whole weights and their rank's rows;
    its ``model`` axis splits heads, FFN hidden width, vocabulary and
    expert groups).  PyTorch has no partitioner to place weights by the
    mesh: a model runs over a ``model`` axis larger than 1 once
    ``parallel.tensor_parallel.shard_model`` has kept this rank's shard,
    and an entry point refuses a ctx whose model axis differs from the
    model's."""
    mesh: Any = None

    def model_extent(self) -> int:
        """The extent of the mesh's ``model`` axis (1 without one)."""
        names = tuple(self.mesh.mesh_dim_names or ()) \
            if self.mesh is not None else ()
        return self.mesh.size(names.index("model")) if "model" in names \
            else 1


def gspn_config(cfg: LMConfig) -> GSPNSeqConfig:
    return GSPNSeqConfig(
        dim=cfg.d_model, proxy_dim=cfg.gspn_proxy_dim,
        row_width=cfg.gspn_row_width, impl=cfg.gspn_impl,
        seq_axis=cfg.gspn_seq_axis, sp_strategy=cfg.gspn_sp_strategy,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.gspn_compute_dtype,
        carry_dtype=cfg.carry_dtype)


def attn_config(cfg: LMConfig, *, causal: bool = True,
                cross: bool = False) -> AttentionConfig:
    """The reference's ``_attn_cfg``: a cross-attention has no M-RoPE."""
    return AttentionConfig(
        dim=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        mrope_sections=None if cross else cfg.mrope_sections,
        causal=causal, block_k=cfg.attn_block_k)


NORMS = {"rmsnorm": RMSNorm, "layernorm": LayerNorm}
MLPS = ("swiglu", "gelu")


def make_norm(cfg: LMConfig, *, device) -> nn.Module:
    """The config's norm (the reference's ``_norm_init``): rmsnorm (eps
    1e-6) or layernorm (eps 1e-5), parameters in ``param_dtype``."""
    if cfg.norm not in NORMS:
        raise ValueError(f"norm must be one of {sorted(NORMS)}, got "
                         f"{cfg.norm!r}")
    return NORMS[cfg.norm](cfg.d_model, device=device, dtype=cfg.param_dtype)


def make_ffn(cfg: LMConfig, *, generator, device) -> nn.Module:
    """The config's FFN (the reference's ``_ffn_init``): SwiGLU, or the
    GELU MLP with biases, of hidden width ``d_ff``."""
    if cfg.mlp not in MLPS:
        raise ValueError(f"mlp must be one of {MLPS}, got {cfg.mlp!r}")
    cls = SwiGLU if cfg.mlp == "swiglu" else GeluMLP
    return cls(cfg.d_model, cfg.d_ff, cfg.policy, generator=generator,
               device=device)


def moe_config(cfg: LMConfig) -> MoEConfig:
    return MoEConfig(
        dim=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff=cfg.moe_d_ff or cfg.d_ff, n_shards=cfg.n_model_shards,
        capacity_factor=cfg.capacity_factor,
        shared_expert_ff=cfg.shared_expert_ff)


def mamba_config(cfg: LMConfig) -> Mamba2Config:
    return Mamba2Config(dim=cfg.d_model, d_state=cfg.ssm_state,
                        head_dim=cfg.ssm_head_dim, chunk=cfg.gla_chunk)


def mlstm_config(cfg: LMConfig) -> MLSTMConfig:
    return MLSTMConfig(dim=cfg.d_model, n_heads=cfg.n_heads,
                       chunk=cfg.gla_chunk)


def slstm_config(cfg: LMConfig) -> SLSTMConfig:
    return SLSTMConfig(dim=cfg.d_model, n_heads=cfg.n_heads)


# ---------------------------------------------------------------------------
# The gspn block kind.
# ---------------------------------------------------------------------------

class GSPNBlock(nn.Module):
    """Pre-norm GSPN-2 sequence mixer + pre-norm FFN, with the
    reference's four paths: ``forward`` (training/scoring), ``prefill``
    (also returns the O(W) cache), ``prefill_chunk`` (resumes from it)
    and ``decode`` (one token).  ``mesh`` reaches the mixer's scans in the
    first three; the decode step is O(W) and unsharded."""

    def __init__(self, cfg: LMConfig, *, generator, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device=device)
        self.mix = GSPNSeqMixer(gspn_config(cfg), device=device,
                                generator=generator)
        self.ln2 = make_norm(cfg, device=device)
        self.ffn = make_ffn(cfg, generator=generator, device=device)

    def _ffn(self, x):
        return x + self.ffn(self.ln2(x))

    def forward(self, x, mesh=None):
        return self._ffn(x + self.mix(self.ln1(x), mesh=mesh))

    def prefill(self, x, max_len: int, mesh=None):
        """``max_len`` sizes an attn block's cache; the O(W) state here
        does not depend on it."""
        y, cache = self.mix(self.ln1(x), return_cache=True, mesh=mesh)
        return self._ffn(x + y), cache

    def prefill_chunk(self, x, cache, off: int, mesh=None):
        y, new = gspn_seq_prefill_chunk(self.mix, self.ln1(x), cache,
                                        pos=off, mesh=mesh)
        return self._ffn(x + y), new

    def decode(self, x, cache):
        y, new = gspn_decode_step(self.mix, self.ln1(x), cache)
        return self._ffn(x + y), new

    @staticmethod
    def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device):
        return init_gspn_decode_cache(batch, gspn_config(cfg), device=device)


# ---------------------------------------------------------------------------
# The attn block kind.
# ---------------------------------------------------------------------------

def _positions(b: int, t: int, device, off: int = 0):
    return (off + torch.arange(t, dtype=torch.int32, device=device))[
        None].expand(b, t)


class AttnBlock(nn.Module):
    """Pre-norm GQA attention with rope (M-RoPE under ``mrope_sections``)
    + pre-norm FFN, with the four paths of the reference's ``attn`` kind.
    ``forward`` takes the caller's positions ((B, S) or (3, B, S); None:
    none, as in the encoder, whose blocks are this kind with
    ``causal=False``); ``prefill`` rotates at ``arange(S)``, a chunk at
    ``off + arange(T)`` and ``decode`` at each sequence's cache length,
    all (B, S) ids, which M-RoPE reads as three equal planes.  The cache
    is k (after rope) and v (B, max_len, Hkv, D) in the compute dtype and
    the int32 ``length`` (B,).  A ``mesh`` is accepted and unused: the
    reference shards no attention over the seq axis."""

    def __init__(self, cfg: LMConfig, *, generator, device,
                 causal: bool = True):
        super().__init__()
        self._attention(cfg, generator=generator, device=device,
                        causal=causal)
        self.ffn = make_ffn(cfg, generator=generator, device=device)

    def _attention(self, cfg: LMConfig, *, generator, device,
                   causal: bool = True):
        """``ln1``, the attention layer and ``ln2``."""
        self.cd = cfg.compute_dtype
        self.ln1 = make_norm(cfg, device=device)
        self.attn = Attention(attn_config(cfg, causal=causal), cfg.policy,
                              generator=generator, device=device)
        self.ln2 = make_norm(cfg, device=device)

    def _ffn(self, x):
        return x + self.ffn(self.ln2(x))

    def _attend(self, x, positions):
        return x + self.attn(self.ln1(x), positions)

    def forward(self, x, mesh=None, positions=None):
        return self._ffn(self._attend(x, positions))

    def prefill(self, x, max_len: int, mesh=None):
        """The forward, and the cache of the prompt's k and v padded to
        ``max_len`` positions.  A prompt longer than ``max_len`` raises
        (the reference's pad width would go negative)."""
        x, cache = self._prefill_attention(x, max_len)
        return self._ffn(x), cache

    def _prefill_attention(self, x, max_len: int):
        """(x plus the self-attention over the prompt, its cache)."""
        b, s, _ = x.shape
        if s > max_len:
            raise ValueError(f"a prompt of {s} tokens does not fit the KV "
                             f"cache's max_len={max_len}")
        attn = self.attn
        if attn.tp is not None:
            y, cache = attn.prefill_tp(self.ln1(x), _positions(b, s, x.device),
                                       max_len, self.cd)
            return x + y, cache
        q, k, v = attn.project_qkv(self.ln1(x))
        q, k = attn.apply_positions(q, k, _positions(b, s, x.device))
        x = x + attn.project_out(attn.attend(q, k, v), x.dtype)
        cache = init_kv_cache(b, max_len, attn.cfg, self.cd, device=x.device)
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["length"].fill_(s)
        return x, cache

    def prefill_chunk(self, x, cache, off: int, mesh=None):
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

    @staticmethod
    def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device,
                   model_axis=None):
        return init_kv_cache(batch, max_len, attn_config(cfg),
                             cfg.compute_dtype, device=device,
                             model_axis=model_axis)


class AttnMoEBlock(AttnBlock):
    """The attn kind with the pre-norm MoE (``moe``, :class:`MoE`) in
    place of the dense FFN: the same four paths and KV cache.  Each call's
    MoE routes the tokens of that call (capacity per call);
    :meth:`forward_aux` also returns the layer's aux loss (times
    ``aux_loss_coef``), which :func:`lm_loss` sums over the blocks and the
    other paths drop, as the reference's do."""

    def __init__(self, cfg: LMConfig, *, generator, device):
        nn.Module.__init__(self)
        self._attention(cfg, generator=generator, device=device)
        self.moe = MoE(moe_config(cfg), cfg.policy, generator=generator,
                       device=device)

    def _moe(self, x):
        """(x + the MoE of ln2(x), the layer's aux loss)."""
        y, aux = self.moe(self.ln2(x))
        return x + y, aux

    def _ffn(self, x):
        return self._moe(x)[0]

    def forward_aux(self, x, mesh=None, positions=None):
        return self._moe(self._attend(x, positions))


class XAttnBlock(AttnBlock):
    """The xattn kind (whisper's decoder layer): ``ln1`` and causal
    self-attention with rope, ``ln_x`` and cross-attention (``xattn``) on
    the encoder's pre-projected ``enc_kv``, ``ln2`` and the FFN.  Without
    ``enc_kv`` the cross-attention is skipped, as in the reference.  It
    has forward, prefill and decode and no chunk path.  ``xattn``'s own
    ``wk`` and ``wv`` are parameters that nothing reads (the reference
    keeps them): their gradients are exact zeros."""

    prefill_chunk = None

    def __init__(self, cfg: LMConfig, *, generator, device):
        nn.Module.__init__(self)
        self._attention(cfg, generator=generator, device=device)
        self.ln_x = make_norm(cfg, device=device)
        self.xattn = Attention(attn_config(cfg, cross=True), cfg.policy,
                               generator=generator, device=device)
        self.ffn = make_ffn(cfg, generator=generator, device=device)

    def _cross(self, x, enc_kv):
        """x plus the cross-attention, inside an ``lm.cross_attention``
        span (a profile reads its share from it)."""
        if enc_kv is None:
            return x
        with obs.trace("lm.cross_attention"):
            return x + self.xattn(self.ln_x(x), kv=enc_kv)

    def forward(self, x, mesh=None, positions=None, enc_kv=None):
        return self._ffn(self._cross(self._attend(x, positions), enc_kv))

    def prefill(self, x, max_len: int, mesh=None, enc_kv=None):
        x, cache = self._prefill_attention(x, max_len)
        return self._ffn(self._cross(x, enc_kv)), cache

    def decode(self, x, cache, enc_kv=None):
        y, new = self.attn.decode(self.ln1(x), cache)
        return self._ffn(self._cross(x + y, enc_kv)), new


# ---------------------------------------------------------------------------
# The recurrent mixer kinds: mamba, mlstm, slstm.
# ---------------------------------------------------------------------------

class _MixerBlock(nn.Module):
    """Pre-norm recurrent mixer with no FFN and no ``ln2`` (the reference's
    ``_mk_mixer_kind``): ``forward``, ``prefill`` (the forward and the
    mixer's cache) and ``decode``.  There is no ``prefill_chunk``: the
    reference's prefill of these mixers starts from a zero state, so a
    model with one prefills in one shot (:func:`supports_chunked_prefill`).
    A ``mesh`` is accepted and unused: under a model axis the mixer
    carries it (``mix.tp``, set by ``parallel.tensor_parallel.
    shard_model``), runs its own heads or the whole, and keeps the caches
    whole on every rank."""

    def __init__(self, cfg: LMConfig, mixer, *, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device=device)
        self.mix = mixer

    def forward(self, x, mesh=None):
        return x + self.mix(self.ln1(x))

    def prefill(self, x, max_len: int, mesh=None):
        y, cache = self.mix.prefill(self.ln1(x))
        return x + y, cache

    def decode(self, x, cache):
        y, new = self.mix.decode(self.ln1(x), cache)
        return x + y, new


class MambaBlock(_MixerBlock):
    def __init__(self, cfg: LMConfig, *, generator, device):
        super().__init__(cfg, Mamba2(mamba_config(cfg), cfg.policy,
                                     generator=generator, device=device),
                         device=device)

    @staticmethod
    def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device):
        return init_mamba2_cache(batch, mamba_config(cfg), device=device)


class MLSTMBlock(_MixerBlock):
    def __init__(self, cfg: LMConfig, *, generator, device):
        super().__init__(cfg, MLSTM(mlstm_config(cfg), cfg.policy,
                                    generator=generator, device=device),
                         device=device)

    @staticmethod
    def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device):
        return init_mlstm_cache(batch, mlstm_config(cfg), device=device)


class SLSTMBlock(_MixerBlock):
    def __init__(self, cfg: LMConfig, *, generator, device):
        super().__init__(cfg, SLSTM(slstm_config(cfg), cfg.policy,
                                    generator=generator, device=device),
                         device=device)

    @staticmethod
    def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device):
        return init_slstm_cache(batch, slstm_config(cfg), device=device)


# The block kinds, the reference's all.
KINDS = {"gspn": GSPNBlock, "attn": AttnBlock, "attn_moe": AttnMoEBlock,
         "xattn": XAttnBlock, "mamba": MambaBlock, "mlstm": MLSTMBlock,
         "slstm": SLSTMBlock}


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _has_chunk_path(kind: str) -> bool:
    return getattr(KINDS[kind], "prefill_chunk", None) is not None


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

    x_p = xf @ mixer.whole("down").float()                    # (B,Cp)
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
    y = (y @ mixer.whole("up").float())[:, None]              # (B,1,D)

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


class Encoder(nn.Module):
    """Whisper's encoder over stub frame embeddings (the reference's
    ``_init_encoder``/``_apply_encoder``): ``pos_embed`` (enc_len, D)
    added in the frames' dtype (so its residual stream is f32 for f32
    frames, whatever the compute dtype), ``encoder_layers`` attn blocks
    with non-causal self-attention and no rotary positions, then
    ``ln_f``.  Its layers are not rematerialised, as in the reference.
    Over a model axis (``tp``) the rules split ``pos_embed``'s positions
    as they split a vocabulary (its name ends in ``embed``) where the
    axis divides ``enc_len``: every rank gathers it whole and adds it
    alike."""

    tp = None

    def __init__(self, cfg: LMConfig, *, generator, device):
        super().__init__()
        self.layers = nn.ModuleList([
            AttnBlock(cfg, generator=generator, device=device, causal=False)
            for _ in range(cfg.encoder_layers)])
        self.ln_f = make_norm(cfg, device=device)
        self.pos_embed = embed_init(cfg.enc_len, cfg.d_model, generator,
                                    device, cfg.param_dtype)

    def forward(self, frames):
        """frames (B, T, D), T <= enc_len -> (B, T, D) in their dtype."""
        pos = self.pos_embed if self.tp is None \
            else self.tp.whole(self, "pos_embed")
        x = frames + pos.to(frames.dtype)[None, :frames.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.ln_f(x)


class LM(nn.Module):
    """Embedding, the block stages, the final norm and the head (the
    embedding's transpose when ``tie_embeddings``).

    ``stages[key]`` holds a prelude stage's n blocks, or a unit stage's
    n_units lists of n blocks; ``shared_attn``, under
    ``cfg.shared_attn``, the one attn block applied after every unit;
    ``encoder`` and ``enc_kv_proj`` (``wk``, ``wv``), under
    ``encoder_layers``, the encoder and its K/V projection.
    Weights are drawn from ``generator`` (seed 0 when not given) in the
    order embedding, head, blocks, shared block, encoder, K/V projection;
    on the ``meta`` device
    nothing is drawn (a twin to load a ``state_dict`` into with
    ``assign=True``).  ``device=None`` is the card.

    Over a model axis (``parallel.tensor_parallel.shard_model``, which
    sets ``model_axis``) the embedding and the head are vocab-parallel
    where the axis divides the vocabulary (``tp``): :meth:`embed_tokens`
    looks up this rank's rows and sums over the axis, and :meth:`logits`
    returns this rank's columns of the vocabulary.  Else (whisper's
    51 865) both stay whole and ``tp`` None.
    """

    tp = None
    model_axis = None

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = embed_init(cfg.vocab, cfg.d_model, generator, device, pd)
        self.ln_f = make_norm(cfg, device=device)
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
        if cfg.shared_attn:
            self.shared_attn = AttnBlock(cfg, **kw)
        if cfg.encoder_layers:
            self.encoder = Encoder(cfg, **kw)
            kv = cfg.n_kv_heads * cfg.hd
            self.enc_kv_proj = nn.ParameterDict({
                name: dense_init(cfg.d_model, kv, generator, device, pd)
                for name in ("wk", "wv")})

    def walk(self):
        """(stage key, cache index, block) for every block in execution
        order: the prelude stages, then each unit's stages and, under
        ``shared_attn``, the shared block as (``"shared_attn"``, (u,)).
        The cache index selects the block's slice of its stage's cache
        leaves."""
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
            if self.cfg.shared_attn:
                yield "shared_attn", (u,), self.shared_attn

    def embed_tokens(self, tokens, vision_embeds=None):
        """Token embeddings (B, S, D) in the compute dtype; with
        ``vision_embeds`` (B, S_vis, D), those (cast to the compute dtype)
        in place of the first S_vis positions' (the reference's Qwen2-VL
        stub frontend), spliced after the vocab-parallel lookup is summed,
        so they are whole on every rank."""
        if self.tp is not None:
            x = self.tp.reduce(self.tp.embed(self.embed, tokens).to(
                self.cfg.compute_dtype))
        else:
            x = self.embed[tokens].to(self.cfg.compute_dtype)
        if vision_embeds is None:
            return x
        sv = vision_embeds.shape[1]
        return torch.cat([vision_embeds.to(x.dtype), x[:, sv:]], dim=1)

    def logits(self, x):
        """The head's logits (B, S, V); over a model axis, this rank's
        columns of the vocabulary (B, S, V/M)."""
        cd = self.cfg.compute_dtype
        xc = self.ln_f(x).to(cd)
        if self.tp is not None:
            xc = self.tp.copy(xc)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return xc @ head.to(cd)

    def encode(self, enc_frames):
        """:func:`lm_encode`'s body: a method, so that a data-parallel
        layout can gather ``enc_kv_proj`` around it
        (``parallel.data_parallel``)."""
        cfg = self.cfg
        out = self.encoder(enc_frames)
        cast = cfg.policy.cast
        b, t, _ = out.shape
        # The model axis that the cross-attention splits its heads over
        # (None: no axis, or every rank runs it whole).
        tp = next((block.xattn.tp for _, _, block in self.walk()
                   if isinstance(block, XAttnBlock)), None)

        def kv(name):
            if tp is None:
                return cast(out) @ cast(self.enc_kv_proj[name])
            return tp.product(self.enc_kv_proj, name, cast(out), cast)
        return tuple(kv(name).reshape(b, t, cfg.n_kv_heads, cfg.hd)
                     for name in ("wk", "wv"))

    def forward(self, tokens):
        return apply_lm(self, tokens)


REMAT = ("none", "unit", "dots")
# The ops whose outputs remat "dots" keeps: the matrix products without
# batch dimensions, as JAX's ``dots_with_no_batch_dims_saveable`` (a 3-D
# activation times a 2-D weight reaches ATen as one ``mm``).
DOTS_SAVED = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default,
                        torch.ops.aten.linear.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return checkpoint.create_selective_checkpoint_contexts(_dots_policy)


def _maybe_remat(cfg: LMConfig, block):
    """``block`` as the reference's ``_maybe_remat`` wraps a layer's body:
    as it is under "none" or without gradients, else under non-reentrant
    activation checkpointing, selective under "dots"."""
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}
    return functools.partial(checkpoint.checkpoint, block,
                             use_reentrant=False, **kw)


def _mesh(ctx: Ctx | None):
    return ctx.mesh if ctx is not None else None


def _model_extent(model: LM) -> int:
    return model.model_axis.size if model.model_axis is not None else 1


def _check_ctx(model: LM, ctx: Ctx | None) -> None:
    """A ctx whose model axis is not the one the model is sharded over
    raises (there is no partitioner to reconcile them)."""
    if ctx is not None and ctx.model_extent() != _model_extent(model):
        raise ValueError(
            f"the ctx's model axis has {ctx.model_extent()} ranks; the model "
            f"is sharded over {_model_extent(model)} (shard it with "
            f"parallel.tensor_parallel.shard_model)")


def _unsharded(model: LM, what: str) -> None:
    """The chunked prefill (and the engine that runs it) has no model
    axis, as the reference's serving has none."""
    if model.model_axis is not None:
        raise NotImplementedError(
            f"{what} of a model sharded over a model axis: the chunked "
            f"prefill runs without one, as the reference's serving does")


def lm_encode(model: LM, enc_frames):
    """The encoder over ``enc_frames`` (B, T, D) and the decoder's shared
    keys and values (the reference's ``_apply_encoder`` then
    ``_encoder_kv``): ``enc_kv`` = (k, v), each (B, T, Hkv, D) in the
    compute dtype, which :func:`lm_prefill` and :func:`lm_decode_step`
    take.  Raises for a model without an encoder.  Over a model axis the
    encoder's output is whole on every rank, and so are k and v: each
    rank's product with its columns of ``enc_kv_proj``, gathered
    (``ModelAxis.product``), the backward summing the ranks' gradients
    (each xattn block reads its own heads' part of them)."""
    if not model.cfg.encoder_layers:
        raise ValueError(f"{model.cfg.name} has no encoder")
    return model.encode(enc_frames)


def _forward(model: LM, tokens, ctx: Ctx | None, vision_embeds=None,
             enc_frames=None, positions=None):
    """(logits, the f32 sum of the attn_moe blocks' aux losses in walk
    order).  Each block runs under ``remat`` as one unit, its aux loss an
    output of that unit, so a recompute in the backward adds nothing.
    Over a model axis the logits are this rank's vocabulary columns."""
    _check_ctx(model, ctx)
    x = model.embed_tokens(tokens, vision_embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    # Without frames the reference runs the decoder without
    # cross-attention.
    enc_kv = None
    if model.cfg.encoder_layers and enc_frames is not None:
        enc_kv = lm_encode(model, enc_frames)
    mesh = _mesh(ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, _, block in model.walk():
        kw = {"mesh": mesh}
        if isinstance(block, AttnBlock):
            kw["positions"] = positions
        if isinstance(block, XAttnBlock):
            kw["enc_kv"] = enc_kv
        if isinstance(block, AttnMoEBlock):
            x, a = _maybe_remat(model.cfg, functools.partial(
                block.forward_aux, **kw))(x)
            aux = aux + a
        else:
            x = _maybe_remat(model.cfg, functools.partial(block, **kw))(x)
    return model.logits(x), aux


def apply_lm(model: LM, tokens, *, ctx: Ctx | None = None,
             vision_embeds=None, enc_frames=None, positions=None):
    """Logits (B, S, V) of tokens (B, S) int.  ``vision_embeds`` (B,
    S_vis, D) replace the first S_vis embeddings; ``enc_frames`` (B, T, D)
    drive the encoder, whose keys and values every xattn block attends
    to; ``positions`` ((B, S), or (3, B, S) under M-RoPE) reach every
    attention block, ``arange(S)`` when not given.  ``ctx.mesh`` shards
    the mixers' scans under ``gspn_impl="sp"``.  A model sharded over a
    model axis gathers the vocabulary's columns (``lm_loss`` never
    does)."""
    return _whole_logits(model, _forward(model, tokens, ctx, vision_embeds,
                                         enc_frames, positions)[0])


def lm_loss(model: LM, batch, *, ctx: Ctx | None = None):
    """batch: dict(tokens (B, S), labels (B, S), [mask], [vision_embeds],
    [enc_frames]).  Returns (ce + aux, {"ce", "aux"}): ``aux`` is the
    attn_moe blocks' summed aux loss (0 for a model without them), as in
    the reference.  Over a model axis the cross entropy is
    vocab-parallel (``ModelAxis.cross_entropy``)."""
    logits, aux = _forward(model, batch["tokens"], ctx,
                           batch.get("vision_embeds"),
                           batch.get("enc_frames"))
    ce = (model.tp.cross_entropy if model.tp is not None
          else cross_entropy_loss)(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def init_lm_cache(cfg: LMConfig, batch: int, max_len: int, *, device,
                  model_axis=None):
    """Zeroed decode caches of ``batch`` sequences, in the reference's
    layout (per stage key, leading (n,) or (n_units, n) axes, and
    ``shared_attn`` with (n_units,)); an attn, attn_moe or xattn stage's
    KV cache holds ``max_len`` positions, the other kinds' state does not
    depend on it (nor do the encoder's keys and values live here).  Over
    ``model_axis`` (a sharded model's ``model.model_axis``) a KV cache is
    this rank's part, as ``parallel.sharding.cache_shardings`` places it:
    its kv heads where they divide the axis, else its slice of the
    positions; the O(W) GSPN state, the conv tails and SSM states of the
    mamba kind and the mlstm and slstm states are whole on every rank."""
    def stacked(kind, lead):
        kw = {"model_axis": model_axis} \
            if kind in ("attn", "attn_moe", "xattn") else {}
        one = KINDS[kind].init_cache(cfg, batch, max_len, device=device,
                                     **kw)
        return {k: v.expand(lead + v.shape).clone() for k, v in one.items()}

    caches = {}
    for si, (where, kind, n) in enumerate(cfg.stages()):
        _check_kind(kind)
        caches[_stage_key(si, kind)] = stacked(
            kind, (n,) if where == "prelude" else (cfg.n_units, n))
    if cfg.shared_attn:
        caches["shared_attn"] = stacked("attn", (cfg.n_units,))
    return caches


def _store(caches, key, idx, layer_cache):
    for name, v in layer_cache.items():
        caches[key][name][idx].copy_(v)


def lm_prefill(model: LM, tokens, max_len: int, *, ctx: Ctx | None = None,
               vision_embeds=None, enc_kv=None):
    """Forward over the prompt (B, S) that also fills the decode caches,
    whose KV caches hold ``max_len`` positions; ``vision_embeds`` replace
    the first embeddings, as in :func:`apply_lm`, the positions stay
    ``arange(S)``, and the xattn blocks attend to ``enc_kv`` from
    :func:`lm_encode`.  Returns (logits (B, S, V), caches).  A model
    sharded over a model axis runs its layers as in training, fills this
    rank's part of each KV cache and the whole of every other cache leaf
    (:func:`init_lm_cache`'s ``model_axis``), reads ``enc_kv`` whole and
    gathers the logits."""
    _check_ctx(model, ctx)
    x = model.embed_tokens(tokens, vision_embeds)
    caches = init_lm_cache(model.cfg, tokens.shape[0], max_len,
                           device=x.device, model_axis=model.model_axis)
    for key, idx, block in model.walk():
        kw = {"enc_kv": enc_kv} if isinstance(block, XAttnBlock) else {}
        x, layer_cache = block.prefill(x, max_len, mesh=_mesh(ctx), **kw)
        _store(caches, key, idx, layer_cache)
    return _whole_logits(model, model.logits(x)), caches


def _whole_logits(model: LM, logits):
    """The logits over the whole vocabulary (gathered over a model
    axis)."""
    if model.tp is not None:
        logits = model.tp.gather(logits, -1, partial=False)
    return logits


def supports_chunked_prefill(cfg: LMConfig) -> bool:
    """True iff the model has no encoder, every block kind, the shared
    block's ``attn`` included, resumes from its cache (the gspn, attn and
    attn_moe kinds do; xattn, mamba, mlstm and slstm do not, as in the
    reference) and, with a gspn stage, the fold width is fixed
    (row_width > 0)."""
    if cfg.encoder_layers:
        return False
    kinds = {kind for _, kind, _ in cfg.stages()}
    if cfg.shared_attn:
        kinds.add("attn")
    if not all(k in KINDS and _has_chunk_path(k) for k in kinds):
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
    head: only the last chunk's logits feed sampling.  A model with a
    kind that has no chunked prefill (xattn, mamba, mlstm, slstm)
    raises."""
    _unsharded(model, "lm_prefill_chunk")
    missing = sorted({kind for _, kind, _ in model.cfg.stages()
                      if not _has_chunk_path(kind)})
    if missing:
        raise ValueError(f"{model.cfg.name}: the {', '.join(missing)} "
                         f"kind has no chunked prefill; use lm_prefill")
    x = model.embed_tokens(tokens)
    new = {k: {n: torch.empty_like(v) for n, v in sub.items()}
           for k, sub in caches.items()}
    for key, idx, block in model.walk():
        layer = {n: v[idx] for n, v in caches[key].items()}
        x, layer_cache = block.prefill_chunk(x, layer, off,
                                             mesh=_mesh(ctx))
        _store(new, key, idx, layer_cache)
    return (model.logits(x) if with_logits else None), new


def lm_decode_step(model: LM, token, caches, *, ctx: Ctx | None = None,
                   enc_kv=None):
    """token: (B, 1) int.  Returns (logits (B, 1, V), new_caches).  The
    step is O(W) per gspn layer; the xattn blocks attend to ``enc_kv``
    from :func:`lm_encode`.  A model sharded over a model axis reads and
    writes this rank's part of each KV cache (split by kv heads or by
    positions, ``models.attention.Attention.decode``) and the whole of
    every other leaf (the recurrent mixers gather their heads' new
    states), and gathers the logits."""
    _check_ctx(model, ctx)
    x = model.embed_tokens(token)
    new = {k: {n: torch.empty_like(v) for n, v in sub.items()}
           for k, sub in caches.items()}
    for key, idx, block in model.walk():
        layer = {n: v[idx] for n, v in caches[key].items()}
        kw = {"enc_kv": enc_kv} if isinstance(block, XAttnBlock) else {}
        x, layer_cache = block.decode(x, layer, **kw)
        _store(new, key, idx, layer_cache)
    return _whole_logits(model, model.logits(x)), new


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_active_params(cfg: LMConfig) -> int:
    """The reference's ``count_active_params`` (the 6·N·D convention's N,
    from the config alone): each block's projection weights (an attn_moe
    block's router, top-k experts and shared expert; an xattn block's two
    attentions), the shared attn block once, the embedding and an untied
    head.  Norm scales, biases, the conv, the mixers' small vectors and,
    as in the reference, the encoder are left out."""
    d = cfg.d_model
    attn_p = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
    ffn_p = (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff
    total = 0
    for where, kind, n in cfg.stages():
        _check_kind(kind)
        reps = n if where == "prelude" else n * cfg.n_units
        if kind == "attn":
            total += reps * (attn_p + ffn_p)
        elif kind == "attn_moe":
            total += reps * (attn_p + moe_active_param_count(moe_config(cfg)))
        elif kind == "xattn":
            total += reps * (2 * attn_p + ffn_p)
        elif kind == "mamba":
            mc = mamba_config(cfg)
            total += reps * (d * (2 * mc.d_inner + 2 * mc.d_state
                                  + mc.n_heads) + mc.d_inner * d)
        elif kind == "mlstm":
            mc = mlstm_config(cfg)
            total += reps * (d * (4 * mc.d_inner + 2 * mc.n_heads)
                             + mc.d_inner * d)
        elif kind == "slstm":
            total += reps * (5 * d * d + 4 * d * slstm_config(cfg).head_dim)
        elif kind == "gspn":
            cp = cfg.gspn_proxy_dim
            total += reps * (d * cp + 3 * d + d + 4 * d * cp + cp * d + ffn_p)
    if cfg.shared_attn:
        total += attn_p + ffn_p
    total += cfg.vocab * d
    if not cfg.tie_embeddings:
        total += cfg.vocab * d
    return total
