"""kimi-k2-1t-a32b: a trillion-parameter MoE [arXiv:2501.kimi2;
unverified].

61 layers, d_model 7168, 64 heads over 8 kv heads, vocab 163 840: one
dense attn layer (d_ff 18 432), then 60 attn_moe layers of 384 experts
(hidden 2048), top-8, and one shared expert (hidden 2048); capacity
factor 1.25.  1 027 291 575 296 parameters, 33 743 962 112 active: one
card holds the full config only on ``meta``; at full width it runs the
dense layer and one attn_moe layer (19 934 645 248 parameters, 39.9 GB
under ``bf16``).
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=18432,                 # the single dense layer's FFN
        vocab=163840, rope_theta=5e4,
        n_experts=384, top_k=8, moe_d_ff=2048, shared_expert_ff=2048,
        capacity_factor=1.25,
        prelude=(("attn", 1),), unit=(("attn_moe", 60),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="kimi-reduced", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512,
        n_experts=8, top_k=2, moe_d_ff=32, shared_expert_ff=32,
        capacity_factor=2.0,
        prelude=(("attn", 1),), unit=(("attn_moe", 2),), n_units=1,
        remat="none",
    )


register(ArchEntry(
    name="kimi-k2-1t-a32b", family="moe", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="arXiv:2501.kimi2 (unverified)"))
