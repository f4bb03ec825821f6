"""grok-1-314b: 8 experts, top-2 [hf:xai-org/grok-1; unverified].

64 attn_moe layers, d_model 6144, 48 heads over 8 kv heads, each expert's
hidden width 32 768, vocab 131 072, capacity factor 1.25.
316 489 340 928 parameters, 84 560 314 368 active: one card holds the
full config only on ``meta``; at full width it runs 2 layers
(11 450 578 944 parameters, 45.8 GB in f32) or 1 (6 530 598 912, 13.1
GB under ``bf16``).  The reference lays the slabs out for a 16-way model
axis (ep = 8, tp = 2); the port runs ``full(m)``'s slabs over a model
axis of m ranks (``parallel.tensor_parallel``) and refuses them without
one.
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072, rope_theta=1e4,
        n_experts=8, top_k=2, moe_d_ff=32768,
        capacity_factor=1.25,
        unit=(("attn_moe", 64),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="grok-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        n_experts=4, top_k=2, moe_d_ff=128, capacity_factor=2.0,
        unit=(("attn_moe", 2),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="grok-1-314b", family="moe", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="hf:xai-org/grok-1 (unverified)"))
