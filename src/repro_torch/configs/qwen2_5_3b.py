"""qwen2.5-3b: GQA with qkv bias [hf:Qwen/Qwen2.5-0.5B].

36 layers, d_model 2048, 16 heads over 2 kv heads (G = 8), d_ff 11 008,
vocab 151 936, tied embeddings, rope theta 1e6.
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6,
        unit=(("attn", 36),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen2.5-reduced", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=176, vocab=512, qkv_bias=True, tie_embeddings=True,
        unit=(("attn", 3),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="qwen2.5-3b", family="dense", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="hf:Qwen/Qwen2.5-0.5B"))
