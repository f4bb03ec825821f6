"""qwen2-1.5b: GQA with qkv bias [arXiv:2407.10671].

28 layers, d_model 1536, 12 heads over 2 kv heads (G = 6), d_ff 8960,
vocab 151 936, tied embeddings, rope theta 1e6.  The baseline of
``qwen2-1.5b-gspn``, which keeps these dimensions and puts the GSPN-2
mixer in place of attention.
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6,
        unit=(("attn", 28),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen2-reduced", family="dense",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_ff=128, vocab=512, qkv_bias=True, tie_embeddings=True,
        unit=(("attn", 2),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="qwen2-1.5b", family="dense", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="arXiv:2407.10671"))
