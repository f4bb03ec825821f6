"""granite-3-2b: GQA without qkv bias [hf:ibm-granite/granite-3.0-2b-base].

40 layers, d_model 2048, 32 heads over 8 kv heads (G = 4), d_ff 8192,
vocab 49 155, tied embeddings, rope theta 1e4.
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=49155, tie_embeddings=True, rope_theta=1e4,
        unit=(("attn", 40),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="granite-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab=512, tie_embeddings=True,
        unit=(("attn", 2),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="granite-3-2b", family="dense", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="hf:ibm-granite/granite-3.0-2b-base"))
