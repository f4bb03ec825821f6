"""qwen2-vl-72b: M-RoPE, dynamic resolution [arXiv:2409.12191].

80 attn layers, d_model 8192, 64 heads over 8 kv heads (head dim 128),
d_ff 29 568, vocab 152 064, qkv bias, rope theta 1e6, M-RoPE sections
16/24/24 of the 64 frequency slots (temporal, height, width).  The vision
frontend is a stub, as in the reference: precomputed patch embeddings
(B, S_vis, D) replace the first S_vis token embeddings.
72 706 203 648 parameters (290.8 GB in f32): one card holds the full
config only on ``meta``; at full width it runs a few of the 80 layers
(2 layers: 4 246 794 240 parameters, 17.0 GB in f32).
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        unit=(("attn", 80),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-reduced", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512, qkv_bias=True, mrope_sections=(4, 2, 2),
        unit=(("attn", 2),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="qwen2-vl-72b", family="vlm", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="arXiv:2409.12191"))
