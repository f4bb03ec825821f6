"""qwen1.5-32b: MHA with qkv bias [hf:Qwen/Qwen1.5-0.5B].

64 layers, d_model 5120, 40 heads over 40 kv heads (G = 1), d_ff 27 392,
vocab 152 064, an untied head, rope theta 1e6.  35.2 G parameters, 141 GB
in f32: one card holds it only on ``meta`` (its full width waits for
parallelism, ROADMAP.md §1 item 6).
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1e6,
        unit=(("attn", 64),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen1.5-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=512, qkv_bias=True,
        unit=(("attn", 2),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="qwen1.5-32b", family="dense", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="hf:Qwen/Qwen1.5-0.5B"))
