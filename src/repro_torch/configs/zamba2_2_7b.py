"""zamba2-2.7b: Mamba-2 layers with one weight-shared attention block
[arXiv:2411.15242].

54 Mamba-2 layers (d_model 2560, SSM state 64, head dim 64: 80 heads of
the 5120-wide inner stream), and after every 6 of them the one shared
attention block (32 heads over 32, d_ff 10240): 9 applications of one
weight set, 63 blocks applied.  Vocab 32 000, untied.
"""

from repro_torch.configs.base import ArchEntry, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000, ssm_state=64, ssm_head_dim=64,
        unit=(("mamba", 6),), n_units=9, shared_attn=True,
        gla_chunk=256,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="zamba2-reduced", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, ssm_state=16, ssm_head_dim=16,
        unit=(("mamba", 2),), n_units=2, shared_attn=True,
        gla_chunk=32, remat="none",
    )


register(ArchEntry(
    name="zamba2-2.7b", family="hybrid", full=full, reduced=reduced,
    skip_shapes={},   # Mamba2 decode is O(1); shared-attn KV is seq-sharded
    source="arXiv:2411.15242"))
