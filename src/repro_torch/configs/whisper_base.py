"""whisper-base: encoder-decoder, conv frontend stubbed
[arXiv:2212.04356; unverified].

Decoder: 6 xattn layers, d_model 512, 8 heads (8 kv), d_ff 2048, vocab
51 865, GELU MLP and layernorm as in the original.  Encoder: 6
non-causal layers over stub frame embeddings (enc_len 1500, 30 s of
audio) with learned positions.  As in the reference, the decoder rotates
its positions (rope, theta 1e4) where the original learns them.
98 505 728 parameters, 78 275 584 of them counted active (the encoder is
not counted); the whole model runs on one card.
"""

from repro_torch.configs.base import ArchEntry, FULL_ATTENTION_SKIP, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=51865, mlp="gelu", norm="layernorm",
        encoder_layers=6, enc_len=1500, rope_theta=1e4,
        unit=(("xattn", 6),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="whisper-reduced", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, mlp="gelu", norm="layernorm",
        encoder_layers=2, enc_len=32,
        unit=(("xattn", 2),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="whisper-base", family="audio", full=full, reduced=reduced,
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
    source="arXiv:2212.04356 (unverified)"))
