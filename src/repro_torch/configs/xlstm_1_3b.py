"""xlstm-1.3b: mLSTM and sLSTM blocks [arXiv:2405.04517].

48 layers, d_model 2048, 4 heads, vocab 50 304, untied: 6 units of 7
mLSTM blocks and 1 sLSTM block.  The blocks carry their own up and down
projections (the mLSTM's inner width is 2 x d_model, so its heads are
1024 wide), hence d_ff 0: no FFN.
"""

from repro_torch.configs.base import ArchEntry, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        unit=(("mlstm", 7), ("slstm", 1)), n_units=6,
        gla_chunk=256,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="xlstm-reduced", family="ssm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=512,
        unit=(("mlstm", 1), ("slstm", 1)), n_units=2,
        gla_chunk=32, remat="none",
    )


register(ArchEntry(
    name="xlstm-1.3b", family="ssm", full=full, reduced=reduced,
    skip_shapes={},   # sub-quadratic: all four shapes run
    source="arXiv:2405.04517 (unverified)"))
