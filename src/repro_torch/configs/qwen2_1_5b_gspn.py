"""qwen2-1.5b-gspn: qwen2-1.5b's dimensions with the GSPN-2 sequence mixer
in place of attention (a beyond-paper variant of the reference).

The mixer is O(√L)-sequential with an O(W) decode cache (DESIGN.md §4);
row width 1024 folds 524 288 tokens into a 512 × 1024 grid.  No
checkpoint of it is published: the port serves seeded weights.
"""

from repro_torch.configs.base import ArchEntry, register
from repro_torch.models.lm import LMConfig


def full(n_model_shards: int = 1) -> LMConfig:
    return LMConfig(
        name="qwen2-1.5b-gspn", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, tie_embeddings=True,
        gspn_proxy_dim=8, gspn_row_width=1024,
        unit=(("gspn", 28),), n_units=1,
        n_model_shards=n_model_shards,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen2-gspn-reduced", family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, tie_embeddings=True,
        gspn_proxy_dim=4, gspn_row_width=8,
        unit=(("gspn", 2),), n_units=1, remat="none",
    )


register(ArchEntry(
    name="qwen2-1.5b-gspn", family="dense", full=full, reduced=reduced,
    skip_shapes={},   # GSPN mixer: sub-quadratic, all shapes run
    source="beyond-paper variant (this work)"))
