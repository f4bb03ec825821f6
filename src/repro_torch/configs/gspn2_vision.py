"""GSPN-2 vision configs (the paper's own architecture, Table 2).

Parameter/MAC targets: T 24M/4.2G, S 50M/9.2G, B 89M/14.2G at 224².
Paper ImageNet setting: channel-shared taps, C_proxy = 2.
"""

from repro_torch.models.vision import GSPNVisionConfig

GSPN2_T = GSPNVisionConfig(
    name="gspn2-t", img_size=224,
    dims=(80, 160, 320, 512), depths=(3, 4, 14, 5), proxy_dim=2)

GSPN2_S = GSPNVisionConfig(
    name="gspn2-s", img_size=224,
    dims=(96, 192, 432, 648), depths=(4, 6, 16, 6), proxy_dim=2)

GSPN2_B = GSPNVisionConfig(
    name="gspn2-b", img_size=224,
    dims=(128, 256, 512, 768), depths=(4, 6, 19, 8), proxy_dim=2)

# GSPN-1 algorithmic mode (per-channel propagation weights).
GSPN1_T = GSPNVisionConfig(
    name="gspn1-t", img_size=224,
    dims=(80, 160, 320, 512), depths=(3, 4, 14, 5), proxy_dim=8,
    channel_shared=False)

VISION_CONFIGS = {c.name: c for c in [GSPN2_T, GSPN2_S, GSPN2_B, GSPN1_T]}


def reduced_vision() -> GSPNVisionConfig:
    return GSPNVisionConfig(
        name="gspn2-reduced", img_size=32,
        dims=(16, 32, 48, 64), depths=(1, 1, 2, 1), proxy_dim=2,
        n_classes=10)
