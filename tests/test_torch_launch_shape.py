"""The pair kernels' launch shape (``gspn_multidir.pair_launch_shape``),
checked on the CPU: it is plain arithmetic on the operands' shape, and
the card's limits it must respect are numbers, not a device query.

Over W = 1…1024, cpw ∈ {1, 2, 3, 4, 8, 33}, H ∈ {1, 7, 56, 256}, float32
and bfloat16, forward and adjoint: the ring fits in a CTA's shared memory
(232,448 bytes on the H100), 1 ≤ S ≤ H, 32·K ≥ W, at most 32 warps (and
at most what the registers allow at K columns per lane), a warp for every
plane of the CTA, and the grid covers every (plane, direction) exactly
once.  At the main path's shapes (G = 128, cpw = 2, N = 56 / 28 / 14 / 7,
float32) the shape is written out.
"""

import collections
import itertools

import pytest
import torch

from repro_torch.kernels.gspn_multidir import (SMEM_MAX, PairLaunch,
                                               pair_launch_shape)

HS = (1, 7, 56, 256)
# Warps a CTA may hold at K columns per lane (the kernels' launch bounds).
MAX_WARPS = {1: 32, 2: 16, 4: 16, 8: 8, 16: 4, 32: 4}


def _ring_bytes(s: PairLaunch, w: int, item: int, per_plane: int) -> int:
    """The ring's bytes recomputed from the layout the source describes:
    nbuf stages, each 3 tap regions and per_plane regions per plane, each
    region ``batch`` rows of W items placed at their source's offset in its
    16-byte block and widened to whole words, in 16-byte units."""
    region = (s.batch * w * item + 18 + 15) // 16 * 16
    return s.nbuf * (3 + per_plane * s.planes) * region


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpw", [1, 2, 3, 4, 8, 33])
def test_shape_fits_the_card(cpw, dtype, direction):
    item = torch.empty((), dtype=dtype).element_size()
    per_plane = 2 if direction == "fwd" else 1
    for w in range(1, 1025):
        for h in HS:
            s = pair_launch_shape(2 * cpw, h, w, cpw, dtype, direction)
            where = (w, h, s)
            assert s.smem_bytes == _ring_bytes(s, w, item, per_plane), where
            assert s.smem_bytes <= SMEM_MAX, where
            assert 1 <= s.stages <= h, where
            assert s.stages == s.nbuf * s.batch, where
            assert 1 <= s.nbuf <= 8, where
            assert s.nbuf > 1 or s.batch >= h, where  # one buffer: no refill
            assert s.k in MAX_WARPS and 32 * s.k >= w, where
            assert s.k == 1 or 16 * s.k < w, where    # the smallest such K
            assert 1 <= s.planes <= s.warps <= MAX_WARPS[s.k] <= 32, where
            assert s.planes * (s.splits - 1) < cpw <= s.planes * s.splits, \
                where


def _cta_planes(s: PairLaunch, block, cpw: int) -> list[tuple[int, int]]:
    """The (plane, direction) pairs the CTA at grid index ``block``
    computes, as the kernels' ``Cta`` maps them: block (group, part of the
    group, direction), planes ``part * planes`` onwards within the group."""
    gw, split, d = block
    p0 = split * s.planes
    return [(gw * cpw + p, d) for p in range(p0, min(p0 + s.planes, cpw))]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("gw,cpw,w", [(3, 1, 7), (2, 2, 56), (2, 3, 33),
                                      (1, 33, 64), (2, 33, 1024),
                                      (1, 8, 1000)])
def test_grid_covers_every_plane_and_direction_once(gw, cpw, w, direction):
    g = gw * cpw
    s = pair_launch_shape(g, 56, w, cpw, torch.float32, direction)
    assert s.grid == (gw, s.splits, 2)
    blocks = list(itertools.product(*map(range, s.grid)))
    seen = collections.Counter(pd for block in blocks
                               for pd in _cta_planes(s, block, cpw))
    assert seen == {(p, d): 1 for p in range(g) for d in (0, 1)}
    # Every CTA has at least one plane, and no more than its planes.
    assert all(1 <= len(_cta_planes(s, block, cpw)) <= s.planes
               for block in blocks)


# G = 128, cpw = 2, float32: planes, warps, K, splits, S, batch, nbuf,
# grid, bytes.
MAIN = {
    ("fwd", 56): PairLaunch(2, 8, 2, 1, 56, 56, 1, (64, 1, 2), 88032),
    ("fwd", 28): PairLaunch(2, 8, 1, 1, 28, 28, 1, (64, 1, 2), 22176),
    ("fwd", 14): PairLaunch(2, 8, 1, 1, 14, 14, 1, (64, 1, 2), 5712),
    ("fwd", 7): PairLaunch(2, 8, 1, 1, 7, 7, 1, (64, 1, 2), 1568),
    ("bwd", 56): PairLaunch(2, 8, 2, 1, 56, 56, 1, (64, 1, 2), 62880),
    ("bwd", 28): PairLaunch(2, 8, 1, 1, 28, 28, 1, (64, 1, 2), 15840),
    ("bwd", 14): PairLaunch(2, 8, 1, 1, 14, 14, 1, (64, 1, 2), 4080),
    ("bwd", 7): PairLaunch(2, 8, 1, 1, 7, 7, 1, (64, 1, 2), 1120),
}


@pytest.mark.parametrize("direction,n", sorted(MAIN))
def test_main_path_shapes(direction, n):
    """At every main width the whole plane is in the ring (S = H) as one
    batch; one warp per plane of a group and six more that copy, one CTA
    per group and direction."""
    assert pair_launch_shape(128, n, n, 2, torch.float32,
                             direction) == MAIN[direction, n]


def test_ring_refills_past_64_rows():
    """A plane taller than the ring's 64 rows streams through it in four
    batches of 16 rows."""
    s = pair_launch_shape(4, 65, 56, 2, torch.float32, "fwd")
    assert (s.stages, s.batch, s.nbuf) == (64, 16, 4)


def test_shape_refuses_an_unknown_direction():
    with pytest.raises(ValueError, match="direction"):
        pair_launch_shape(4, 7, 7, 2, torch.float32, "quad")
