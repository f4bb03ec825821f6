"""The scan kernels' launch shape (``gspn_scan.pair_launch_shape``),
checked on the CPU: it is plain arithmetic on the operands' shape, and
the card's limits it must respect are numbers, not a device query.

Over W = 1…1024, cpw ∈ {1, 2, 3, 4, 8, 33}, H ∈ {1, 7, 56, 256}, float32
and bfloat16, the pair forward and adjoint and the forward over 1 and 4
directions (the quad on square grids): the ring fits in a CTA's shared
memory (232,448 bytes on the H100), 1 ≤ S ≤ H, 32·K ≥ W, at most 32
warps (and at most what the registers allow at K columns per lane), a
warp for every plane of the CTA, the grid covers every (plane,
direction) exactly once, and the quad's column slab has an odd pitch of
at least the words a run covers.  At the main path's shapes (G = 128,
cpw = 2, N = 56 / 28 / 14 / 7, float32) the shape is written out.
"""

import collections
import itertools

import pytest
import torch

from repro_torch.kernels.gspn_scan import (SMEM_MAX, PairLaunch,
                                           pair_launch_shape)

HS = (1, 7, 56, 256)
# Warps a CTA may hold at K columns per lane (the kernels' launch bounds).
MAX_WARPS = {1: 32, 2: 16, 4: 16, 8: 8, 16: 4, 32: 4}


def _ring_bytes(s: PairLaunch, w: int, item: int, per_plane: int) -> int:
    """The ring's bytes recomputed from the layout the source describes:
    nbuf stages, each 3 tap regions and per_plane regions per plane, each
    region ``batch`` rows of W items placed at their source's offset in its
    16-byte block and widened to whole words, in 16-byte units; for the
    quad (``xpitch`` > 0) every region is the larger of that and a column
    slab of W runs of ``xpitch`` words, in 16-byte units."""
    region = (s.batch * w * item + 18 + 15) // 16 * 16
    if s.xpitch:
        region = max(region, (w * s.xpitch * 4 + 15) // 16 * 16)
    return s.nbuf * (3 + per_plane * s.planes) * region


def _check_fits(s: PairLaunch, h: int, w: int, cpw: int, item: int,
                per_plane: int) -> None:
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
    assert s.planes * (s.splits - 1) < cpw <= s.planes * s.splits, where


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpw", [1, 2, 3, 4, 8, 33])
def test_shape_fits_the_card(cpw, dtype, direction):
    item = torch.empty((), dtype=dtype).element_size()
    per_plane = 2 if direction == "fwd" else 1
    for w in range(1, 1025):
        for h in HS:
            s = pair_launch_shape(2 * cpw, h, w, cpw, dtype, direction)
            _check_fits(s, h, w, cpw, item, per_plane)


def _cta_planes(s: PairLaunch, block, cpw: int) -> list[tuple[int, int]]:
    """The (plane, direction) pairs the CTA at grid index ``block``
    computes, as the kernels' ``Cta`` maps them: block (group, part of the
    group, direction), planes ``part * planes`` onwards within the group."""
    gw, split, d = block
    p0 = split * s.planes
    return [(gw * cpw + p, d) for p in range(p0, min(p0 + s.planes, cpw))]


@pytest.mark.parametrize("ndir", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpw", [1, 2, 3, 4, 8, 33])
def test_shape_fits_the_card_at_every_direction_count(cpw, dtype, ndir):
    """The forward over one direction at every H, and the quad on square
    grids (H = W), whose x region holds a column slab: W runs at an odd
    pitch (the 32 lanes of a step read 32 banks in float32) of at least
    the 4-byte words a run of a batch covers, a bfloat16 run starting
    mid-word included."""
    item = torch.empty((), dtype=dtype).element_size()
    for w in range(1, 1025):
        for h in (w,) if ndir == 4 else HS:
            s = pair_launch_shape(2 * cpw, h, w, cpw, dtype, "fwd", ndir)
            _check_fits(s, h, w, cpw, item, 2)
            assert s.grid == (2, s.splits, ndir), (w, s)
            if ndir == 1:
                assert s.xpitch == 0, (w, s)
                continue
            words = (s.batch * item + (2 if item == 2 else 0) + 3) // 4
            assert s.xpitch % 2 == 1 and words <= s.xpitch <= words + 1, \
                (w, s)


def _pair_shape_written_out(g, h, w, cpw, item, direction):
    """The pair's launch shape as the rule in ``pair_launch_shape``'s
    docstring gives it, written out for two directions: the planes the
    registers and two ring rows allow, split evenly; the whole plane in
    one batch when it fits in 64 rows, else min(H, 64) rows or fewer in
    four batches."""
    per_plane = 2 if direction == "fwd" else 1
    k = 1
    while 32 * k < w:
        k *= 2

    def ring(planes, batch, nbuf):
        return nbuf * (3 + per_plane * planes) * \
            ((batch * w * item + 18 + 15) // 16 * 16)

    planes = min(cpw, MAX_WARPS[k])
    while planes > 1 and ring(planes, 1, min(h, 2)) > SMEM_MAX:
        planes -= 1
    splits = -(-cpw // planes)
    planes = -(-cpw // splits)
    if h <= 64 and ring(planes, h, 1) <= SMEM_MAX:
        batch, nbuf = h, 1
    else:
        rows = min(h, 64)
        while True:
            batch = -(-rows // 4)
            nbuf = rows // batch
            if ring(planes, batch, nbuf) <= SMEM_MAX:
                break
            rows -= 1
    return PairLaunch(planes, max(planes, min(8, MAX_WARPS[k])), k, splits,
                      nbuf * batch, batch, nbuf, (g // cpw, splits, 2),
                      ring(planes, batch, nbuf))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_directions_keep_the_pair_shape(direction, dtype):
    """``ndir`` = 2, the default, gives the pair's shape as written out
    above, at every W and H of the sweep and cpw 1…33: the direction count
    changed nothing for the main path's kernels."""
    item = torch.empty((), dtype=dtype).element_size()
    for cpw in range(1, 34):
        for w in range(1, 1025, 7):
            for h in HS:
                want = _pair_shape_written_out(2 * cpw, h, w, cpw, item,
                                               direction)
                assert pair_launch_shape(2 * cpw, h, w, cpw, dtype,
                                         direction) == want, (cpw, w, h)
                assert pair_launch_shape(2 * cpw, h, w, cpw, dtype,
                                         direction, 2) == want


@pytest.mark.parametrize("ndir", [1, 4])
@pytest.mark.parametrize("gw,cpw,w", [(3, 1, 7), (2, 2, 56), (2, 3, 33),
                                      (1, 33, 64), (2, 33, 1024),
                                      (1, 8, 1000)])
def test_grid_covers_every_plane_and_direction_once_at_every_count(
        gw, cpw, w, ndir):
    g = gw * cpw
    s = pair_launch_shape(g, w, w, cpw, torch.float32, "fwd", ndir)
    assert s.grid == (gw, s.splits, ndir)
    blocks = list(itertools.product(*map(range, s.grid)))
    seen = collections.Counter(pd for block in blocks
                               for pd in _cta_planes(s, block, cpw))
    assert seen == {(p, d): 1 for p in range(g) for d in range(ndir)}
    assert all(1 <= len(_cta_planes(s, block, cpw)) <= s.planes
               for block in blocks)


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


# The single scan (1) and the quad (4) at the same shapes; the quad's
# column-slab pitch is odd.
MAIN_NDIR = {
    (1, 56): PairLaunch(2, 8, 2, 1, 56, 56, 1, (64, 1, 1), 88032),
    (1, 28): PairLaunch(2, 8, 1, 1, 28, 28, 1, (64, 1, 1), 22176),
    (1, 14): PairLaunch(2, 8, 1, 1, 14, 14, 1, (64, 1, 1), 5712),
    (1, 7): PairLaunch(2, 8, 1, 1, 7, 7, 1, (64, 1, 1), 1568),
    (4, 56): PairLaunch(2, 8, 2, 1, 56, 56, 1, (64, 1, 4), 89376, 57),
    (4, 28): PairLaunch(2, 8, 1, 1, 28, 28, 1, (64, 1, 4), 22736, 29),
    (4, 14): PairLaunch(2, 8, 1, 1, 14, 14, 1, (64, 1, 4), 5936, 15),
    (4, 7): PairLaunch(2, 8, 1, 1, 7, 7, 1, (64, 1, 4), 1568, 7),
}


@pytest.mark.parametrize("ndir,n", sorted(MAIN_NDIR))
def test_main_path_shapes_at_one_and_four_directions(ndir, n):
    """The whole plane in the ring as one batch, the weight group in one
    CTA: 64 CTAs for the single scan, 256 for the quad."""
    assert pair_launch_shape(128, n, n, 2, torch.float32, "fwd",
                             ndir) == MAIN_NDIR[ndir, n]


def test_quad_spreads_planes_to_fill_the_card():
    """At 1024² (G = 32, N = 256) whole weight groups would give the quad
    64 CTAs for 132 SMs: it takes one plane per CTA, 128 CTAs; the pair
    keeps its groups whole."""
    quad = pair_launch_shape(32, 256, 256, 2, torch.float32, "fwd", 4)
    assert (quad.planes, quad.splits, quad.grid) == (1, 2, (16, 2, 4))
    pair = pair_launch_shape(32, 256, 256, 2, torch.float32, "fwd")
    assert (pair.planes, pair.splits, pair.grid) == (2, 1, (16, 1, 2))


def test_ring_refills_past_64_rows():
    """A plane taller than the ring's 64 rows streams through it in four
    batches of 16 rows."""
    s = pair_launch_shape(4, 65, 56, 2, torch.float32, "fwd")
    assert (s.stages, s.batch, s.nbuf) == (64, 16, 4)


def test_shape_refuses_an_unknown_direction():
    with pytest.raises(ValueError, match="direction"):
        pair_launch_shape(4, 7, 7, 2, torch.float32, "quad")


@pytest.mark.parametrize("direction,ndir", [("fwd", 3), ("fwd", 0),
                                            ("bwd", 1), ("bwd", 4)])
def test_shape_refuses_an_unknown_direction_count(direction, ndir):
    with pytest.raises(ValueError, match="ndir"):
        pair_launch_shape(4, 7, 7, 2, torch.float32, direction, ndir)
