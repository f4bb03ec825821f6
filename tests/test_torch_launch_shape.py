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

from repro_torch.kernels.gspn_scan import (BANDS, DIRECT_ROWS, SMEM_MAX,
                                           PairLaunch, pair_launch_shape)

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
                                            ("bwd", 3), ("bwd", 4)])
def test_shape_refuses_an_unknown_direction_count(direction, ndir):
    with pytest.raises(ValueError, match="ndir"):
        pair_launch_shape(4, 7, 7, 2, torch.float32, direction, ndir)


@pytest.mark.parametrize("direction,ndir,h,layout", [
    ("fwd", 1, 7, {"bands": 2}), ("bwd", 2, 7, {"bands": 2}),
    ("bwd", 1, 7, {"bands": 3}), ("bwd", 1, 7, {"bands": 64}),
    ("fwd", 1, 7, {"direct": True}), ("bwd", 2, 7, {"direct": True}),
    ("bwd", 1, 7, {"window_k": 3, "direct": True}),
    ("bwd", 1, 7, {"window_k": 2}), ("bwd", 1, 7, {"bands": 17, "direct": True}),
    ("bwd", 1, 64, {"direct": True}), ("bwd", 1, 16, {"window_k": 1, "direct": True})])
def test_shape_refuses_a_layout_it_has_no_instance_for(direction, ndir, h,
                                                       layout):
    """Only the single adjoint spreads a row over warps: in power-of-two
    bands of 1 to 4 columns per lane, or in windows of 32, 64 or 128
    columns read straight from device memory, wider than 2H, as many to a
    CTA as the registers allow."""
    with pytest.raises(ValueError, match="bands|direct|window_k"):
        pair_launch_shape(4, h, 1024, 2, torch.float32, direction, ndir,
                          **layout)


def _single_adjoint_fits(s: PairLaunch, h: int, w: int, cpw: int,
                         item: int) -> None:
    """The single adjoint's shape: the pair's bounds with ``bands`` warps
    to a plane, each a band of 32·k columns, the bands' edge products (16
    bytes a warp) after the ring and a named barrier per banded plane; or
    direct: ``bands`` warps a plane each walking a window of 32·k columns
    from device memory and storing 32·k − 2H of them, no ring, no copy
    warps, no shared memory."""
    where = (w, h, s)
    if s.direct:
        tile = 32 * s.k - 2 * h
        windows, groups = -(-w // tile), s.grid[1] // s.splits
        assert s.k == (2 if 8 * h <= 64 else 4) and tile >= 1, where
        assert s.bands <= MAX_WARPS[s.k], where
        assert groups == -(-windows // s.bands), where
        assert groups == 1 or s.bands == -(-windows // groups), where
        assert s.warps == s.planes * s.bands and s.smem_bytes == 0, where
        assert (s.batch, s.nbuf) == (h, 1), where
    else:
        edges = 16 * s.warps if s.bands > 1 else 0
        assert s.smem_bytes == _ring_bytes(s, w, item, 1) + edges, where
        assert 32 * s.k * s.bands >= w, where
        assert s.k * s.bands == 1 or 16 * s.k * s.bands < w, where
        assert s.bands == 1 or (s.k <= 4 and s.planes <= 15), where
    assert s.smem_bytes <= SMEM_MAX, where
    assert 1 <= s.stages <= h and s.stages == s.nbuf * s.batch, where
    assert 1 <= s.nbuf <= 8 and (s.nbuf > 1 or s.batch >= h), where
    assert s.k in MAX_WARPS, where
    assert 1 <= s.planes * s.bands <= s.warps <= MAX_WARPS[s.k], where
    assert s.planes * (s.splits - 1) < cpw <= s.planes * s.splits, where
    assert s.xpitch == 0, where


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpw", [1, 2, 3, 4, 8, 33])
def test_single_adjoint_shape_fits_the_card(cpw, dtype):
    """Over W = 1…1024 and H ∈ {1, 7, 16, 17, 56, 256}: a row that needs 8
    or more columns per lane (W > 128) is walked in windows straight from
    device memory on a plane of at most ``DIRECT_ROWS`` rows (64 columns
    while the two halos of H take at most a quarter of that, else 128),
    and spread over ``BANDS`` warps from the ring on a taller one; a
    narrower row is walked whole by one warp from the ring."""
    item = torch.empty((), dtype=dtype).element_size()
    for w in range(1, 1025):
        for h in (1, 7, 16, 17, 56, 256):
            s = pair_launch_shape(2 * cpw, h, w, cpw, dtype, "bwd", 1)
            _single_adjoint_fits(s, h, w, cpw, item)
            assert s.grid[0] == 2 and s.grid[2] == 1, (w, s)
            assert s.direct or s.grid[1] == s.splits, (w, s)
            assert s.direct == (w > 128 and h <= DIRECT_ROWS), (w, h, s)
            if not s.direct:
                assert s.bands == (BANDS if w > 128 else 1), (w, h, s)


@pytest.mark.parametrize("h", [16, 56])
@pytest.mark.parametrize("bands", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("gw,cpw,w", [(3, 1, 7), (2, 2, 56), (2, 3, 33),
                                      (1, 33, 64), (2, 33, 1024),
                                      (1, 8, 1000), (16, 8, 1024),
                                      (16, 2, 256)])
def test_single_adjoint_grid_covers_every_plane_and_column_once(gw, cpw, w,
                                                                bands, h):
    """Every plane is computed by exactly one CTA and, within it, every
    column by exactly one (warp, lane, slot): plane ``warp // bands`` of
    the CTA, column ``(warp % bands)·32k + lane + 32·slot``, as the
    kernel's ``pw`` and ``col`` map them; at every band count the sweep
    may ask for where the row allows it, on a short plane (H = 16) and a
    taller one (H = 56)."""
    k = 1 << max(0, -(-w // 32) - 1).bit_length()
    if bands > 1 and not 1 <= k // bands <= 4:
        return
    g = gw * cpw
    s = pair_launch_shape(g, h, w, cpw, torch.float32, "bwd", 1,
                          bands=bands)
    assert s.grid == (gw, s.splits, 1) and s.bands == bands
    assert not s.direct

    blocks = list(itertools.product(*map(range, s.grid)))
    seen = collections.Counter(pd for block in blocks
                               for pd in _cta_planes(s, block, cpw))
    assert seen == {(p, 0): 1 for p in range(g)}
    cols = collections.Counter(
        (warp // bands, (warp % bands) * 32 * s.k + lane + 32 * slot)
        for warp in range(s.planes * bands) for lane in range(32)
        for slot in range(s.k))
    assert all(cols[p, c] == 1 for p in range(s.planes) for c in range(w))


@pytest.mark.parametrize("layout", [{}, {"window_k": 2}, {"window_k": 1},
                                    {"bands": 3}])
@pytest.mark.parametrize("g,h,w,cpw", [(128, 4, 1024, 8), (6, 1, 1000, 3),
                                       (4, 12, 160, 2), (66, 9, 256, 33),
                                       (2, 12, 1024, 1), (8, 5, 129, 4)])
def test_direct_windows_store_every_column_once(g, h, w, cpw, layout):
    """Direct: window b of a plane is the 32·k columns from c0 = b·tile − H
    (tile = 32·k − 2H) and stores columns c0 + H … c0 + 32·k − H − 1
    within 0 … W − 1; the CTA at grid y takes windows (y // splits)·bands
    … + bands − 1 of planes (y % splits)·planes … of its weight group, as
    the kernel's ``window``, ``c0`` and ``keep`` have it.  Over the grid
    every column of every plane is stored exactly once, at least H columns
    inside its window."""
    if 32 * layout.get("window_k", 2 if 8 * h <= 64 else 4) <= 2 * h:
        return
    s = pair_launch_shape(g, h, w, cpw, torch.float32, "bwd", 1,
                          direct=True, **layout)
    tile = 32 * s.k - 2 * h
    stored = collections.Counter()
    for gw, y in itertools.product(range(s.grid[0]), range(s.grid[1])):
        group, split = divmod(y, s.splits)
        for p in range(split * s.planes, min(split * s.planes + s.planes,
                                             cpw)):
            for band in range(s.bands):
                c0 = (group * s.bands + band) * tile - h
                for c in range(max(c0 + h, 0), min(c0 + 32 * s.k - h, w)):
                    stored[gw * cpw + p, c] += 1
    assert stored == {(p, c): 1 for p in range(g) for c in range(w)}


# The single adjoint (G, H, W, cpw, float32) where it is timed: the main
# widths, 1024², and the LM mixer's two passes at cpw 8.
SINGLE_BWD = {
    (128, 56, 56, 2): PairLaunch(1, 8, 2, 2, 56, 56, 1, (64, 2, 1), 50304),
    (128, 28, 28, 2): PairLaunch(1, 8, 1, 2, 28, 28, 1, (64, 2, 1), 12672),
    (128, 14, 14, 2): PairLaunch(1, 8, 1, 2, 14, 14, 1, (64, 2, 1), 3264),
    (128, 7, 7, 2): PairLaunch(1, 8, 1, 2, 7, 7, 1, (64, 2, 1), 896),
    (32, 256, 256, 2): PairLaunch(1, 8, 1, 2, 48, 16, 3, (16, 2, 1), 197120,
                                  bands=8),
    (128, 4, 1024, 8): PairLaunch(1, 10, 2, 8, 4, 4, 1, (16, 16, 1), 0,
                                  bands=10, direct=True),
    (128, 1024, 4, 8): PairLaunch(1, 8, 1, 8, 64, 16, 4, (16, 8, 1), 4608),
    (128, 32, 1024, 8): PairLaunch(1, 8, 4, 8, 12, 4, 3, (16, 8, 1), 197120,
                                   bands=8),
}


@pytest.mark.parametrize("shape", list(SINGLE_BWD))
def test_single_adjoint_shapes(shape):
    """One plane per CTA wherever whole weight groups would leave SMs idle
    (128 CTAs at the main widths and at the LM's shapes, 32 at 1024²);
    rows of more than 128 columns banded over 8 warps from the ring, and on
    the LM's T→B pass (4 rows of 1024) walked in 19 windows of 64 columns
    straight from device memory, each storing 56, 10 to a CTA (256
    CTAs)."""
    assert pair_launch_shape(*shape, torch.float32, "bwd", 1) == \
        SINGLE_BWD[shape]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 2, 1024])
@pytest.mark.parametrize("w", [1, 2, 4, 1024])
def test_single_scan_at_the_serving_shapes(w, h, dtype):
    """#1 at the LM serving path's planes, cpw 8 (C_proxy): T→B passes of
    1 or 2 rows of 1024 columns, within-row passes of 1024 rows of 1 to 4
    columns, and the crossings, for one request (G = 8) and four (G =
    32).  The ring fits, every plane is covered once, and a plane of 1024
    rows streams through the ring in batches."""
    item = torch.empty((), dtype=dtype).element_size()
    for g in (8, 32):
        s = pair_launch_shape(g, h, w, 8, dtype, "fwd", 1)
        _check_fits(s, h, w, 8, item, 2)
        assert s.grid == (g // 8, s.splits, 1), s
        blocks = list(itertools.product(*map(range, s.grid)))
        seen = collections.Counter(pd for block in blocks
                                   for pd in _cta_planes(s, block, 8))
        assert seen == {(p, 0): 1 for p in range(g)}, s
        if h == 1024:
            assert s.nbuf > 1 and s.stages < h, s


def test_single_scan_refuses_rows_wider_than_1024():
    """Past 1 048 576 tokens the within-row pass would give #1 rows of
    more than 1024 columns: the launch raises before reaching the card,
    it never falls back to the plain scan."""
    from repro_torch.kernels import gspn_scan
    x = torch.zeros((8, 4, 1025))
    taps = torch.zeros((1, 4, 1025))
    with pytest.raises(ValueError, match="exceeds 1024"):
        gspn_scan.launch(1, gspn_scan.KERNEL, x, taps, taps, taps, x, None)
