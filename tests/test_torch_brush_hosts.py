"""The brush kernels' refusals, held against the hosts that feed them, on
the CPU.

``kernels.brush_plane_lists`` and ``brush_piece_lists`` (brush_stamp's
lists) refuse a valid stamp whose patch leaves its plane, and
``kernels.smear_steps`` a smear step whose patch or source leaves its
canvas or whose direction is not a unit step, where the JAX package's
``dynamic_slice`` would clamp them (coherence_tpu/raster/brush.py:191-197
for stamps, :338-345 for the smear) and paint shifted pixels.  smear.cu's
window mode relies on the smear's refusal.  Here hypothesis (a fixed seed)
draws strokes at the edges of each host's plane, radii 1 to 120, and every
list the host makes is packed as its kernel's wrapper packs it:

  * ``sprite_of_brushstroke``: its stamps over the twice-bloated plane of
    the stroke's shape, the shape cut by a random box through the stroke;
  * ``BrushTileBuild.add_stroke``: a group's stamps and points over its
    plane of tiles, the stroke crossing the frame's edges;
  * ``smear``: its steps over the canvas flattened around a sprite the
    stroke runs off.

No list is refused: the refusals guard inputs no host makes.
"""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from coherence_tpu_torch import colour as C
from coherence_tpu_torch import kernels
from coherence_tpu_torch.geometry import path as gpath
from coherence_tpu_torch.raster import brush as TB
from coherence_tpu_torch.raster import brush_tiles as TBT
from coherence_tpu_torch.raster import fills, region

from _torch_threads import one_torch_thread  # noqa: F401


def _polyline(corners):
    segs = tuple(gpath.Straight(a, b) for a, b in zip(corners, corners[1:]))
    return gpath.Path(gpath.EVEN_ODD, (gpath.Subpath(False, False, segs),))


def _corners(lo: float, hi: float):
    """2 to 4 polyline corners in [lo, hi]^2."""
    point = st.tuples(st.floats(lo, hi, allow_nan=False), st.floats(lo, hi, allow_nan=False))
    return st.lists(point, min_size=2, max_size=4)


_RADII = st.floats(1.0, 120.0, allow_nan=False)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(_RADII, _corners(0.0, 300.0), st.tuples(*[st.integers(-50, 350)] * 4))
def test_sprite_of_brushstroke_never_makes_an_off_plane_stamp(radius, corners, cut):
    """Every valid stamp sprite_of_brushstroke makes keeps its patch on the
    twice-bloated plane, for the stroke's shape cut by any box."""
    stamped = []

    def stamp(brushes, offsets, valid, hp, wp, device):
        stamped.append(kernels.brush_plane_lists(brushes, offsets, valid, hp, wp))
        return torch.zeros((len(brushes), hp, wp), dtype=torch.int32)

    stroke = (TB.mkround(radius, 0.5), _polyline(corners))
    shp = TB.shape_of_brushstroke(stroke, "cpu")[0]
    x0, y0, x1, y1 = cut
    box = region.shape_of_box((min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)), "cpu")
    real = TB._stamp_alpha
    TB._stamp_alpha = stamp
    try:
        for s in (shp, region.shape_intersection(shp, box)):
            if s is not None and not region.is_null_shape(s):
                TB.sprite_of_brushstroke(stroke, fills.plain(C.red), s, "cpu")
    finally:
        TB._stamp_alpha = real
    if shp is not None and not region.is_null_shape(shp):
        assert stamped  # the whole shape keeps every stamp point


@settings(max_examples=30, deadline=None, derandomize=True)
@given(_RADII, _corners(-150.0, 650.0), st.integers(1, 4), st.integers(1, 5))
def test_brush_tile_build_never_makes_an_off_plane_stamp(radius, corners, nty, ntx):
    """Every group BrushTileBuild stages packs: its valid stamps keep their
    padded patches on the group's plane, for strokes across the frame's
    edges."""
    build = TBT.BrushTileBuild(nty, ntx, "cpu")
    assert build.add_stroke("s", (TB.mkround(radius, 0.5), _polyline(corners)), np.array([90, 40, 10, 120], np.int32))
    for (hp, wp, _, _, npb), items in build.groups.items():
        kernels.brush_piece_lists(*TBT._group_lists(npb, items), hp, wp)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(_RADII, _corners(-100.0, 400.0), st.tuples(*[st.integers(1, 300)] * 4))
def test_smear_never_makes_an_off_canvas_step(radius, corners, box):
    """Every step smear() hands its walk keeps its patch and source on the
    canvas, with a unit direction, for strokes running off the sprite."""
    steps = []

    def walk(cv, opac, offsets, dirs, bh, bw):
        steps.append(kernels.smear_steps(offsets, dirs, bh, bw, *cv.shape[:2]))
        return cv

    x0, y0, x1, y1 = box
    spr = region.fillshape(region.shape_of_box((min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)), "cpu"),
                           fills.plain(C.dissolve(C.blue, delta=90)))
    real = TB._smear_walk
    TB._smear_walk = walk
    try:
        TB.smear(spr, (TB.mkround(radius, 0.5), _polyline(corners)), "cpu")
    finally:
        TB._smear_walk = real
    assert all(len(s) for s in steps)
