"""The port's stroker and dasher (geometry/shapes.py, geometry/dash.py: host
copies) against the originals, the anti-aliased polygon sprite
(raster/aa.py) on stroked and filled edge lists, and a stroked path through
the port's tile build against the JAX package's tile build.  Tolerance 0.
"""

import numpy as np
import pytest

from coherence_tpu.scene import fastframe as JF
from coherence_tpu_torch.scene import fastframe as TF

from _torch_general import JAX, PORT, SIDES, assert_same_shape, assert_same_sprite, both_sides  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

CAPS = ["ButtCap", "RoundCap", "ProjectingCap"]
JOINS = ["RoundJoin", "MitredJoin", "BevelJoin"]


def _paths(side):
    gp, gs = side.gpath, side.gshapes
    zig = [(10.0, 10.0), (60.0, 18.0), (25.0, 40.0), (70.0, 65.0), (12.0, 58.0)]
    open_zig = gp.Path(gp.EVEN_ODD, (gp.Subpath(False, False, tuple(gp.Straight(zig[k], zig[k + 1]) for k in range(4))),))
    curve = gp.Path(gp.NONZERO, (gp.Subpath(False, False, (
        gp.Bezier((8.0, 50.0), (30.0, -10.0), (60.0, 90.0), (85.0, 30.0)),
        gp.Straight((85.0, 30.0), (90.0, 70.0)),
    )),))
    return {
        "circle": gs.circle(45.5, 40.25, 28.0),
        "rectangle": gs.rectangle(12.0, 9.5, 60.0, 44.0),
        "closed_zig": gp.path_of_pointlist(gp.NONZERO, zig),
        "open_zig": open_zig,
        "curve": curve,
    }


def _spec(side, cap, join, width=5.0, mitre=10.0):
    gs = side.gshapes
    return gs.StrokeSpec(startcap=getattr(gs, cap), endcap=getattr(gs, cap), join=getattr(gs, join),
                         mitrelimit=mitre, linewidth=width)


@pytest.mark.parametrize("join", JOINS)
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("path", ["circle", "rectangle", "closed_zig", "open_zig", "curve"])
def test_strokepath_copy_matches_original(path, cap, join):
    got = []
    for side in SIDES:
        p, spec = _paths(side)[path], _spec(side, cap, join)
        got.append((side.gshapes.strokepath(spec, p), repr(side.gshapes.strokepath_polygon(spec, p)),
                    side.gshapes.bounds_stroke(p, spec)))
    j, t = got
    assert np.array_equal(j[0], t[0]) and j[0].dtype == t[0].dtype
    assert j[1] == t[1] and j[2] == t[2]


@pytest.mark.parametrize("width,mitre", [(0.5, 1.0), (2.0, 1.5), (11.0, 4.0), (3.0, 100.0)])
def test_stroke_widths_and_mitre_limits_match_original(width, mitre):
    got = [side.gshapes.strokepath(_spec(side, "ButtCap", "MitredJoin", width, mitre), _paths(side)["closed_zig"]) for side in SIDES]
    assert np.array_equal(got[0], got[1])


def test_shape_helpers_match_original():
    for side_fn in (lambda s: s.gshapes.arc((10.0, 0.0), (0.0, 10.0), (0.0, 0.0)),
                    lambda s: s.gshapes.arc((0.0, 10.0), (-7.0, -7.0), (0.0, 0.0)),
                    lambda s: s.gshapes.crosspoint((0.0, 0.0), (1.0, 1.0), (4.0, 0.0), (-1.0, 1.0)),
                    lambda s: s.gshapes.rotation((0.0, 0.0), (1.0, 0.0), (0.0, 1.0)),
                    lambda s: s.gshapes.restrict_angle(0.5, 7.6),
                    lambda s: s.gshapes.angle_to((1.0, 1.0), (4.0, 5.0))):
        assert repr(side_fn(JAX)) == repr(side_fn(PORT))


@pytest.mark.parametrize("dashes,phase", [((6.0, 3.0), 0.0), ((10.0, 2.0, 1.0, 2.0), 4.5), ((2.0,), 1.0), ((0.0, 5.0), 0.0), ((), 0.0)])
@pytest.mark.parametrize("path", ["circle", "open_zig", "curve"])
def test_dash_copy_matches_original(path, dashes, phase):
    got = []
    for side in SIDES:
        dashed = side.dash.dash_path(_paths(side)[path], list(dashes), phase)
        got.append((repr(dashed), side.gshapes.strokepath(_spec(side, "RoundCap", "RoundJoin", 2.0), dashed)))
    assert got[0][0] == got[1][0]
    assert np.array_equal(got[0][1], got[1][1])


@pytest.mark.parametrize("winding", ["NONZERO", "EVEN_ODD"])
@pytest.mark.parametrize("path", ["circle", "closed_zig", "open_zig", "curve"])
def test_shapeminshape_of_stroke_edgelist_matches_jax(path, winding):
    got = []
    for side in SIDES:
        edges = side.gshapes.strokepath(_spec(side, "RoundCap", "MitredJoin", 7.0), _paths(side)[path])
        got.append(side.shapeminshape_of_edgelist(edges, getattr(side.gpath, winding)))
    assert_same_shape(got[0][0], got[1][0], "shape")
    assert_same_shape(got[0][1], got[1][1], "minshape")
    for side in SIDES:
        assert side.shapeminshape_of_edgelist(np.zeros((0, 4), np.int64), side.gpath.NONZERO) == (None, None)


def test_scaled_mask_of_edgelist_matches_jax():
    got = []
    for side in SIDES:
        edges = side.gshapes.strokepath(_spec(side, "ButtCap", "BevelJoin", 3.0), _paths(side)["closed_zig"])
        got.append(side.scanline.scaled_mask_of_edgelist(edges, side.gpath.EVEN_ODD, 16))
        assert side.scanline.scaled_mask_of_edgelist(np.zeros((0, 4), np.int64), side.gpath.EVEN_ODD, 16) is None
    (jx, jy, jm), (tx, ty, tm) = got
    assert (jx, jy) == (tx, ty) and np.array_equal(jm, tm)


@pytest.mark.parametrize("bands", ["budget", "one_row"])
@pytest.mark.parametrize("fill", ["plain", "gradient"])
@pytest.mark.parametrize("path", ["circle", "closed_zig", "open_zig", "curve"])
def test_polygon_sprite_edgelist_matches_jax(path, fill, bands, both_sides, monkeypatch):
    """The AA sprite of a stroked outline (even-odd matte) over its whole
    shape, over its fringe only, and over a shape that sticks out of it;
    the port's coverage in bands of its sample budget and in bands of one
    pixel row (a pixel's value depends on its own footprint alone)."""
    if bands == "one_row":
        monkeypatch.setattr(PORT.aa, "_BAND_SAMPLES", 1)
    got = []
    for side in SIDES:
        C, F = side.C, side.fills
        f = {"plain": F.plain(C.dissolve(C.crimson, delta=170)),
             "gradient": F.gradient((10.0, 10.0), (80.0, 60.0), True, True, C.gold, C.teal)}[fill]
        p = _paths(side)[path]
        edges = side.gshapes.strokepath(_spec(side, "RoundCap", "RoundJoin", 6.0), p)
        shp, minshp = side.shapeminshape_of_edgelist(edges, side.gpath.NONZERO)
        fringe = side.region.boxshape(side.region.shape_difference(shp, minshp))
        beyond = side.shape_of_box((shp.box[0] - 3, shp.box[1] + 5, shp.box[0] + 30, shp.box[1] + 25))
        got.append([side.aa.polygon_sprite_edgelist(f, s, edges, side.gpath.EVEN_ODD) for s in (shp, fringe, beyond, None)]
                   + [side.aa.polygon_sprite(f, side.region.boxshape(shp), p)])
    for k in range(5):
        assert_same_sprite(got[0][k], got[1][k], f"case {k}")


def _stroked_scene(side):
    C, R = side.C, side.R
    out = []
    specs = [("circle", "ButtCap", "RoundJoin", 9.0, C.red, ()),
             ("closed_zig", "ButtCap", "MitredJoin", 4.0, C.dissolve(C.blue, delta=150), (("Scale", (0.0, 0.0), 2.5, 2.0),)),
             ("open_zig", "RoundCap", "BevelJoin", 6.0, C.teal, (("Translate", 120.0, 30.0),)),
             ("curve", "ProjectingCap", "RoundJoin", 12.0, C.dissolve(C.gold, delta=200), (("Translate", 20.0, 90.0), ("Scale", (0.0, 0.0), 2.0, 1.0)))]
    for path, cap, join, width, col, t in specs:
        shape = R.StrokedPathShape(_paths(side)[path], _spec(side, cap, join, width))
        ops = tuple(getattr(side.tr, name)(*args) for name, *args in t)
        out.append(R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(col), shape), ops, R.OVER))
    out.append(R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.white), R.rectangle(5.0, 5.0, 240.0, 180.0)), (), R.OVER))
    return out


def test_stroked_paths_through_the_tile_build_match_jax(both_sides):
    """Stroked objects take the tile rasterizer on both sides (the shape by
    nonzero winding, the AA matte by even-odd): same pieces, same atlas,
    same frame; and the frame equals the general renderer's."""
    W, H = 256, 192
    jv = JF.DeviceView(W, H, atlas_cap=128)
    jv.set_scene(_stroked_scene(JAX), tiled=True)
    jv.render(full=True)
    pscene = _stroked_scene(PORT)
    pv = TF.DeviceView(W, H, atlas_cap=128, device="cpu")
    pv.set_scene(pscene, tiled=True)
    pv.render(full=True)
    assert [list(pv.ts.pieces[k]) for k in pv.order] == [list(jv.ts.pieces[k]) for k in jv.order]
    assert pv.ts._n_pieces == jv.ts._n_pieces
    assert np.array_equal(pv.ts.atlas().numpy(), np.asarray(jv.ts.atlas()).view(np.int32))
    assert np.array_equal(pv.frame.numpy(), np.asarray(jv.frame).view(np.int32))
    assert np.array_equal(np.array(pv.read()), np.array(jv.read()))
    # The tile route against the general renderer over the same window: the
    # pixels the general renderer defines are the frame's.
    spr = PORT.render_simple_scene(pscene, PORT.shape_of_box((1, 1, W, H)))
    (x0, y0, x1, y1), m, rgba = PORT.np_sprite(spr)
    tile = np.array(pv.read())[y0 - 1 : y1, x0 - 1 : x1]
    opaque = m & (rgba[..., 3] == 255)
    assert opaque.any() and np.array_equal(tile[opaque], rgba[opaque])
