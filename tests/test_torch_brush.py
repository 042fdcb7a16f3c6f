"""The port's scalar brush route (raster/brush.py) against the JAX
package's, bit for bit: a brush stroke's shape, its sprite (the stamp walk
alpha_over-ing the brush at every point of the path, then the fill dissolved
by the accumulated alpha) and the smear.  Tolerance 0.
"""

import numpy as np
import pytest

from _torch_general import JAX, PORT, SIDES, assert_same_shape, assert_same_sprite, both_sides  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def _path(side, kind):
    gp, gs = side.gpath, side.gshapes
    if kind == "circle":
        return gs.circle(60.0, 50.0, 30.0)
    if kind == "line":
        return gp.Path(gp.EVEN_ODD, (gp.Subpath(False, False, (gp.Straight((15.0, 20.0), (95.0, 70.0)),)),))
    return gp.Path(gp.EVEN_ODD, (gp.Subpath(False, False, (
        gp.Bezier((10.0, 70.0), (40.0, -20.0), (70.0, 120.0), (110.0, 30.0)),)),))


BRUSHES = {"soft": (6.0, 0.5), "hard": (3.5, 1.0), "wide": (15.0, 0.25)}
PATHS = ["circle", "line", "curve"]


def _stroke(side, brush, path):
    return (side.brush.mkround(*BRUSHES[brush]), _path(side, path))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("brush", list(BRUSHES))
def test_shape_of_brushstroke_matches_jax(brush, path):
    got = []
    for side in SIDES:
        bs = _stroke(side, brush, path)
        got.append((side.shape_of_brushstroke(bs), side.shape_of_brushstroke(side.brush.mkdummy(bs)),
                    side.brush.bounds_brushstroke(bs), side.brush.sizeof_brush(bs[0]),
                    side.brush.points_of_brushstroke(bs), side.brush.mkdummy(bs)[0]))
    j, t = got
    for k in (0, 1):
        assert_same_shape(j[k][0], t[k][0], "shape")
        assert_same_shape(j[k][1], t[k][1], "minshape")
    assert j[2:] == t[2:]


@pytest.mark.parametrize("colour", ["red", "half_teal"])
@pytest.mark.parametrize("brush", list(BRUSHES))
def test_drawbrush_rgba_matches_jax(brush, colour):
    got = []
    for side in SIDES:
        c = {"red": side.C.red, "half_teal": side.C.dissolve(side.C.teal, delta=128)}[colour]
        b = side.brush.mkround(*BRUSHES[brush])
        got.append((side.brush.drawbrush_rgba(b, c), side.brush.drawround_alpha(*BRUSHES[brush])))
    assert np.array_equal(got[0][0], got[1][0]) and np.array_equal(got[0][1], got[1][1])


@pytest.mark.parametrize("fill", ["plain", "gradient"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("brush", list(BRUSHES))
def test_sprite_of_brushstroke_matches_jax(brush, path, fill):
    got = []
    for side in SIDES:
        C, F = side.C, side.fills
        f = {"plain": F.plain(C.dissolve(C.darkorange, delta=185)),
             "gradient": F.gradient((10.0, 10.0), (100.0, 80.0), True, True, C.blue, C.gold)}[fill]
        bs = _stroke(side, brush, path)
        shp, _ = side.shape_of_brushstroke(bs)
        part = side.region.shape_intersection(shp, side.shape_of_box((30, 25, 75, 60)))
        got.append([side.sprite_of_brushstroke(bs, f, s) for s in (shp, part, None)])
    for k in range(3):
        assert_same_sprite(got[0][k], got[1][k], f"case {k}")


@pytest.mark.parametrize("t", [(("Translate", 10.0, -4.0),), (("Scale", (0.0, 0.0), 1.5, 1.5),),
                               (("Translate", 5.0, 5.0), ("Scale", (20.0, 20.0), 0.5, 0.5))])
def test_transform_brushstroke_matches_jax(t):
    got = []
    for side in SIDES:
        bs = _stroke(side, "soft", "curve")
        for name, *args in reversed(t):
            bs = side.brush.transform_brushstroke(getattr(side.tr, name)(*args), bs)
        got.append((bs[0], repr(bs[1]), side.shape_of_brushstroke(bs)[0]))
    assert got[0][:2] == got[1][:2]
    assert_same_shape(got[0][2], got[1][2], "transformed stroke")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("brush", ["soft", "hard"])
def test_smear_matches_jax(brush, path):
    """A smear drags the colours of a sprite along the stroke."""
    got = []
    for side in SIDES:
        C, F = side.C, side.fills
        rng = np.random.default_rng(7)
        mask = rng.random((90, 120)) < 0.9
        mask[0, 0] = True
        shp = side.shape_of_mask((1, 1, 120, 90), mask)
        spr = side.region.fillshape(shp, F.gradient((1.0, 1.0), (120.0, 90.0), True, True, C.red, C.dissolve(C.blue, delta=90)))
        bs = _stroke(side, brush, path)
        got.append((side.smear(spr, bs), side.brush.points_of_brushstroke_smear(bs),
                    side.brush.find_smear_directions(side.brush.points_of_brushstroke_smear(bs))))
    assert_same_sprite(got[0][0], got[1][0], "smear")
    assert got[0][1] == got[1][1] and got[0][2] == got[1][2]
