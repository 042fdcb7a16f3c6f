"""The port's fills (raster/fills.py) against the JAX package's, bit for
bit: each fill's colour plane over a pixel box, its single-pixel colour, and
the same after ``transform`` and ``changecolour``.  Both sides compute the
plane on the host in float64 with the reference's roundings; the port
uploads the int32 result to the device it is given.  Tolerance 0.
"""

import numpy as np
import pytest

from _torch_general import JAX, PORT, SIDES, assert_same_sprite
from _torch_threads import one_torch_thread  # noqa: F401


def _texture(seed, h, w):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 1))
    return np.concatenate([(rng.integers(0, 256, (h, w, 3)) * a) // 255, a], -1)


def _make(side, kind):
    C, F = side.C, side.fills
    half_blue = C.dissolve(C.blue, delta=99)
    if kind == "plain":
        return F.plain(C.dissolve(C.teal, delta=140))
    if kind == "dummy":
        return F.dummy
    if kind == "dummyfancy":
        return F.dummyfancy
    if kind == "gradient":
        return F.gradient((3.5, 4.25), (40.0, 22.0), True, False, C.red, half_blue)
    if kind == "gradient_noext":
        return F.gradient((10.0, 30.0), (30.0, 8.0), False, False, C.gold, C.purple)
    if kind == "gradient_point":
        return F.gradient((10.0, 10.0), (10.0, 10.0), True, True, C.gold, C.purple)
    if kind == "radial":
        return F.radial((20.0, 15.0), (24.0, 15.0), (45.0, 15.0), True, True, C.gold, half_blue)
    if kind == "radial_noext":
        return F.radial((25.5, 12.5), (28.0, 14.0), (40.0, 20.0), False, False, C.red, C.green)
    if kind == "radial_flat":
        return F.radial((20.0, 15.0), (24.0, 15.0), (20.0, 19.0), False, True, C.red, C.green)
    if kind == "radial2":
        return F.radial2((18.0, 14.0), (21.0, 14.0), (30.0, 20.0), (52.0, 20.0), False, True, C.white, half_blue)
    if kind == "radial2_cone":
        return F.radial2((10.0, 14.0), (12.0, 14.0), (40.0, 14.0), (42.0, 14.0), True, True, C.red, C.teal)
    if kind == "texture":
        return F.texture(_texture(1, 5, 7), (0.0, 0.0, 7.0, 5.0), 9.0, 6.0, (1.5, 0.2, -0.1, 1.25, 3.0, 2.0))
    if kind == "image":
        return F.image_fill(_texture(2, 6, 9), (50.0, 5.0, -4.0, 30.0, 6.0, 3.0))
    if kind == "masked":
        mask = np.random.default_rng(3).integers(0, 256, (8, 8))
        return F.MaskedFill(F.gradient((3.5, 4.25), (40.0, 22.0), True, True, C.red, half_blue), mask,
                            (60.0, 0.0, 0.0, 40.0, 2.0, 1.0))
    if kind == "masked_plain":
        mask = np.random.default_rng(4).integers(0, 256, (4, 5))
        return F.MaskedFill(F.plain(C.gold), mask, (60.0, 0.0, 0.0, 40.0, 2.0, 1.0))
    raise KeyError(kind)


KINDS = ["plain", "dummy", "dummyfancy", "gradient", "gradient_noext", "gradient_point", "radial", "radial_noext",
         "radial_flat", "radial2", "radial2_cone", "texture", "image", "masked", "masked_plain"]
TRANSFORMS = {
    "identity": (),
    "translate": (("Translate", 7.0, -3.5),),
    "scale": (("Scale", (10.0, 10.0), 1.5, 0.75),),
    "rotate": (("Rotate", (30.0, 20.0), 0.6), ("Translate", 2.0, 1.0)),
}
BOX, H, W = (-3, 2, 60, 40), 39, 64


def _plane(side, fill):
    return np.broadcast_to(np.asarray(fill.image(BOX, H, W)), (H, W, 4))


@pytest.mark.parametrize("t", list(TRANSFORMS))
@pytest.mark.parametrize("kind", KINDS)
def test_fill_plane_matches_jax(kind, t):
    got = []
    for side in SIDES:
        ops = [getattr(side.tr, name)(*args) for name, *args in TRANSFORMS[t]]
        f = _make(side, kind).transform(ops)
        got.append((f.kind, _plane(side, f), [f.single(x, y) for x, y in [(0, 5), (20, 15), (33, 21), (59, 39)]]))
    j, p = got
    assert j[0] == p[0]
    bad = np.argwhere((j[1] != p[1]).any(-1))
    assert len(bad) == 0, f"{len(bad)} pixels differ, first {bad[0]}: jax {j[1][tuple(bad[0])]}, port {p[1][tuple(bad[0])]}"
    assert j[2] == p[2]


@pytest.mark.parametrize("kind", KINDS)
def test_changecolour_and_device_plane_match_jax(kind):
    got = []
    for side in SIDES:
        f = _make(side, kind).changecolour(side.C.monochrome)
        dev = f.image_device(BOX, H, W) if side is JAX else f.image_device(BOX, H, W, "cpu")
        got.append((_plane(side, f), np.broadcast_to(side.np_plane(dev), (H, W, 4))))
    j, p = got
    assert np.array_equal(j[0], p[0]) and np.array_equal(j[1], p[1])
    assert np.array_equal(p[0], p[1]) and p[1].dtype == np.int32


@pytest.mark.parametrize("kind", ["plain", "gradient", "radial2", "texture", "masked"])
def test_fillshape_with_each_fill_matches_jax(kind):
    got = []
    for side in SIDES:
        mask = np.random.default_rng(9).random((H, W)) < 0.5
        mask[0, 0] = True
        shp = side.shape_of_mask((BOX[0], BOX[1], BOX[0] + W - 1, BOX[1] + H - 1), mask)
        got.append(side.region.fillshape(shp, _make(side, kind)))
    assert_same_sprite(got[0], got[1], kind)


def test_plain_fill_uploads_one_vector_per_colour_and_device():
    f = PORT.fills.plain(PORT.C.red)
    v = f.image_device(BOX, H, W, "cpu")
    assert tuple(v.shape) == (1, 1, 4)
    assert PORT.fills.plain(PORT.C.red).image_device((1, 1, 2, 2), 2, 2, "cpu") is v
