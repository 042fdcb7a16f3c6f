"""The port's demo scenes (scene/examples.py), the icon renderer
(scene/icons.py) and the lion benchmark shrunk, each rendered on both sides
through ``render_simple_scene`` and compared bit for bit (box, mask,
colours).

Every demo is rendered in a 256 x 256 window centred on it, over two
backdrop objects moved under it, so that the filter demos have a scene to
read.
"""

import os

import numpy as np
import pytest

from _torch_general import JAX, PORT, SIDES, assert_same_sprite, both_sides, dense  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

DEMOS = ["redblob", "blueblob", "cpg_example", "affinefilter", "blurfilter", "rgbfilter", "brush", "brushcircle",
         "brushblue", "minusfilter", "monofilter", "q_shape", "q_shape_2", "logo", "radial_filled", "wirecircle", "hole",
         "wireframe", "p6_curve", "p6_curve2", "p6_curve3", "curves", "smear", "wirebrush", "monobrush", "curve",
         "smalllion", "aatext", "mintext1", "mintext2", "filtertext1", "filtertext2", "lionfilter1", "lionfilter2"]


def _centred_scene(side, demo):
    R, E = side.R, side.examples
    xmin, xmax, ymin, ymax = R.bounds_of_basicshape(demo)
    cx, cy = (xmin + xmax) // 2, (ymin + ymax) // 2
    below = [R.position_anchor(R.Centre, (float(cx + 15), float(cy + 10)), E.cpg_example()),
             R.position_anchor(R.Centre, (float(cx - 30), float(cy - 20)), E.blueblob())]
    return [demo] + below, (cx - 127, cy - 127, cx + 128, cy + 128)


@pytest.mark.parametrize("name", DEMOS)
def test_demo_scene_matches_jax(name, both_sides):
    got = []
    for side in SIDES:
        scene, window = _centred_scene(side, getattr(side.examples, name)())
        got.append((side.render_simple_scene(scene, side.shape_of_box(window)), window))
    assert got[0][1] == got[1][1]
    assert got[0][0] is not None
    assert_same_sprite(got[0][0], got[1][0], name)


def test_swaptoptwo_matches_jax(both_sides):
    got = []
    for side in SIDES:
        E = side.examples
        objs = [E.redblob(), E.blueblob(), E.cpg_example()]
        scene = [E.swaptoptwo(objs)] + objs
        got.append(side.render_simple_scene(scene, side.shape_of_box((1, 1, 256, 256))))
    assert_same_sprite(got[0], got[1], "swaptoptwo")


ICONS = ["down", "up", "pointer", "zoom", "brushcurve"]


@pytest.mark.parametrize("name", ICONS)
def test_icon_of_pdf_matches_jax(name, both_sides):
    """The icon PDFs hold stroked paths: the smallest user of a stroked
    PDF path through the general renderer."""
    got = []
    for side in SIDES:
        fname = os.path.join(side.examples.path, name + ".pdf")
        icon = side.icon_of_pdf(fname)
        got.append((icon.origin, side.np_plane(icon.rgba)))
    assert got[0][0] == got[1][0] and got[1][1].shape == (32, 32, 4)
    assert np.array_equal(got[0][1], got[1][1])
    assert (got[1][1][..., 3] > 0).any()  # something was drawn


def _fitted_lion(side, size):
    R, tr = side.R, side.tr
    lion = side.examples.smalllion()
    xmin, xmax, ymin, ymax = R.bounds_of_basicshape(lion)
    scale = float(size) / max(xmax - xmin, ymax - ymin)
    return R.transform_renderobject_many(
        [tr.Translate(0.0, float(size)), tr.Scale((0.0, 0.0), 1.0, -1.0), tr.Scale((0.0, 0.0), scale, scale),
         tr.Translate(-xmin, -ymin)], lion)


def test_lion_benchmark_shrunk_cold_rebuild_warm(both_sides):
    """The lion benchmark of the JAX package's benchmarks/run.py (config 1)
    fitted to 192 pixels: the cold render, the rebuild after cache.clear()
    and the warm render are equal, and equal to the JAX side's."""
    size = 192
    renders = []
    for side in SIDES:
        obj = _fitted_lion(side, size)
        shape = side.shape_of_box((1, 1, size, size))
        cold = side.render_simple_scene([obj], shape)
        side.cache.clear()
        rebuilt = side.render_simple_scene([obj], shape)
        hits = side.cache.cachestats.sprhit
        warm = side.render_simple_scene([obj], shape)
        assert side.cache.cachestats.sprhit > hits  # the warm render came from the cache
        renders.append((cold, rebuilt, warm))
    for k, what in enumerate(["cold", "rebuilt", "warm"]):
        assert_same_sprite(renders[0][k], renders[1][k], what)
        assert_same_sprite(renders[0][0], renders[1][k], what + " against cold")


def test_bounds_and_counts_of_the_pdf_scenes_match_jax():
    for name in ("smalllion", "aatext", "lionfilter2"):
        j, t = getattr(JAX.examples, name)(), getattr(PORT.examples, name)()
        assert len(j.geometry.objects) == len(t.geometry.objects)
        assert JAX.R.bounds_of_basicshape(j) == PORT.R.bounds_of_basicshape(t)
        assert [type(o.geometry.shape).__name__ for o in j.geometry.objects] == [type(o.geometry.shape).__name__ for o in t.geometry.objects]
