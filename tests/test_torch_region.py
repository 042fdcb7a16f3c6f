"""The port's shapes and sprites (raster/region.py) against the JAX
package's, bit for bit: the same host masks and colour planes, made from a
numpy seed, go through each side's function and the results are compared in
box, in the mask over the box, and in the ``full_box`` flag or the colour
plane.  Tolerance 0.

Boxes are part of the result (``caf``, ``shape_union`` and ``bloat`` leave
them loose, ``boxshape`` tightens), and so is ``full_box``: later operations
branch on it.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from coherence_tpu_torch import convert

from _torch_general import JAX, PORT, SIDES, assert_same_shape, assert_same_sprite, both_sides  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def _mask(rng, h, w, kind):
    if kind == "full":
        return np.ones((h, w), dtype=bool)
    if kind == "sparse":
        m = np.zeros((h, w), dtype=bool)
        m[rng.integers(0, h), rng.integers(0, w)] = True
        return m
    if kind == "inner":  # loose box: content well inside
        m = np.zeros((h, w), dtype=bool)
        m[h // 3 : h // 2 + 1, w // 4 : w // 2 + 1] = rng.random((h // 2 + 1 - h // 3, w // 2 + 1 - w // 4)) < 0.7
        m[h // 3, w // 4] = True
        return m
    m = rng.random((h, w)) < 0.5
    m[0, 0] = True
    return m


def _operand(side, seed, kind, x0, y0, w, h):
    """One shape of `kind` over the box at (x0, y0) of w x h pixels:
    "box" is shape_of_box, the others go through shape_of_mask."""
    box = (x0, y0, x0 + w - 1, y0 + h - 1)
    if kind == "box":
        return side.shape_of_box(box)
    return side.shape_of_mask(box, _mask(np.random.default_rng(seed), h, w, kind))


def _sprite(side, seed, x0, y0, w, h, opaque=False):
    """A sprite with random premultiplied colours under a random mask."""
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < 0.6
    mask[0, 0] = True
    a = np.full((h, w, 1), 255) if opaque else rng.choice([0, 1, 90, 254, 255], (h, w, 1))
    rgb = (rng.integers(0, 256, (h, w, 3)) * a) // 255
    shp = side.shape_of_mask((x0, y0, x0 + w - 1, y0 + h - 1), mask)
    canvas_rgba = np.concatenate([rgb, a], -1).astype(np.int32)
    if side is JAX:
        import jax.numpy as jnp

        canvas = side.region.Canvas(jnp.asarray(canvas_rgba), (x0, y0))
    else:
        canvas = convert.canvas(canvas_rgba, (x0, y0), "cpu")
    return side.region.pickup(shp, canvas)


KINDS = ["mask", "box", "full", "sparse", "inner"]
# (x0, y0, w, h) of the second operand against a first at (5, 7, 40, 23):
# overlapping, contained, containing, disjoint, touching at one corner.
PLACES = {
    "overlap": (20, 12, 40, 30),
    "inside": (10, 9, 12, 9),
    "around": (1, 2, 70, 50),
    "disjoint": (90, 70, 10, 10),
    "corner": (44, 29, 9, 9),
}


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("kb", KINDS)
@pytest.mark.parametrize("ka", KINDS)
def test_set_algebra_matches_jax(ka, kb, place):
    got = []
    for side in SIDES:
        a = _operand(side, 1, ka, 5, 7, 40, 23)
        b = _operand(side, 2, kb, *PLACES[place])
        r = side.region
        got.append(
            (
                r.shape_union(a, b),
                r.shape_difference(a, b),
                r.shape_difference(b, a),
                r.shape_intersection(a, b),
                r.shape_intersects(a, b),
                # chained: the flags and loose boxes of one result steer the next
                r.shape_difference(r.shape_union(a, b), r.shape_intersection(a, b)),
                r.boxshape(r.shape_difference(a, b)),
                r.is_null_shape(r.shape_difference(a, b)),
            )
        )
    j, t = got
    for k, name in enumerate(["union", "a-b", "b-a", "intersection"]):
        assert_same_shape(j[k], t[k], name)
    assert j[4] == t[4]
    assert_same_shape(j[5], t[5], "xor")
    assert_same_shape(j[6], t[6], "boxshape(a-b)")
    assert j[7] == t[7]


@pytest.mark.parametrize("kind", KINDS)
def test_translate_boxshape_point_spans_match_jax(kind):
    got = []
    for side in SIDES:
        r = side.region
        s = _operand(side, 3, kind, 4, 6, 37, 19)
        moved = r.translate_shape(-9, 13, s)
        loose = r.shape_union(moved, _operand(side, 4, "sparse", 30, 30, 3, 3))
        got.append(
            (
                moved,
                r.boxshape(loose),
                [r.point_in_shape(moved, p) for p in [(-5, 19), (0, 25), (10, 30), (200, 200), (27, 37)]],
                r.spanlist_of_shape(s),
                r.depthspanlist_of_shape(s),
                (r.shapesize(s), r.shapesize(loose), r.shapesize(None)),
                r.shapecheck(s),
            )
        )
    j, t = got
    assert_same_shape(j[0], t[0], "translate")
    assert_same_shape(j[1], t[1], "boxshape")
    assert j[2:] == t[2:]
    seen = []
    for side in SIDES:
        acc = []
        side.region.shapespan_iter(10, 30, 8, 20, lambda x, y, n: acc.append((x, y, n)), _operand(side, 3, kind, 4, 6, 37, 19))
        seen.append(acc)
    assert seen[0] == seen[1]


@pytest.mark.parametrize("size", [(1, 1), (8, 128), (9, 129), (64, 300), (170, 170), (1080, 1920)])
def test_cache_sizes_count_the_reference_buckets(size):
    h, w = size
    got = []
    for side in SIDES:
        s = side.shape_of_box((3, 4, 3 + w - 1, 4 + h - 1))
        spr = side.region.fillshape(s, side.fills.plain(side.C.red))
        got.append((side.region.shapesize(s), side.region.spritesize(spr), side.region.spritesize(None)))
    assert got[0] == got[1]


def _fills(side):
    C, F = side.C, side.fills
    return {
        "plain": F.plain(C.dissolve(C.teal, delta=140)),
        "gradient": F.gradient((3.0, 4.0), (40.0, 22.0), True, False, C.red, C.dissolve(C.blue, delta=99)),
        "radial": F.radial((20.0, 15.0), (24.0, 15.0), (45.0, 15.0), True, True, C.gold, C.purple),
    }


@pytest.mark.parametrize("fill", ["plain", "gradient", "radial"])
@pytest.mark.parametrize("kind", ["mask", "box", "inner"])
def test_fillshape_and_portion_match_jax(kind, fill):
    got = []
    for side in SIDES:
        r = side.region
        s = _operand(side, 5, kind, 2, 3, 50, 31)
        spr = r.fillshape(s, _fills(side)[fill])
        cut = _operand(side, 6, "mask", 20, 10, 45, 40)
        got.append(
            (
                spr,
                r.portion(spr, cut),
                r.portion(spr, side.shape_of_box((10, 10, 20, 20))),
                r.portion(spr, side.shape_of_box((100, 100, 120, 120))),
                r.boxsprite(r.portion(spr, _operand(side, 7, "inner", 5, 5, 40, 25))),
                r.translate_sprite(4, -2, spr),
                r.shape_of_sprite(spr),
                r.spritecheck(spr),
            )
        )
    j, t = got
    for k, name in enumerate(["fillshape", "portion", "portion box", "portion away", "boxsprite", "translate"]):
        assert_same_sprite(j[k], t[k], name)
    assert_same_shape(j[6], t[6], "shape_of_sprite")
    assert j[7] and t[7]
    assert all(side.region.fillshape(None, None) is None for side in SIDES)


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("op", ["over", "alpha_over", "plus", "nocover"])
def test_caf_matches_jax(op, place):
    got = []
    for side in SIDES:
        a = _sprite(side, 11, 5, 7, 40, 23)
        b = _sprite(side, 12, *PLACES[place], opaque=(op == "over" and place == "around"))
        if op == "nocover":
            # disjoint by construction: b only where a is not defined
            b = side.region.portion(b, side.region.shape_difference(side.region.shape_of_sprite(b), side.region.shape_of_sprite(a)))
        got.append(side.region.caf(op, "opaque", a, b) + side.region.caf(op, "opaque", a, None) + side.region.caf(op, "opaque", None, b))
    j, t = got
    for k in (0, 2, 4):
        assert_same_sprite(j[k], t[k], f"caf {op} sprite {k}")
        assert_same_shape(j[k + 1], t[k + 1], f"caf {op} shape {k}")
    assert all(side.region.caf(op, "opaque", None, None) == (None, None) for side in SIDES)


def _laid_out_sprite(side, seed, x0, y0, w, h, layout):
    """A sprite over the box at (x0, y0) of w x h pixels whose planes the
    port holds as `layout` says, the JAX package dense with the same values:
    "view" (slices of larger planes, as pickup cuts a canvas), "expanded"
    (one mask row and one colour expanded over the box, strides 0),
    "wide" (channels up to 600, as unclamped plus sums are)."""
    import torch

    rng = np.random.default_rng(seed)
    box = (x0, y0, x0 + w - 1, y0 + h - 1)
    if layout == "expanded":
        mask = np.broadcast_to(rng.random(w) < 0.7, (h, w))
        rgba = np.broadcast_to(np.array([40, 90, 12, 255 if seed % 2 else 90], np.int32), (h, w, 4))
    else:
        top = 600 if layout == "wide" else 255
        alpha = rng.choice([0, 1, 90, 254, 255, top], (h + 5, w + 9, 1))
        rgb = (rng.integers(0, top + 1, (h + 5, w + 9, 3)) * alpha) // max(top, 255)
        mask = rng.random((h + 5, w + 9)) < 0.6
        rgba = np.where(mask[..., None], np.concatenate([rgb, alpha], -1), 0).astype(np.int32)
        mask, rgba = mask[3 : 3 + h, 5 : 5 + w], rgba[3 : 3 + h, 5 : 5 + w]
    dense = np.where(mask[..., None], rgba, 0).astype(np.int32)
    if side is JAX:
        import jax.numpy as jnp

        return side.region.pickup(side.shape_of_mask(box, np.ascontiguousarray(mask)),
                                  side.region.Canvas(jnp.asarray(dense), (x0, y0)))
    if layout == "expanded":
        return side.region.Sprite(box, torch.from_numpy(np.array(mask[:1])).expand(h, w),
                                  torch.from_numpy(np.array(rgba[:1, :1])).expand(h, w, 4))
    full_mask = np.zeros((h + 5, w + 9), bool)
    full_rgba = np.zeros((h + 5, w + 9, 4), np.int32)
    full_mask[3 : 3 + h, 5 : 5 + w], full_rgba[3 : 3 + h, 5 : 5 + w] = mask, dense
    return side.region.Sprite(box, torch.from_numpy(full_mask)[3 : 3 + h, 5 : 5 + w],
                              torch.from_numpy(full_rgba)[3 : 3 + h, 5 : 5 + w])


@pytest.mark.parametrize("place", ["overlap", "inside", "around"])
@pytest.mark.parametrize("layouts", [("view", "view"), ("view", "expanded"), ("expanded", "wide"), ("wide", "view")])
@pytest.mark.parametrize("op", ["over", "alpha_over", "plus", "nocover"])
def test_caf_strided_and_expanded_operands_match_jax(op, layouts, place):
    """caf with the port's operands as views of larger planes, as expanded
    planes and with channels past 255 (the JAX package's dense, with the
    same values): equal in box, mask, colours and f."""
    got = []
    for side in SIDES:
        a = _laid_out_sprite(side, 41, 5, 7, 40, 23, layouts[0])
        b = _laid_out_sprite(side, 42, *PLACES[place], layouts[1])
        got.append(side.region.caf(op, "opaque", a, b) + side.region.caf(op, "opaque", b, a))
    j, t = got
    for k in (0, 2):
        assert_same_sprite(j[k], t[k], f"caf {op} {layouts} sprite {k}")
        assert_same_shape(j[k + 1], t[k + 1], f"caf {op} {layouts} shape {k}")


def test_caf_plus_sums_past_255_feed_over_match_jax():
    """plus's sums past 255 (no clamp) composed again by over and
    alpha_over, on either side, and plus again: equal to the JAX
    package's chain."""
    got = []
    for side in SIDES:
        a, b = _laid_out_sprite(side, 43, 5, 7, 40, 23, "wide"), _laid_out_sprite(side, 44, 20, 12, 40, 30, "view")
        c = _laid_out_sprite(side, 45, 1, 2, 70, 50, "view")
        s, _ = side.region.caf("plus", "opaque", a, b)
        got.append([side.region.caf(op, "opaque", x, y) for op in ("over", "alpha_over", "plus") for x, y in ((s, c), (c, s))])
    for k, (j, t) in enumerate(zip(*got)):
        assert_same_sprite(j[0], t[0], f"chain {k}")
        assert_same_shape(j[1], t[1], f"chain {k}")


def test_caf_nocover_returns_b_on_overlap_and_raises_under_spritecheck():
    got = []
    for side in SIDES:
        a, b = _sprite(side, 21, 1, 1, 20, 20), _sprite(side, 22, 10, 10, 20, 20)
        got.append(side.region.caf("nocover", "opaque", a, b))
        side.region.debug_spritecheck = True
        try:
            with pytest.raises(side.C.Nocover):
                side.region.caf("nocover", "opaque", a, b)
        finally:
            side.region.debug_spritecheck = False
    assert_same_sprite(got[0][0], got[1][0], "nocover on overlap")
    assert_same_shape(got[0][1], got[1][1], "nocover on overlap")


def test_register_caf_op_is_a_table_of_plain_functions():
    got = []
    for side in SIDES:
        side.region.register_caf_op("test_take_a", lambda a, b: a)
        a, b = _sprite(side, 31, 1, 1, 20, 20), _sprite(side, 32, 10, 10, 20, 20)
        got.append(side.region.caf("test_take_a", "opaque", a, b))
    assert_same_sprite(got[0][0], got[1][0], "registered op")
    assert_same_shape(got[0][1], got[1][1], "registered op")


RADII = [(0, 0), (1, 0), (0, 2), (1, 1), (2, 1), (3, 5), (5, 3), (4, 4), (5, 5), (2, 5)]


@pytest.mark.parametrize("kind", ["mask", "box", "full", "sparse", "inner"])
@pytest.mark.parametrize("radii", RADII, ids=[f"rx{a}ry{b}" for a, b in RADII])
def test_bloat_erode_match_jax(radii, kind):
    rx, ry = radii
    got = []
    for side in SIDES:
        r = side.region
        s = _operand(side, 8, kind, 3, 5, 29, 17)
        grown = r.bloat(rx, ry, s)
        got.append((grown, r.erode(rx, ry, s), r.erode(rx, ry, grown), r.bloat(rx, ry, r.erode(rx, ry, grown))))
    j, t = got
    for k, name in enumerate(["bloat", "erode", "erode(bloat)", "bloat(erode(bloat))"]):
        assert_same_shape(j[k], t[k], f"{name} {radii} {kind}")
    assert all(side.region.bloat(rx, ry, None) is None and side.region.erode(rx, ry, None) is None for side in SIDES)


WIDE_RADII = [(0, 9), (9, 0), (20, 1), (3, 12), (40, 40)]


@pytest.mark.parametrize("kind", ["mask", "full", "sparse"])
@pytest.mark.parametrize("radii", WIDE_RADII, ids=[f"rx{a}ry{b}" for a, b in WIDE_RADII])
def test_bloat_erode_zero_axis_and_wider_than_the_box_match_jax(radii, kind):
    """A radius of 0 on one axis, and erosions (and bloats) whose window is
    wider or taller than the 29 x 17 box, of a mask and of its bloat."""
    rx, ry = radii
    got = []
    for side in SIDES:
        r = side.region
        s = _operand(side, 9, kind, 3, 5, 29, 17)
        grown = r.bloat(rx, ry, s)
        got.append((grown, r.erode(rx, ry, s), r.erode(rx, ry, grown), r.erode(2 * rx + 1, 2 * ry + 1, grown)))
    j, t = got
    for k, name in enumerate(["bloat", "erode", "erode(bloat)", "erode wider than the bloat"]):
        assert_same_shape(j[k], t[k], f"{name} {radii} {kind}")


@pytest.mark.parametrize("border", [0, 1, 10])
def test_flatten_pickup_and_canvases_match_jax(border):
    got = []
    for side in SIDES:
        r, C = side.region, side.C
        spr = _sprite(side, 41, 6, 9, 33, 21)
        canvas = r.flatten_sprite(border, spr, C.dissolve(C.green, delta=200))
        inner = _operand(side, 42, "mask", 8, 10, 20, 15)
        back = r.pickup(inner, canvas)
        filled = side.newcanvas(12, 7, C.gold)
        sub = r.subcopy(canvas, filled, 2, 3, 5, 4)
        got.append(
            (
                (canvas.origin, side.np_plane(canvas.rgba)),
                back,
                side.np_plane(filled.rgba),
                side.np_plane(sub.rgba),
                side.np_plane(r.copycanvas(filled).rgba),
            )
        )
        with pytest.raises(Exception):
            r.pickup(side.shape_of_box((0, 0, 500, 500)), canvas)
    j, t = got
    assert j[0][0] == t[0][0] and np.array_equal(j[0][1], t[0][1])
    assert_same_sprite(j[1], t[1], "pickup")
    for k in (2, 3, 4):
        assert np.array_equal(j[k], t[k])


def test_sprite_map_and_map_coords_match_jax():
    got = []
    for side in SIDES:
        r, C = side.region, side.C
        spr = _sprite(side, 51, 6, 9, 33, 21)
        halved = r.sprite_map(lambda rgba: C.dissolve_rgba(rgba, 128), spr)
        checker = r.map_coords(lambda ys, xs, rgba: rgba * ((ys + xs) % 2)[..., None], spr)
        got.append((halved, checker))
    for k in (0, 1):
        assert_same_sprite(got[0][k], got[1][k], "map")


def test_convert_carries_a_shape_and_a_sprite_across():
    """One side's intermediate result feeds the other side's next stage."""
    r = JAX.region
    js = r.shape_union(_operand(JAX, 61, "mask", 5, 7, 40, 23), _operand(JAX, 62, "box", 30, 20, 30, 30))
    ts = convert.shape(js.box, js.mask_np(), js.full_box, "cpu")
    assert_same_shape(js, ts, "converted")
    assert_same_shape(r.bloat(2, 1, js), PORT.region.bloat(2, 1, ts), "bloat after convert")
    jspr = r.fillshape(js, _fills(JAX)["gradient"])
    box, m, rgba = JAX.np_sprite(jspr)
    tspr = convert.sprite(box, m, rgba, "cpu")
    cut_j, cut_t = (_operand(side, 63, "mask", 10, 10, 50, 30) for side in SIDES)
    assert_same_sprite(r.portion(jspr, cut_j), PORT.region.portion(tspr, cut_t), "portion after convert")
    with pytest.raises(ValueError):
        convert.shape((1, 1, 4, 4), np.ones((3, 4), bool), False, "cpu")


def test_binary_ops_refuse_tensors_of_other_shapes_than_their_box():
    with pytest.raises(ValueError):
        PORT.region.shape_of_mask((1, 1, 4, 4), np.ones((8, 128), bool), "cpu")


def test_sync_count_is_memoised():
    """Emptiness costs one readback per shape, and none where it is known
    for free (host masks, boxes)."""
    r = PORT.region
    a = _operand(PORT, 71, "mask", 1, 1, 20, 20)
    b = _operand(PORT, 72, "mask", 5, 5, 20, 20)
    r.syncs = 0
    assert not r.is_null_shape(a) and not r.is_null_shape(PORT.shape_of_box((1, 1, 2, 2)))
    assert r.syncs == 0
    d = r.shape_difference(a, b)
    assert r.syncs == 0
    r.is_null_shape(d), r.is_null_shape(d), r.is_null_shape(d)
    assert r.syncs == 1
    r.boxshape(r.shape_of_box((1, 1, 9, 9), "cpu"))
    assert r.syncs == 1
    r.boxshape(d)
    assert r.syncs == 2


_rects = st.tuples(st.integers(-20, 60), st.integers(-20, 60), st.integers(1, 50), st.integers(1, 50))


@settings(max_examples=40, deadline=None)
@given(
    st.lists(st.tuples(_rects, st.sampled_from(KINDS), st.integers(0, 2**16)), min_size=2, max_size=5),
    st.lists(st.sampled_from(["union", "difference", "intersection"]), min_size=4, max_size=4),
)
def test_algebra_hypothesis_matches_jax(operands, ops):
    """A left fold of random operations over random operands: every
    intermediate result equal on both sides, flags and loose boxes too."""
    accs = []
    for side in SIDES:
        shapes = [_operand(side, seed, kind, *rect) for rect, kind, seed in operands]
        acc, trail = shapes[0], []
        for k, s in enumerate(shapes[1:]):
            acc = getattr(side.region, "shape_" + ops[k])(acc, s)
            trail.append(acc)
        trail.append(side.region.boxshape(acc))
        accs.append(trail)
    for j, t in zip(*accs):
        assert_same_shape(j, t, "fold")
