"""The port's scene renderer (scene/render.py) against the JAX package's:
the scenarios of the JAX package's own renderer tests (opaque and
translucent stacks against a naive composite, early termination, cache
translation reuse, PreTrans, groups, CPG, dirty regions, picking, selection
drawables), each run on both sides with objects built from that side's
modules, and the results compared bit for bit (box, mask, colours).
"""

import numpy as np
import pytest

from _torch_general import JAX, PORT, SIDES, assert_same_shape, assert_same_sprite, both_sides, dense  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

BOX = (1, 1, 96, 96)


def circle_obj(side, x, y, r, colour, alpha=255, t=()):
    fill = side.fills.plain(side.C.dissolve(getattr(side.C, colour), delta=alpha))
    return side.R.Obj(side.ident.new_ids(), side.R.Basic(fill, side.R.PathShape(side.gshapes.circle(x, y, r))), t, side.R.OVER)


def rect_obj(side, x, y, w, h, colour, alpha=255):
    fill = side.fills.plain(side.C.dissolve(getattr(side.C, colour), delta=alpha))
    return side.R.Obj(side.ident.new_ids(), side.R.Basic(fill, side.R.rectangle(x, y, w, h)), (), side.R.OVER)


def naive_composite(side, scene, box):
    """Front-to-back compositing with no early termination and no update
    shape: the renderer's fold order without its occlusion machinery."""
    R, region = side.R, side.region
    acc = None
    for o in scene:
        shp, minshp = side.shape_of_basicshape(o)
        shp = region.shape_intersection(shp, side.shape_of_box(box))
        if shp is None:
            continue
        minshp = region.shape_intersection(minshp, side.shape_of_box(box))
        maxshape = region.shape_difference(shp, minshp)
        fill = R.fillin_obj(o).transform(list(o.transform))
        fringe = side.sprite_of_basicshape(o, maxshape, scene) if maxshape is not None else None
        interior = region.fillshape(minshp, fill) if minshp is not None else None
        spr, _ = region.caf("nocover", "opaque", interior, fringe)
        if spr is None:
            continue
        acc, _ = region.caf("over", "opaque", acc, spr)
    return acc


STACKS = {
    "opaque": lambda s: [circle_obj(s, 40, 40, 25, "red"), circle_obj(s, 50, 50, 25, "green"),
                         circle_obj(s, 60, 60, 25, "blue"), rect_obj(s, 10, 10, 80, 80, "white")],
    "translucent": lambda s: [circle_obj(s, 40, 40, 25, "red", 120), circle_obj(s, 50, 50, 25, "green", 200),
                              rect_obj(s, 20, 20, 60, 60, "blue", 255), rect_obj(s, 5, 5, 90, 90, "yellow", 90)],
    "fractional": lambda s: [circle_obj(s, 40.5, 33.25, 17.75, "gold", 250), rect_obj(s, 10.5, 8.25, 70.0, 40.5, "teal", 128),
                             circle_obj(s, 0.0, 0.0, 30.0, "crimson", 255, (s.tr.Translate(55.5, 60.0), s.tr.Scale((0.0, 0.0), 1.2, 0.7)))],
}


@pytest.mark.parametrize("stack", list(STACKS))
def test_hsr_equals_naive_and_matches_jax(stack, both_sides):
    got = []
    for side in SIDES:
        scene = STACKS[stack](side)
        spr = side.render_simple_scene(scene, side.shape_of_box(BOX))
        side.cache.clear()
        expect = naive_composite(side, scene, BOX)
        assert np.array_equal(dense(side, spr, BOX), dense(side, expect, BOX)), side.name
        got.append(spr)
    assert_same_sprite(got[0], got[1], stack)


def test_early_termination_skips_occluded(both_sides):
    """A fully opaque rect on top stops the object below from being
    rasterized: no sprite is cached for it, and the fold leaves early."""
    seen = []
    for side in SIDES:
        below = circle_obj(side, 40, 40, 20, "red")
        top = rect_obj(side, 1, 1, 95, 95, "black")
        inner = side.shape_of_box((30, 30, 60, 60))
        side.profiling.reset()
        spr = side.render_simple_scene([top, below], inner)
        assert side.cache.getsprite(top.idset) is not None
        assert side.cache.getsprite(below.idset) is None
        seen.append((dict(side.profiling.counters), spr))
    assert seen[0][0] == seen[1][0] == {"render.objects_visited": 1, "render.early_exit": 1}
    assert_same_sprite(seen[0][1], seen[1][1], "occluded")


def test_cache_translation_reuses_raster(both_sides):
    got = []
    for side in SIDES:
        obj = circle_obj(side, 30, 30, 15, "green")
        side.render_simple_scene([obj], side.shape_of_box(BOX))
        spr0 = side.cache.getsprite(obj.idset)
        assert spr0 is not None
        moved = side.R.translate_renderobject(10, 5, obj)
        spr1, pshape = side.cache.getsprite(moved.idset)
        b = spr0[0].box
        assert spr1.box == (b[0] + 10, b[1] + 5, b[2] + 10, b[3] + 5)
        assert spr1.rgba is spr0[0].rgba  # the same raster, not a copy
        got.append((spr1, pshape, side.cache.getshape(moved.idset)))
    assert_same_sprite(got[0][0], got[1][0], "alias sprite")
    assert_same_shape(got[0][1], got[1][1], "alias partial shape")
    assert_same_shape(got[0][2][0], got[1][2][0], "alias shape")
    assert_same_shape(got[0][2][1], got[1][2][1], "alias minshape")


def test_translated_render_matches_fresh(both_sides):
    got = []
    for side in SIDES:
        obj = circle_obj(side, 30, 30, 15, "purple")
        side.render_simple_scene([obj], side.shape_of_box(BOX))
        moved = side.R.translate_renderobject(12, 7, obj)
        b = side.render_simple_scene([moved], side.shape_of_box(BOX))
        side.cache.clear()
        fresh = side.R.Obj(side.ident.new_ids(), moved.geometry, moved.transform, moved.compop)
        c = side.render_simple_scene([fresh], side.shape_of_box(BOX))
        assert np.array_equal(dense(side, b, BOX), dense(side, c, BOX))
        got.append(b)
    assert_same_sprite(got[0], got[1], "moved")


def test_fractional_translation_is_not_aliased(both_sides):
    got = []
    for side in SIDES:
        obj = circle_obj(side, 30, 30, 15, "purple", 200)
        side.render_simple_scene([obj], side.shape_of_box(BOX))
        moved = side.R.transform_renderobject(side.tr.Translate(3.5, 0.25), obj)
        got.append((side.cache.getsprite(moved.idset), side.render_simple_scene([moved], side.shape_of_box(BOX))))
    assert got[0][0] is None and got[1][0] is None
    assert_same_sprite(got[0][1], got[1][1], "fractional move")


def test_pretrans_compop(both_sides):
    got = []
    for side in SIDES:
        R, C = side.R, side.C
        obj = R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.red), R.rectangle(10, 10, 40, 40)), (),
                    R.PreTrans(0.5, R.OVER))
        spr = side.render_simple_scene([obj, rect_obj(side, 30, 30, 50, 50, "blue", 180)], side.shape_of_box(BOX))
        only = side.render_simple_scene([obj], side.shape_of_box(BOX))
        assert tuple(dense(side, only, BOX)[30, 30]) == C.rgba_of_colour(C.dissolve(C.red, delta=127))
        got.append(spr)
    assert_same_sprite(got[0], got[1], "pretrans")


def test_group_render_and_bounds(both_sides):
    got = []
    for side in SIDES:
        R, C = side.R, side.C
        g = R.mkgroup([circle_obj(side, 30, 30, 10, "red"), circle_obj(side, 60, 60, 10, "blue", 140),
                       R.mkgroup([rect_obj(side, 50, 20, 30, 30, "gold", 200)])])
        g = R.transform_renderobject(side.tr.Translate(2.0, 3.0), g)
        bounds = R.bounds_of_basicshape(g)
        spr = side.render_simple_scene([g, rect_obj(side, 5, 5, 80, 80, "teal")], side.shape_of_box(BOX))
        img = dense(side, spr, BOX)
        assert tuple(img[32, 31]) == C.rgba_of_colour(C.red)
        got.append((bounds, spr, side.shape_of_basicshape(g)))
    assert got[0][0] == got[1][0]
    assert_same_sprite(got[0][1], got[1][1], "group")
    assert_same_shape(got[0][2][0], got[1][2][0], "group shape")
    assert got[0][2][1] is None and got[1][2][1] is None


@pytest.mark.parametrize("batched", [True, False])
def test_group_batched_route_gives_the_fold_its_pixels(batched, both_sides):
    """A group renders through the batched raster (the default) or through
    the per-member fold: in each, the port equals the JAX package in the
    sprite, the group's shape and the cache's byte count, and the two routes
    give the same pixels."""
    got = []
    for side in SIDES:
        side.flags.set_flag("batch_group_raster", batched)
        g = side.R.mkgroup([circle_obj(side, 30, 30, 10, "red"), circle_obj(side, 40, 38, 14, "blue", 140),
                            rect_obj(side, 52.5, 20.25, 20, 30, "gold", 200)])
        spr = side.render_simple_scene([g, rect_obj(side, 5, 5, 80, 80, "teal", 120)], side.shape_of_box(BOX))
        got.append((spr, side.shape_of_basicshape(g)[0], side.cache.properties.cachesize))
    assert_same_sprite(got[0][0], got[1][0], f"batched={batched}")
    assert_same_shape(got[0][1], got[1][1], "group shape")
    assert got[0][2] == got[1][2]
    PORT.flags.set_flag("batch_group_raster", not batched)
    PORT.cache.clear()
    g = PORT.R.mkgroup([circle_obj(PORT, 30, 30, 10, "red"), circle_obj(PORT, 40, 38, 14, "blue", 140),
                        rect_obj(PORT, 52.5, 20.25, 20, 30, "gold", 200)])
    other = PORT.render_simple_scene([g, rect_obj(PORT, 5, 5, 80, 80, "teal", 120)], PORT.shape_of_box(BOX))
    assert np.array_equal(dense(PORT, got[1][0], BOX), dense(PORT, other, BOX))


@pytest.mark.parametrize("fill", ["plain", "gradient"])
@pytest.mark.parametrize("op", ["UNION", "INTERSECTION", "SUBTRACTION", "EXCLUSIVE_OR"])
def test_cpg_shapes_and_render(op, fill, both_sides):
    got = []
    for side in SIDES:
        R, C = side.R, side.C
        a = R.PathShape(side.gshapes.circle(40.0, 40.0, 20.0))
        b = R.PathShape(side.gshapes.circle(55.0, 40.0, 20.0))
        f = {"plain": side.fills.plain(C.blue),
             "gradient": side.fills.gradient((20.0, 20.0), (75.0, 60.0), True, True, C.red, C.dissolve(C.gold, delta=150))}[fill]
        obj = R.Obj(side.ident.new_ids(), R.Basic(f, R.CPG(getattr(R, op), a, b)), (side.tr.Translate(1.0, 2.0),), R.OVER)
        spr = side.render_simple_scene([obj], side.shape_of_box(BOX))
        if fill == "plain":
            img = dense(side, spr, BOX)
            left, mid, right = (tuple(img[41, x]) for x in (25, 47, 70))
            blue, clearpx = C.rgba_of_colour(C.blue), (0, 0, 0, 0)
            want = {"UNION": (blue, blue, blue), "INTERSECTION": (clearpx, blue, clearpx),
                    "SUBTRACTION": (blue, clearpx, clearpx), "EXCLUSIVE_OR": (blue, clearpx, blue)}[op]
            assert (left, mid, right) == want
        got.append((spr,) + tuple(side.shape_of_basicshape(obj)))
    assert_same_sprite(got[0][0], got[1][0], f"cpg {op}")
    assert_same_shape(got[0][1], got[1][1], "cpg shape")
    assert_same_shape(got[0][2], got[1][2], "cpg minshape")


def _stroke_spec(side, width):
    gs = side.gshapes
    return gs.StrokeSpec(startcap=gs.ButtCap, endcap=gs.ButtCap, join=gs.RoundJoin, mitrelimit=10.0, linewidth=width)


def _leaves(side):
    """One object of every leaf geometry the renderer draws."""
    R, C, F = side.R, side.C, side.fills
    mk = lambda g, t=(): R.Obj(side.ident.new_ids(), g, t, R.OVER)
    circle = side.gshapes.circle(48.0, 44.0, 26.0)
    return {
        "stroked": mk(R.Basic(F.plain(C.dissolve(C.crimson, delta=210)), R.StrokedPathShape(circle, _stroke_spec(side, 5.5)))),
        "stroked_scaled": mk(R.Basic(F.plain(C.navy), R.StrokedPathShape(circle, _stroke_spec(side, 3.0))),
                             (side.tr.Scale((48.0, 44.0), 1.4, 0.8),)),
        "brush": mk(R.Basic(F.plain(C.dissolve(C.darkorange, delta=185)), R.BrushStroke((side.brush.mkround(6.0, 0.5), circle)))),
        "convolved": mk(R.Convolved(side.convolve.mkgaussian(3), R.Basic(F.plain(C.teal), R.PathShape(circle)))),
        "convolved_gradient": mk(R.Convolved(side.convolve.mkunit(2), R.Basic(
            F.gradient((20.0, 20.0), (75.0, 60.0), True, True, C.red, C.gold), R.rectangle(20.0, 25.0, 50.0, 40.0)))),
        "convolved_group": mk(R.Convolved(side.convolve.mkgaussian(2), R.Group((
            circle_obj(side, 30, 30, 12, "red"), rect_obj(side, 40, 40, 30, 25, "blue", 170))))),
        "hline": mk(R.Primitive(C.black, R.HLine(30.0, 10.0, 80.0))),
        "vline": mk(R.Primitive(C.dissolve(C.red, delta=100), R.VLine(25.0, 12.0, 70.0))),
        "rectprim": mk(R.Primitive(C.gold, R.RectanglePrim(15.0, 22.0, 60.0, 52.0))),
        "radial": mk(R.Basic(F.radial((48.0, 44.0), (50.0, 44.0), (70.0, 44.0), True, True, C.white, C.purple), R.PathShape(circle))),
    }


LEAVES = ["stroked", "stroked_scaled", "brush", "convolved", "convolved_gradient", "convolved_group", "hline", "vline",
          "rectprim", "radial"]


@pytest.mark.parametrize("leaf", LEAVES)
def test_every_leaf_geometry_matches_jax(leaf, both_sides):
    got = []
    for side in SIDES:
        o = _leaves(side)[leaf]
        back = rect_obj(side, 8, 8, 80, 70, "lightgrey", 230)
        spr = side.render_simple_scene([o, back], side.shape_of_box(BOX))
        again = side.render_simple_scene([o, back], side.shape_of_box((20, 20, 70, 60)))  # from the cache
        got.append((spr, again) + tuple(side.shape_of_basicshape(o)) + (side.R.bounds_of_basicshape(o),))
    assert_same_sprite(got[0][0], got[1][0], leaf)
    assert_same_sprite(got[0][1], got[1][1], leaf + " cached")
    assert_same_shape(got[0][2], got[1][2], leaf + " shape")
    assert_same_shape(got[0][3], got[1][3], leaf + " minshape")
    assert got[0][4] == got[1][4]


def test_malformed_scenes_raise(both_sides):
    for side in SIDES:
        R = side.R
        inner = R.Convolved(side.convolve.mkgaussian(1), R.Primitive(side.C.black, R.HLine(30.0, 10.0, 80.0)))
        with pytest.raises(ValueError):
            side.render_simple_scene([R.Obj(side.ident.new_ids(), inner, (), R.OVER)], side.shape_of_box(BOX))
        bad = R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(side.C.red), R.rectangle(1, 1, 9, 9)), (), "xor")
        with pytest.raises(ValueError):
            side.render_simple_scene([bad], side.shape_of_box(BOX))


def test_dirty_region_plain_vs_fancy(both_sides):
    got = []
    for side in SIDES:
        R, region = side.R, side.region
        u = side.shape_of_box(BOX)
        obj = circle_obj(side, 40, 40, 15, "red")
        moved = R.translate_renderobject(5, 0, obj)
        d = side.dirty_region(obj, moved)(u)
        total = region.shape_union(side.shapeonly_of_basicshape(obj), side.shapeonly_of_basicshape(moved))
        assert d is not None and region.is_null_shape(region.shape_difference(d, total))
        # A plain fill dirties the fringes only; a fancy one the whole of both shapes.
        g = R.Obj(side.ident.new_ids(), R.Basic(side.fills.gradient((20.0, 20.0), (60.0, 60.0), True, True, side.C.red, side.C.blue),
                                                R.PathShape(side.gshapes.circle(40.0, 40.0, 15.0))), (), R.OVER)
        gmoved = R.translate_renderobject(5, 0, g)
        dg = side.dirty_region(g, gmoved)(u)
        assert not region.is_null_shape(region.shape_difference(dg, d))
        faded = R.Obj(moved.idset, moved.geometry, moved.transform, R.PreTrans(0.5, R.OVER))
        got.append((d, dg, side.dirty_region(obj, faded)(u),
                    R.dirty_selections((R.Size, ([obj], R.handles_size())), R.null_selection, u, *(() if side is JAX else ("cpu",)))))
    for k, name in enumerate(["plain", "fancy", "compop change", "selections"]):
        assert_same_shape(got[0][k], got[1][k], name)


def test_pick_topmost(both_sides):
    for side in SIDES:
        R = side.R
        below = circle_obj(side, 40, 40, 20, "red")
        top = circle_obj(side, 45, 45, 20, "blue")
        view = side.view(scene=[top, below])
        picked = R.pick(45, 45, view)
        assert isinstance(picked, R.PickedObject) and picked.obj is top
        picked2 = R.pick(25, 33, view)
        assert picked2 is not None and picked2.obj is below
        assert R.pick(90, 90, view) is R.PickedNone


def test_selection_drawable_and_handles(both_sides):
    got = []
    for side in SIDES:
        R = side.R
        obj = rect_obj(side, 30, 30, 30, 30, "red")
        sel = (R.Size, ([obj], R.handles_size()))
        drawable = R.drawable_of_selection(sel)
        assert len(drawable) == 12  # 8 arrows + 4 rectangle edges
        h = R.renderobject_of_handle(sel, R.HandleTopLeft)
        view = side.view(scene=[obj], selections=sel)
        xmin, xmax, ymin, ymax = R.proper_bounds(h)
        picked = R.pick(int((xmin + xmax) / 2), int((ymin + ymax) / 2), view)
        assert isinstance(picked, R.PickedSelectionHandle)
        rot = (R.Rotate(45, 45), ([obj], R.handles_rotate())) if hasattr(R, "handles_rotate") else sel
        spr = side.render_simple_scene(drawable + R.drawable_of_selection(rot) + [obj], side.shape_of_box(BOX))
        got.append((spr, [R.bounds_of_basicshape(d) for d in drawable], picked.handle,
                    [R.bounds_of_basicshape(o) for o in R.outline_of_scene([obj])],
                    [R.bounds_of_basicshape(o) for o in R.drawable_of_rubberband(10, 12, 50, 60)]))
    assert_same_sprite(got[0][0], got[1][0], "selection drawables")
    assert got[0][1:] == got[1][1:]


def test_render_frame_matches_jax(both_sides):
    """render_frame: selection and rubberband on top, pages and background
    beneath, within an update shape."""
    got = []
    for side in SIDES:
        R = side.R
        obj = circle_obj(side, 40, 40, 18, "green", 180)
        other = rect_obj(side, 20, 50, 60, 30, "blue")
        background = rect_obj(side, 1, 1, 96, 96, "white")
        view = side.view(scene=[obj, other], background=[background], selections=(R.Size, ([obj], R.handles_size())),
                         master_update=side.shape_of_box(BOX), rubberband=(10, 10, 70, 80))
        update = side.shape_of_box((5, 5, 90, 90))
        whole = R.render_frame(side.ident.new_ids(), view, update)
        bare = R.render_frame(side.ident.new_ids(), view, side.shape_of_box((30, 30, 60, 60)), display_selection=False,
                              topobjects=[circle_obj(side, 45, 45, 5, "black")])
        got.append((whole, bare))
    assert_same_sprite(got[0][0], got[1][0], "frame")
    assert_same_sprite(got[0][1], got[1][1], "frame without selection")


def test_anchors_and_transforms_match_jax(both_sides):
    got = []
    for side in SIDES:
        R = side.R
        o = R.transform_renderobject_many([side.tr.Translate(3.0, 4.0), side.tr.Scale((0.0, 0.0), 1.5, 0.5)],
                                          _leaves(side)["stroked"])
        placed = R.position_anchor(R.Centre, (50.0, 50.0), o)
        got.append(([R.findpoint(a, placed) for a in (R.Left, R.TopLeft, R.Top, R.Centre, R.BottomRight)],
                    R.bounds_of_basicshape(placed), R.proper_bounds(placed), repr(placed.transform),
                    R.fillkind_in(placed), R.filterkind_in(placed)))
    assert got[0] == got[1]


def _cache_trail(side):
    """The cache's bookkeeping through adds, lookups, chained translation
    aliases, eviction and the off switch: after each step its byte count,
    its hit and miss counters and its state table without the ids."""
    cache, region, R = side.cache, side.region, side.R
    cache.setsize(3_000_000)
    cache.properties.cachetimer = 0  # the clock is module state: each side's own history
    trail = []

    def note(what):
        rows = [ln.split("\t", 1)[1] for ln in cache.string_of_cachestate().splitlines()[2:]]
        s = cache.cachestats
        trail.append((what, cache.properties.cachesize, cache.properties.cachemaxsize,
                      (s.shphit, s.shpmis, s.sprhit, s.sprmis), sorted(rows)))

    objs = [circle_obj(side, 30 + 9 * k, 30 + 5 * k, 12 + k, "red", 200) for k in range(5)]
    for k, o in enumerate(objs):
        side.render_simple_scene([o], side.shape_of_box((1, 1, 60 + 20 * k, 96)))
        note(f"render {k}")
    moved = R.translate_renderobject(4, 2, objs[0])
    again = R.translate_renderobject(-1, 3, moved)  # an alias of an alias lands on the base object
    got = cache.getsprite(again.idset)
    note("chained aliases")
    assert got is not None and got[0].box[0] == cache.getsprite(objs[0].idset)[0].box[0] + 3
    assert cache.getshape(again.idset)[0].box == region.translate_shape(3, 5, cache.getshape(objs[0].idset)[0]).box
    cache.drophalf()
    note("drophalf")
    cache.dropfromcache(10**9)
    note("drop everything")
    assert cache.getsprite(objs[1].idset) is None and cache.getshape(moved.idset) is None
    cache.setsize(40_000)  # now a sprite is larger than half the cache: never stored
    side.render_simple_scene(objs, side.shape_of_box(BOX))
    note("too small to hold a sprite")
    cache.usecache = False
    side.render_simple_scene(objs, side.shape_of_box(BOX))
    assert cache.getshape(objs[0].idset) is None
    note("switched off")
    cache.usecache = True
    cache.clear()
    note("cleared")
    return trail


def test_cache_bookkeeping_matches_jax(both_sides):
    for side in SIDES:
        side.cache.cachestats.shphit = side.cache.cachestats.shpmis = 0
        side.cache.cachestats.sprhit = side.cache.cachestats.sprmis = 0
    j, t = _cache_trail(JAX), _cache_trail(PORT)
    for a, b in zip(j, t):
        assert a == b, a[0]
    assert j[-1][1] == 0 and j[3][1] > 0
