"""The port's scene filters (scene/filters.py) against the JAX package's,
bit for bit: every filter constructor over a small scene, its dirty
transfer function, and the coherence property: through random steps of
translation, restacking and cache eviction, a render with the coherence
cache on equals a render with it off, and equals the JAX side's.
"""

import random

import numpy as np
import pytest

from _torch_general import JAX, PORT, SIDES, assert_same_shape, assert_same_sprite, both_sides, dense  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

BOX = (1, 1, 128, 112)


def _obj(side, geometry, t=()):
    return side.R.Obj(side.ident.new_ids(), geometry, t, side.R.OVER)


def _scene_below(side):
    R, C, F = side.R, side.C, side.fills
    gs = side.gshapes
    spec = gs.StrokeSpec(startcap=gs.RoundCap, endcap=gs.RoundCap, join=gs.RoundJoin, mitrelimit=10.0, linewidth=4.0)
    return [
        _obj(side, R.Basic(F.plain(C.dissolve(C.crimson, delta=170)), R.PathShape(gs.circle(50.0, 48.0, 22.0)))),
        _obj(side, R.Basic(F.plain(C.navy), R.StrokedPathShape(gs.circle(78.0, 60.0, 25.0), spec))),
        _obj(side, R.Basic(F.gradient((10.0, 10.0), (110.0, 90.0), True, True, C.gold, C.teal), R.rectangle(20.0, 30.0, 80.0, 50.0))),
        _obj(side, R.Basic(F.plain(C.dissolve(C.darkorange, delta=185)),
                           R.BrushStroke((side.brush.mkround(5.0, 0.5), gs.circle(64.0, 56.0, 40.0))))),
        _obj(side, R.Basic(F.plain(C.white), R.rectangle(4.0, 4.0, 120.0, 104.0))),
    ]


def _lens(side, kind="circle"):
    R, C, F = side.R, side.C, side.fills
    if kind == "circle":
        return R.Basic(F.plain(C.white), R.PathShape(side.gshapes.circle(60.0, 52.0, 30.0)))
    if kind == "soft":
        return R.Basic(F.plain(C.dissolve(C.white, delta=150)), R.rectangle(30.5, 25.0, 70.0, 60.0))
    return R.Basic(F.gradient((30.0, 50.0), (100.0, 50.0), True, True, C.white, C.dissolve(C.white, delta=0)),
                   R.rectangle(30.0, 25.0, 70.0, 60.0))


def _filters(side):
    """name -> (filter geometry, scene below it), one per constructor."""
    R, C, Fl, tr, gs = side.R, side.C, side.filters, side.tr, side.gshapes
    below = _scene_below(side)
    spec = gs.StrokeSpec(startcap=gs.ButtCap, endcap=gs.ButtCap, join=gs.MitredJoin, mitrelimit=10.0, linewidth=1.5)
    shift = (lambda c: [tr.Translate(5.0, 4.0)], lambda c: [tr.Translate(-5.0, 0.0)], lambda c: [tr.Translate(0.0, 0.0)])
    stroke = (side.brush.mkround(7.0, 1.0), side.gpath.Path(side.gpath.EVEN_ODD, (side.gpath.Subpath(False, False, (
        side.gpath.Bezier((25.0, 80.0), (50.0, 10.0), (80.0, 100.0), (105.0, 35.0)),)),)))
    out = {
        "wireframe": Fl.wireframe(_lens(side), spec, side.fills.plain(C.black)),
        "rgb": Fl.rgb(_lens(side), shift, R.FILTER_PLAIN),
        "rgb_fancy": Fl.rgb(_lens(side, "gradient"), shift, R.FILTER_FANCY),
        "smear": Fl.smear(stroke),
        "hole": Fl.hole(_lens(side)),
        "monochrome": Fl.monochrome(_lens(side, "soft")),
        "blur": Fl.blur(_lens(side), side.convolve.mkgaussian(3)),
        "blur_unit_soft": Fl.blur(_lens(side, "gradient"), side.convolve.mkunit(2)),
        "affine": Fl.affine([tr.Scale((60.0, 52.0), 1.0, -0.5), tr.ShearX((60.0, 52.0), -0.3)], _lens(side, "gradient")),
        "minus": Fl.minus(_lens(side)),
        "swapdepth": Fl.swapdepth(below[0].idset, below[1].idset, _lens(side)),
    }
    for mode in ("Multiply", "SoftLight", "Hue"):
        out["blend_" + mode] = Fl.blendmode(R.Basic(side.fills.plain(C.dissolve(C.gold, delta=200)),
                                                    R.PathShape(gs.circle(60.0, 52.0, 30.0))), mode)
    return out, below


FILTERS = ["wireframe", "rgb", "rgb_fancy", "smear", "hole", "monochrome", "blur", "blur_unit_soft", "affine", "minus",
           "swapdepth", "blend_Multiply", "blend_SoftLight", "blend_Hue"]


@pytest.mark.parametrize("name", FILTERS)
def test_filter_matches_jax(name, both_sides):
    """The filter over the scene: the whole window cold, a part of it from
    the cache, and the whole again after the filter moved by whole pixels."""
    got = []
    for side in SIDES:
        filters, below = _filters(side)
        fobj = _obj(side, filters[name])
        scene = [fobj] + below
        whole = side.render_simple_scene(scene, side.shape_of_box(BOX))
        part = side.render_simple_scene(scene, side.shape_of_box((40, 30, 90, 80)))
        moved = side.R.translate_renderobject(6, -3, fobj)
        after = side.render_simple_scene([moved] + below, side.shape_of_box(BOX))
        side.cache.usecache = False
        scratch = side.render_simple_scene([moved] + below, side.shape_of_box(BOX))
        side.cache.usecache = True
        assert np.array_equal(dense(side, after, BOX), dense(side, scratch, BOX)), f"{side.name}: cache on != cache off"
        got.append((whole, part, after, side.R.filterkind_in(fobj), side.R.fillkind_in(fobj)))
    for k, what in enumerate(["whole", "part", "moved"]):
        assert_same_sprite(got[0][k], got[1][k], f"{name} {what}")
    assert got[0][3:] == got[1][3:]


@pytest.mark.parametrize("name", FILTERS)
def test_filter_dirty_matches_jax(name, both_sides):
    """An object below the filter moves: its dirty region, carried up
    through the filter's dirty function, is the same shape on both sides,
    and rendering just that region over the old frame gives the new frame."""
    got = []
    for side in SIDES:
        R, region = side.R, side.region
        filters, below = _filters(side)
        fobj = _obj(side, filters[name])
        scene = [fobj] + below
        master = side.shape_of_box(BOX)
        old = side.render_simple_scene(scene, master)
        moved = R.translate_renderobject(7, 3, below[0])
        scene2 = [fobj, moved] + below[1:]
        if name == "swapdepth":
            scene2[0] = _obj(side, side.filters.swapdepth(moved.idset, below[1].idset, _lens(side)))
        d0 = side.dirty_region(below[0], moved)(master)
        d = side.dirty_filter(moved.idset, d0, scene2)
        patch = R.render_scene(moved.idset, False, (d, None), scene2, scene2, master, *(() if side is JAX else ("cpu",)))[0]
        frame, _ = region.caf("over", "opaque", patch, region.portion(old, region.shape_difference(master, d)))
        side.cache.usecache = False
        scratch = side.render_simple_scene(scene2, master)
        side.cache.usecache = True
        if name != "swapdepth":  # its filter object was rebuilt: nothing incremental to hold
            assert np.array_equal(dense(side, frame, BOX), dense(side, scratch, BOX)), f"{side.name}: incremental != scratch"
        got.append((d0, d, patch))
    assert_same_shape(got[0][0], got[1][0], "object dirty")
    assert_same_shape(got[0][1], got[1][1], "filter dirty")
    assert_same_sprite(got[0][2], got[1][2], "patch")


def test_transform_shape_matches_jax(both_sides):
    got = []
    for side in SIDES:
        rng = np.random.default_rng(3)
        shp = side.shape_of_mask((10, 12, 49, 41), rng.random((30, 40)) < 0.7)
        t = [side.tr.Translate(4.5, -2.0), side.tr.Scale((20.0, 20.0), 1.3, 0.6)]
        dev = () if side is JAX else ("cpu",)
        got.append((side.filters.transform_shape(t, shp, *dev), side.filters.transform_shape(t, None, *dev)))
    assert_same_shape(got[0][0], got[1][0], "transform_shape")
    assert got[0][1] is None and got[1][1] is None


def test_reparent_and_changefills_match_jax(both_sides):
    got = []
    for side in SIDES:
        R = side.R
        below = _scene_below(side)
        fid = side.ident.new_ids()
        re = side.filters.reparent(lambda o: isinstance(o.geometry.shape, R.PathShape), fid, below)
        kept = [a.idset == b.idset for a, b in zip(re, below)]
        combined = [a.idset == side.ident.combine(b.idset, fid) for a, b in zip(re, below)]
        grey = [side.filters.changefills(side.C.monochrome, R.Group(tuple(below))).objects[k].geometry.fill.single(40, 40)
                for k in range(len(below))]
        got.append((kept, combined, grey))
    assert got[0] == got[1]


# --- the coherence property --------------------------------------------------

SIZE = 170


def _random_fill(side, rng):
    C = side.C
    cols = ["red", "blue", "green", "darkorange", "purple", "teal", "cornflowerblue", "gold"]
    c = getattr(C, cols[rng.randrange(len(cols))])
    if rng.random() < 0.5:
        c = C.dissolve(c, delta=rng.randrange(40, 250))
    if rng.random() < 0.25:
        c2 = getattr(C, cols[rng.randrange(len(cols))])
        x0, y0 = rng.uniform(10, SIZE - 10), rng.uniform(10, SIZE - 10)
        return side.fills.gradient((x0, y0), (x0 + rng.uniform(15, 60), y0 + rng.uniform(-30, 30)), True, True, c, c2)
    return side.fills.plain(c)


def _random_basic(side, rng):
    R, gs = side.R, side.gshapes
    x, y = rng.uniform(20, SIZE - 30), rng.uniform(20, SIZE - 30)
    kind = rng.randrange(3)
    if kind == 0:
        shape = R.PathShape(gs.circle(x, y, rng.uniform(8, 26)))
    elif kind == 1:
        shape = R.rectangle(x, y, rng.uniform(12, 45), rng.uniform(12, 45))
    else:
        spec = gs.StrokeSpec(startcap=gs.ButtCap, endcap=gs.ButtCap, join=gs.RoundJoin, mitrelimit=10.0,
                             linewidth=rng.uniform(2.0, 6.0))
        shape = R.StrokedPathShape(gs.circle(x, y, rng.uniform(10, 24)), spec)
    return _obj(side, R.Basic(_random_fill(side, rng), shape))


def _random_filter(side, rng):
    R = side.R
    x, y = rng.uniform(40, SIZE - 40), rng.uniform(40, SIZE - 40)
    lens = R.Basic(side.fills.plain(side.C.white), R.PathShape(side.gshapes.circle(x, y, rng.uniform(14, 28))))
    k = rng.randrange(3)
    if k == 0:
        g = side.filters.blur(lens, side.convolve.mkgaussian(rng.randrange(2, 5)))
    elif k == 1:
        g = side.filters.monochrome(lens)
    else:
        g = side.filters.hole(lens)
    return _obj(side, g)


def _run_steps(side, seed, steps):
    """The whole-window render after each of `steps` random edits: a dirty
    render of the moved object's region composited over the previous frame
    where the edit is a move, a full render otherwise; each checked against
    a render from scratch with the cache off."""
    R, region, cache = side.R, side.region, side.cache
    rng = random.Random(seed)
    cache.setsize(20_000_000)
    scene = [_random_basic(side, rng) for _ in range(rng.randrange(4, 8))]
    scene.insert(rng.randrange(len(scene) + 1), _random_filter(side, rng))
    window = (0, 0, SIZE, SIZE)
    master = side.shape_of_box(window)
    dev = () if side is JAX else ("cpu",)

    def scratch():
        was, cache.usecache = cache.usecache, False
        try:
            return dense(side, side.render_simple_scene(scene, master), window)
        finally:
            cache.usecache = was

    frame = side.render_simple_scene(scene, master)
    frames = [dense(side, frame, window)]
    assert np.array_equal(frames[0], scratch()), f"{side.name} seed {seed}: first frame"
    for stepno in range(steps):
        op = ["translate", "translate", "restack", "setsize", "drophalf"][rng.randrange(5)]
        k = rng.randrange(len(scene))
        if op == "translate":
            o = scene[k]
            n = R.translate_renderobject(rng.randrange(-12, 13), rng.randrange(-12, 13), o)
            scene = scene[:k] + [n] + scene[k + 1 :]
            d = side.dirty_filter(n.idset, side.dirty_region(o, n)(master), scene)
            patch = R.render_scene(n.idset, False, (d, None), scene, scene, master, *dev)[0]
            frame, _ = region.caf("over", "opaque", patch, region.portion(frame, region.shape_difference(master, d)))
        else:
            if op == "restack":
                o = scene.pop(k)
                scene.insert(rng.randrange(len(scene) + 1), o)
            elif op == "setsize":
                cache.setsize(rng.choice([1, 20_000, 150_000, 20_000_000]))
            else:
                cache.drophalf()
            frame = side.render_simple_scene(scene, master)
        got = dense(side, frame, window)
        want = scratch()
        if not np.array_equal(got, want):
            bad = np.argwhere((got != want).any(-1))
            raise AssertionError(f"{side.name} seed {seed} step {stepno} op {op}: cache on differs from cache off "
                                 f"at {len(bad)} px, first {bad[0]}")
        frames.append(got)
    return frames, (cache.properties.cachesize, cache.properties.cachemaxsize)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_coherence_cache_on_equals_off_equals_jax(seed, both_sides):
    j_frames, j_cache = _run_steps(JAX, seed, 12)
    t_frames, t_cache = _run_steps(PORT, seed, 12)
    for k, (j, t) in enumerate(zip(j_frames, t_frames)):
        bad = np.argwhere((j != t).any(-1))
        assert len(bad) == 0, f"seed {seed} frame {k}: {len(bad)} px differ from the JAX side, first {bad[0]}"
    # Both sides count the same bytes, so they evict at the same moments.
    assert j_cache == t_cache
