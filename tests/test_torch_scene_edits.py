"""Scene edits of the port (TiledScene and DeviceView) against the JAX
package's, bit for bit.

Each scenario runs on both sides with objects built from that side's
modules: ``TiledScene.remove_object`` (plain and reserved runs),
``add_boxes`` against ``add_object``, ``build_lists`` restricted to dirty
tiles; ``DeviceView`` on its sprite route (``set_scene(tiled=False)``, the
default) against the general renderer, the edit sequence ``add_object``,
``replace_object``, ``remove_object``, ``restack`` (each frame against the
JAX package's and the last against a fresh view), delete and re-add churn;
the tile build's scalar fallback (a fancy fill, a CPG, a group) and a
translated tiled group; ``sprites_of_keys``.  Frames, atlases, piece lists
and the free-slot runs compare equal.  Small frames of a few tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from coherence_tpu.raster import tiled_scene as JT
from coherence_tpu.scene import fastframe as JF

from coherence_tpu_torch.raster import tiled_scene as T
from coherence_tpu_torch.raster.compositor import TILE_H, TILE_W, pack_rgba
from coherence_tpu_torch.scene import fastframe as TF

from _torch_general import JAX, SIDES, both_sides  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

W, H = 2 * TILE_W, 2 * TILE_H


def tiled_scene(side, w, h):
    return JT.TiledScene(w, h) if side is JAX else T.TiledScene(w, h, "cpu")


def device_view(side, w=W, h=H, **kw):
    return JF.DeviceView(w, h, **kw) if side is JAX else TF.DeviceView(w, h, device="cpu", **kw)


def atlas_np(side, ts) -> np.ndarray:
    return np.asarray(ts.atlas()).view(np.int32) if side is JAX else ts.atlas().numpy()


def render_lists(side, ts, order, w, h, dirty_tiles=None) -> np.ndarray:
    """A full-frame composite of `order` over white, as int32 words."""
    if side is JAX:
        bg = jnp.full((h, w), 0xFFFFFFFF, jnp.uint32)
        return np.asarray(ts.render_full(bg, *ts.build_lists(order, dirty_tiles))).view(np.int32)
    import torch

    bg = pack_rgba(torch.full((h, w, 4), 255, dtype=torch.int32))
    return ts.render_full(bg, *ts.build_lists(order, dirty_tiles)).numpy()


def box_sprite(side, box, colour, alpha=255):
    return side.region.fillshape(side.shape_of_box(box), side.fills.plain(side.C.dissolve(colour, delta=alpha)))


def circle_obj(side, x, y, r, colour, alpha=255):
    fill = side.fills.plain(side.C.dissolve(colour, delta=alpha))
    return side.R.Obj(side.ident.new_ids(), side.R.Basic(fill, side.R.PathShape(side.gshapes.circle(x, y, r))), (),
                      side.R.OVER)


def state(side, ts):
    return ts._n_pieces, list(ts._free_runs), int(ts.atlas().shape[0])


@pytest.mark.parametrize("reserved", [False, True])
def test_remove_object_frees_slots_like_jax(reserved, both_sides):
    """remove_object returns an object's slots (a reserved run whole) to the
    pool; a re-add of the same footprint reuses them and the frame equals a
    scene that never held the removed object."""
    got = []
    for side in SIDES:
        C = side.C
        w, h = 3 * TILE_W, 3 * TILE_H
        ts = tiled_scene(side, w, h)
        ts.add_object("a", box_sprite(side, (5, 5, 64, 44), C.steelblue, 180))
        victim = box_sprite(side, (70, 30, 189, 109), C.crimson)
        if reserved:
            ts.reserve_slots("victim", 6)
            ts.update_object_inplace("victim", victim)
        else:
            ts.add_object("victim", victim)
        ts.add_object("b", box_sprite(side, (200, 100, 249, 149), C.gold))
        before = state(side, ts)
        ts.remove_object("victim")
        assert "victim" not in ts.pieces and "victim" not in ts._reserved
        removed = state(side, ts)
        ts.add_object("victim2", box_sprite(side, (70, 30, 189, 109), C.teal))
        order = ["a", "victim2", "b"]
        fresh = tiled_scene(side, w, h)
        for key in order:
            fresh.add_object(key, {"a": box_sprite(side, (5, 5, 64, 44), C.steelblue, 180),
                                   "victim2": box_sprite(side, (70, 30, 189, 109), C.teal),
                                   "b": box_sprite(side, (200, 100, 249, 149), C.gold)}[key])
        frame = render_lists(side, ts, order, w, h)
        assert np.array_equal(frame, render_lists(side, fresh, order, w, h)), side.name
        assert state(side, ts)[2] == before[2], "the atlas grew"
        got.append((before, removed, state(side, ts), {k: list(v) for k, v in ts.pieces.items()},
                    atlas_np(side, ts), frame))
    for a, b in zip(*got):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    assert sum(ln for _, ln in got[1][1][1]) >= (6 if reserved else 2)


def box_items(side, seed: int, n: int, w: int, h: int):
    rng = np.random.default_rng(seed)
    C = side.C
    items = []
    for k in range(n):
        x0, y0 = int(rng.integers(1, w - 40)), int(rng.integers(1, h - 40))
        bw, bh = int(rng.integers(5, 200)), int(rng.integers(5, 200))
        col = C.dissolve(C.colour_of_rgba(*(int(v) for v in rng.integers(0, 256, 3)), 255),
                         delta=150 if k % 2 else 255)
        items.append((k, (x0, y0, min(w, x0 + bw - 1), min(h, y0 + bh - 1)), col))
    return items


def test_add_boxes_matches_add_object_and_jax(both_sides):
    w, h = 4 * TILE_W, 3 * TILE_H
    got = []
    for side in SIDES:
        items = box_items(side, 5, 12, w, h)
        a, b = tiled_scene(side, w, h), tiled_scene(side, w, h)
        for key, box, col in items:
            a.add_object(key, side.region.fillshape(side.shape_of_box(box), side.fills.plain(col)))
        b.add_boxes([(key, box, side.C.rgba_of_colour(col)) for key, box, col in items])
        order = [key for key, _, _ in items]
        frame = render_lists(side, b, order, w, h)
        assert np.array_equal(render_lists(side, a, order, w, h), frame), side.name
        got.append((frame, atlas_np(side, b), {k: list(v) for k, v in b.pieces.items()}, state(side, b)))
    for a, b in zip(*got):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_build_lists_dirty_tiles_match_jax(both_sides):
    w, h = 4 * TILE_W, 3 * TILE_H
    got = []
    for side in SIDES:
        ts = tiled_scene(side, w, h)
        items = box_items(side, 6, 10, w, h)
        ts.add_boxes([(key, box, side.C.rgba_of_colour(col)) for key, box, col in items])
        order = [key for key, _, _ in items]
        starts, idxs = ts.build_lists(order, dirty_tiles=[0, 5, 6, 11])
        got.append((np.asarray(starts), np.asarray(idxs), render_lists(side, ts, order, w, h, [0, 5, 6, 11])))
    for a, b in zip(*got):
        assert np.array_equal(a, b)
    assert np.array_equal(np.diff(got[1][0])[[1, 2, 3, 4, 7, 8, 9, 10]], np.zeros(8))


def general_render(side, scene, w=W, h=H) -> np.ndarray:
    """The general renderer's frame of `scene` over white, as uint8."""
    region = side.region
    spr = side.render_simple_scene(scene, side.shape_of_box((1, 1, w, h)))
    white = region.fillshape(side.shape_of_box((1, 1, w, h)), side.fills.plain(side.C.white))
    (x0, y0, _, _), _, rgba = side.np_sprite(region.caf("over", "opaque", spr, white)[0])
    out = np.zeros((h, w, 4), np.uint8)
    out[y0 - 1 : y0 - 1 + rgba.shape[0], x0 - 1 : x0 - 1 + rgba.shape[1]] = rgba
    return out


def test_sprite_route_matches_general_renderer_and_tiled(both_sides):
    got = []
    for side in SIDES:
        C = side.C
        scene = [circle_obj(side, 60, 60, 30, C.red, 150), circle_obj(side, 100, 64, 35, C.green),
                 circle_obj(side, 180, 60, 30, C.blue, 220)]
        v = device_view(side)
        v.set_scene(scene)
        v.render(full=True)
        assert all(v.sprites[o.idset] is not None for o in scene), "the sprite route keeps no sprite"
        assert np.array_equal(v.read(), general_render(side, scene)), side.name
        t = device_view(side)
        t.set_scene(scene, tiled=True)
        t.render(full=True)
        assert np.array_equal(v.read(), t.read()), side.name
        got.append((v.read(), atlas_np(side, v.ts), [list(v.ts.pieces[k]) for k in v.order]))
    for a, b in zip(*got):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def edit_sequence(side):
    """The sprite route's view through add, replace, remove and restack,
    rendering the dirty tiles after each.  Returns (frames, a fresh view's
    frame of the edited scene, atlas, piece lists, free runs)."""
    C = side.C
    base = [circle_obj(side, 100, 64, 40, C.green), circle_obj(side, 150, 50, 30, C.blue, 150),
            circle_obj(side, 60, 70, 25, C.red, 200)]
    v = device_view(side)
    v.set_scene(base)
    v.render(full=True)
    frames = [v.read()]
    v.add_object(circle_obj(side, 120, 50, 20, C.gold, 180), 0)
    v.render()
    frames.append(v.read())
    v.replace_object(base[0].idset, circle_obj(side, 100, 64, 40, C.purple, 230))
    v.render()
    frames.append(v.read())
    v.remove_object(base[2].idset)
    v.render()
    frames.append(v.read())
    order = list(v.order)
    order[1], order[2] = order[2], order[1]
    v.restack(order)
    v.render()
    frames.append(v.read())
    fresh = device_view(side)
    fresh.set_scene([v.objs[k] for k in v.order])
    fresh.render(full=True)
    return frames, fresh.read(), atlas_np(side, v.ts), [list(v.ts.pieces[k]) for k in v.order], list(v.ts._free_runs)


def test_deviceview_edits_match_jax_and_a_fresh_view(both_sides):
    jax_run, port_run = (edit_sequence(side) for side in SIDES)
    for k, (a, b) in enumerate(zip(jax_run[0], port_run[0])):
        assert np.array_equal(a, b), f"frame {k}"
    for k in range(1, len(port_run[0])):
        assert not np.array_equal(port_run[0][k], port_run[0][k - 1]), f"edit {k} changed nothing"
    assert np.array_equal(port_run[0][-1], port_run[1])
    assert np.array_equal(jax_run[2], port_run[2])
    assert jax_run[3:] == port_run[3:]


def test_deviceview_restack_like_jax(both_sides):
    got = []
    for side in SIDES:
        C = side.C
        a, b = circle_obj(side, 100, 64, 30, C.red), circle_obj(side, 120, 64, 30, C.blue)
        v = device_view(side)
        v.set_scene([a, b])
        v.render(full=True)
        assert tuple(v.read()[63, 109][:3]) == (255, 0, 0)
        v.restack([b.idset, a.idset])
        v.render()
        assert tuple(v.read()[63, 109][:3]) == (0, 0, 255)
        got.append(v.read())
    assert np.array_equal(*got)


def test_remove_and_re_add_churn_keeps_the_atlas(both_sides):
    got = []
    for side in SIDES:
        C = side.C
        v = device_view(side, atlas_cap=64)
        v.set_scene([circle_obj(side, 100, 64, 40, C.green)])
        blob = circle_obj(side, 50, 40, 15, C.crimson, 170)
        v.add_object(blob, 0)
        v.make_animated(blob.idset)
        v.render(full=True)
        first = None
        for _ in range(6):
            v.remove_object(blob.idset)
            v.render()
            blob = circle_obj(side, 50, 40, 15, C.crimson, 170)
            v.add_object(blob, 0)
            v.render()
            first = first or state(side, v.ts)
            assert state(side, v.ts) == first, side.name
        got.append((v.read(), first))
    assert np.array_equal(got[0][0], got[1][0]) and got[0][1] == got[1][1]


def fallback_scene(side):
    R, C = side.R, side.C
    grad = R.Obj(side.ident.new_ids(), R.Basic(side.fills.gradient((20.0, 20.0), (120.0, 80.0), True, True, C.red,
                                                                   C.dissolve(C.gold, delta=150)),
                                               R.PathShape(side.gshapes.circle(70.0, 60.0, 35.0))), (), R.OVER)
    cpg = R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.navy),
                                              R.CPG(R.SUBTRACTION, R.PathShape(side.gshapes.circle(170.0, 60.0, 30.0)),
                                                    R.PathShape(side.gshapes.circle(185.0, 60.0, 20.0)))),
                (), R.OVER)
    group = R.mkgroup([circle_obj(side, 200, 100, 18, C.teal, 200), circle_obj(side, 220, 90, 12, C.red)])
    return [grad, cpg, group, circle_obj(side, 120, 64, 45, C.green, 120)]


def test_tiled_build_falls_back_like_jax(both_sides):
    got = []
    for side in SIDES:
        scene = fallback_scene(side)
        keyed = [(o.idset, o) for o in scene]
        staged = (JF.stage_tiled_scene(2, 2, W, H, keyed) if side is JAX
                  else TF.stage_tiled_scene(2, 2, W, H, keyed, "cpu"))
        assert len(staged) == 6 and staged[5] is None
        assert [k for k, _ in staged[3]] == [o.idset for o in scene[:3]]
        v = device_view(side)
        v.set_scene(scene, tiled=True, staged=staged)
        v.render(full=True)
        s = device_view(side)
        s.set_scene(scene)
        s.render(full=True)
        assert np.array_equal(v.read(), s.read()), side.name
        assert np.array_equal(v.read(), general_render(side, scene)), side.name
        got.append((v.read(), atlas_np(side, v.ts), [list(v.ts.pieces[k]) for k in v.order]))
    for a, b in zip(*got):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_translate_tiled_group_object_like_jax(both_sides):
    got = []
    for side in SIDES:
        grp = side.R.mkgroup([circle_obj(side, 40, 40, 20, side.C.blue, 200), circle_obj(side, 70, 60, 18, side.C.red)])
        v = device_view(side)
        v.set_scene([grp], tiled=True)
        v.render(full=True)
        v.translate_object(grp.idset, 25, 10)
        v.render()
        got.append(v.read())
    assert np.array_equal(*got)
    assert not np.array_equal(got[1][30:80, 30:100], np.full_like(got[1][30:80, 30:100], 255))


def test_sprites_of_keys_match_jax(both_sides):
    got = []
    for side in SIDES:
        scene = fallback_scene(side)[:2] + [circle_obj(side, 120, 64, 45, side.C.green, 120),
                                            circle_obj(side, -400, 64, 20, side.C.red)]
        v = device_view(side)
        v.set_scene(scene, tiled=True)
        sprites = (JF.sprites_of_keys(v.ts, v.order) if side is JAX else TF.sprites_of_keys(v.ts, v.order))
        got.append([side.np_sprite(s) for s in sprites])
    assert got[0][-1] is None and got[1][-1] is None
    for k, (a, b) in enumerate(zip(*got)):
        if a is None:
            assert b is None, k
            continue
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]), k
