"""The port's device window path (raster/framepath.py) against the JAX
package's, bit for bit.

The scenarios of the JAX package's ``tests/test_framepath.py`` and two of
``tests/test_blit_blur.py`` run on both sides, each side building its own
objects and sprites; every framebuffer read is compared across the
packages and with the scenario's own reference (the general renderer, or a
full recomposite).  The fold itself, ``fold_layers_carry``, is held to the
JAX package's on seeded numpy layers, and one call to two chunks with the
carry.  Tolerance 0: the colour math is integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherence_tpu.raster import framepath as JFP
from coherence_tpu.scene import fastframe as JF

from coherence_tpu_torch.raster import framepath as TFP
from coherence_tpu_torch.scene import fastframe as TF

from _torch_general import JAX, SIDES, both_sides  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import fold_case, fold_params


def frame_buffer(side, w, h, colour):
    fp = JFP if side is JAX else TFP
    return fp.FrameBuffer(w, h, colour) if side is JAX else fp.FrameBuffer(w, h, colour, device="cpu")


def full_sprite(side, o):
    return JF.full_sprite_of_object(o) if side is JAX else TF.full_sprite_of_object(o, "cpu")


def circle_obj(side, x, y, r, colour, alpha=255):
    fill = side.fills.plain(side.C.dissolve(colour, delta=alpha))
    return side.R.Obj(side.ident.new_ids(), side.R.Basic(fill, side.R.PathShape(side.gshapes.circle(x, y, r))), (),
                      side.R.OVER)


def rect_obj(side, colour, x, y, w, h):
    return side.R.Obj(side.ident.new_ids(), side.R.Basic(side.fills.plain(colour),
                                                         side.R.rectangle(float(x), float(y), float(w), float(h))),
                      (), side.R.OVER)


def read(fb) -> np.ndarray:
    return np.asarray(fb.read()).astype(np.int32)


def over_white(side, spr, w, h) -> np.ndarray:
    """The general renderer's sprite (inside the window) over a white
    (h, w) window: colour.over_rgba in numpy."""
    top = np.zeros((h, w, 4), np.int64)
    got = side.np_sprite(spr)
    if got is not None:
        (x0, y0, _, _), m, r = got
        sub = top[y0 - 1 : y0 - 1 + m.shape[0], x0 - 1 : x0 - 1 + m.shape[1]]
        sub[m] = r[m]
    p, a = np.full_like(top, 255), top[..., 3:4]
    t = a * p + 128
    blend = p + top - (((t >> 8) + t) >> 8)
    return np.where(a == 0, p, np.where(a == 255, top, blend)).astype(np.int32)


def test_framebuffer_composite_matches_general_renderer(both_sides):
    got = []
    for side in SIDES:
        C = side.C
        scene = [circle_obj(side, 40, 40, 22, C.red, 150), circle_obj(side, 60, 55, 25, C.green),
                 circle_obj(side, 80, 40, 22, C.blue, 200)]
        fb = frame_buffer(side, 160, 120, C.white)
        fb.composite((1, 1, 160, 120), [full_sprite(side, o) for o in scene])
        want = over_white(side, side.render_simple_scene(scene, side.shape_of_box((1, 1, 160, 120))), 160, 120)
        assert np.array_equal(read(fb), want), side.name
        got.append(read(fb))
    assert np.array_equal(got[0], got[1])


def test_recomposite_window_matches_full_composite(both_sides):
    got = []
    for side in SIDES:
        C = side.C
        base = full_sprite(side, circle_obj(side, 50, 50, 30, C.green))
        blob = full_sprite(side, circle_obj(side, 30, 30, 12, C.crimson, 170))
        fb = frame_buffer(side, 128, 128, C.white)
        fb.composite((1, 1, 128, 128), [blob, base])
        moved = side.region.translate_sprite(15, 10, blob)
        fb.recomposite(side.region.box_union(blob.box, moved.box), [moved, base])
        fresh = frame_buffer(side, 128, 128, C.white)
        fresh.composite((1, 1, 128, 128), [moved, base])
        assert np.array_equal(read(fb), read(fresh)), side.name
        got.append(read(fb))
    assert np.array_equal(got[0], got[1])


def test_clear_window(both_sides):
    got = []
    for side in SIDES:
        C = side.C
        fb = frame_buffer(side, 64, 64, C.white)
        spr = side.region.fillshape(side.shape_of_box((10, 10, 50, 50)), side.fills.plain(C.red))
        fb.composite((1, 1, 64, 64), [spr])
        fb.clear_window((20, 20, 30, 30))
        img = read(fb)
        assert tuple(img[24, 24]) == C.rgba_of_colour(C.white)
        assert tuple(img[14, 14]) == C.rgba_of_colour(C.red)
        got.append(img)
    assert np.array_equal(got[0], got[1])


def test_partial_window_composite_no_double_blend(both_sides):
    """A dirty box that buckets to (32, 256) reaches a translucent sprite in
    the bucket's padding ring: painting stays clipped to the box."""
    got = []
    for side in SIDES:
        C = side.C
        fb = frame_buffer(side, 256, 64, C.white)
        spr = side.region.fillshape(side.shape_of_box((1, 1, 200, 40)), side.fills.plain(C.dissolve(C.navy, delta=120)))
        fb.composite((1, 1, 256, 64), [spr])
        expect = read(fb).copy()
        fb.clear_window((1, 1, 150, 20))
        fb.composite((1, 1, 150, 20), [spr])
        assert np.array_equal(read(fb), expect), side.name
        got.append(read(fb))
    assert np.array_equal(got[0], got[1])


# The blur-filter frames of tests/test_blit_blur.py.
W, H = 160, 120
RADIUS = 2
F_BOX = (30, 20, 130, 100)


def statics(side):
    C = side.C
    return [rect_obj(side, C.dissolve(C.steelblue, delta=200), 50, 35, 40, 30),
            circle_obj(side, 100.0, 70.0, 18.0, C.darkgreen), rect_obj(side, C.white, 1, 1, W, H)]


def blob_at(side, cx, cy):
    return circle_obj(side, float(cx), float(cy), 9.0, side.C.crimson, 170)


def filter_obj(side, kernel):
    geom = side.R.Basic(side.fills.plain(side.C.white),
                        side.R.rectangle(float(F_BOX[0]), float(F_BOX[1]), float(F_BOX[2] - F_BOX[0] + 1),
                                         float(F_BOX[3] - F_BOX[1] + 1)))
    return side.R.Obj(side.ident.new_ids(), side.filters.blur(geom, kernel), (), side.R.OVER)


def f_alpha(side, kernel):
    geom = side.R.Obj(side.ident.new_ids(), filter_obj(side, kernel).geometry.filter.geometry, (), side.R.OVER)
    return JF.alpha_plane_of_object(geom, W, H) if side is JAX else TF.alpha_plane_of_object(geom, W, H, "cpu")


def general_frame(side, kernel, blob):
    spr = side.render_simple_scene([filter_obj(side, kernel), blob] + statics(side), side.shape_of_box((1, 1, W, H)))
    return over_white(side, spr, W, H)


def blur_frames(side, positions):
    """The frames of a blob dragged through `positions` under the lens:
    the first composited whole and blurred, each later one recomposited in
    its dirty window.  Returns (frames, the general renderer's frames)."""
    kernel = side.convolve.mkgaussian(RADIUS)
    fb = frame_buffer(side, W, H, side.C.white)
    stat = [s for s in (full_sprite(side, o) for o in statics(side)) if s is not None]
    alpha = f_alpha(side, kernel)
    spr = full_sprite(side, blob_at(side, *positions[0]))
    fb.composite((1, 1, W, H), [spr] + stat)
    fb.apply_blur(alpha, kernel)
    frames, want = [read(fb)], [general_frame(side, kernel, blob_at(side, *positions[0]))]
    for k in range(1, len(positions)):
        dx, dy = positions[k][0] - positions[k - 1][0], positions[k][1] - positions[k - 1][1]
        moved = side.region.translate_sprite(dx, dy, spr)
        fb.recomposite_blur(side.region.box_union(spr.box, moved.box), [moved] + stat, alpha, kernel)
        spr = moved
        frames.append(read(fb))
        side.cache.clear()
        want.append(general_frame(side, kernel, blob_at(side, *positions[k])))
    return frames, want


@pytest.mark.parametrize("positions", [[(40, 50), (47, 53), (54, 56), (61, 59)], [(18, 60), (26, 61), (34, 62)]],
                         ids=["matches_general_renderer", "dirty_crossing_filter_edge"])
def test_blit_blur_frames(positions, both_sides):
    got = [blur_frames(side, positions) for side in SIDES]
    for side, (frames, want) in zip(SIDES, got):
        for k, (a, b) in enumerate(zip(frames, want)):
            assert np.array_equal(a, b), f"{side.name} frame {k}"
    for k, (a, b) in enumerate(zip(got[0][0], got[1][0])):
        assert np.array_equal(a, b), f"frame {k}: port differs from JAX"


@pytest.mark.parametrize("seed,k,hb,wb,case", fold_params((0, 7, 24, 40), (1, 12, 16, 128)))
def test_fold_layers_carry_matches_jax_and_chunks(seed, k, hb, wb, case):
    offs, layers, open_mask = fold_case(seed, k, hb, wb, case)
    flat = [jnp.asarray(a) for rgba, mask in layers for a in (rgba, mask)]
    want = JFP.fold_layers_carry(jnp.asarray(offs), flat, jnp.zeros((hb, wb, 4), jnp.int32), jnp.asarray(open_mask),
                                 jnp.zeros((hb, wb), bool))
    tl = [(torch.from_numpy(rgba), torch.from_numpy(mask)) for rgba, mask in layers]
    carry = (torch.zeros((hb, wb, 4), dtype=torch.int32), torch.from_numpy(open_mask),
             torch.zeros((hb, wb), dtype=torch.bool))
    whole = TFP.fold_layers_carry(offs.tolist(), tl, *carry)
    for a, b in zip(want, whole):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(carry[1].numpy(), open_mask), "the fold changed its input"
    cut = k // 2
    first = TFP.fold_layers_carry(offs[:cut].tolist(), tl[:cut], *carry)
    chunked = TFP.fold_layers_carry(offs[cut:].tolist(), tl[cut:], *first)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert bool(whole[2].any()) and not bool(whole[1].all())
