"""The port's window system (gui/window.py: HeadlessDisplay, WindowSystem,
plot_sprite, plot_shape, refresh_window, the canvas byte strings) against
the JAX package's: the same seeded sprites plotted into the same windows
give equal framebuffers and equal recorded display calls.  Tolerance 0."""

import numpy as np
import pytest
import torch

from _torch_general import both_sides  # noqa: F401
from _torch_serving import JAX_S, PORT_S, SERVING_SIDES
from _torch_threads import one_torch_thread  # noqa: F401


def seeded_sprite(side, seed, box):
    """A sprite over `box` with a seeded mask and seeded premultiplied
    colours (numpy on both sides)."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = box
    h, w = y1 - y0 + 1, x1 - x0 + 1
    mask = rng.random((h, w)) < 0.6
    mask[0, 0] = True
    alpha = rng.integers(0, 256, (h, w, 1))
    rgba = np.concatenate([rng.integers(0, 256, (h, w, 3)) * alpha // 255, alpha], -1).astype(np.int32)
    shp = side.shape_of_mask(box, mask)
    if side is JAX_S:
        import jax.numpy as jnp

        H, W = shp.mask.shape
        plane = jnp.zeros((H, W, 4), jnp.int32).at[:h, :w].set(rgba)
        return side.region.sprite_of_mask_rgba(box, shp.mask, plane)
    return side.region.sprite_of_mask_rgba(box, shp.mask, torch.from_numpy(rgba))


PLOTS = {
    "inside": ((10, 10, 60, 40), 0, 0),
    "shifted": ((10, 10, 60, 40), 7, -3),
    "over the top left": ((-20, -15, 30, 25), 0, 0),
    "over the bottom right": ((1250, 1000, 1300, 1040), 0, 0),
    "moved off the window": ((10, 10, 60, 40), -200, 0),
    "one pixel": ((5, 5, 5, 5), 0, 0),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plot_sprite_matches_jax(name, both_sides):
    box, dx, dy = PLOTS[name]
    fbs = []
    for side in SERVING_SIDES:
        ws = side.window.WindowSystem()
        w = ws.make_window("t", 100, 80, 0, 0, 0, 0)
        ws.framebuffers[w][:] = 9
        ws.plot_sprite(w, dx, dy, seeded_sprite(side, 11, box))
        ws.plot_sprite(w, dx, dy, None)
        ws.plot_sprite(w + 5, dx, dy, seeded_sprite(side, 11, box))  # no such window
        fbs.append(ws.framebuffers[w])
    assert fbs[0].shape == fbs[1].shape == (1024, 1280, 3)
    assert np.array_equal(fbs[0], fbs[1])
    if name not in ("moved off the window",):
        assert (fbs[1] != 9).any()


def test_plot_shape_and_refresh_match_jax(both_sides):
    out = []
    for side in SERVING_SIDES:
        C = side.C
        ws = side.window.WindowSystem()
        w = ws.make_window("t", 100, 100, 0, 0, 0, 0)
        spr = side.region.fillshape(side.shape_of_box((10, 10, 19, 19)), side.fills.plain(C.red))
        ws.plot_sprite(w, 0, 0, spr)
        circle = side.R.Obj(side.ident.new_ids(), side.R.Basic(side.fills.plain(C.blue),
                            side.R.PathShape(side.gshapes.circle(50.0, 50.0, 20.0))), (), side.R.OVER)
        ws.plot_shape(w, 3, 4, C.dissolve(C.green, delta=100), side.shapeonly_of_basicshape(circle))
        ws.plot_shape(w, 0, 0, C.green, None)
        fb = ws.framebuffers[w]
        assert tuple(fb[10, 10]) == (255, 0, 0) and tuple(fb[9, 9]) == (0, 0, 0)
        for rect in [(10, 10, 19, 19), (0, 0, 0, 50), (5, 5, 50, 5), (-4, -4, 30, 30), (1270, 1000, 1400, 1100)]:
            ws.refresh_window(w, rect)
        ws.refresh_window(w + 1, (0, 0, 5, 5))
        out.append((fb, list(ws.display.refreshed)))
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    assert out[1][1][0] == (1, (10, 10, 10, 10)) and len(out[1][1]) == 3


def test_refresh_ships_the_framebuffer_rows(both_sides):
    """What reaches the display is the rect's bytes, row by row."""
    for side in SERVING_SIDES:
        ws = side.window.WindowSystem()
        shipped = []
        ws.display.refresh_window = lambda w, x, y, width, height, data: shipped.append((w, x, y, width, height, data))
        w = ws.make_window("t", 50, 50, 0, 0, 0, 0)
        ws.framebuffers[w][:] = np.random.default_rng(2).integers(0, 256, ws.framebuffers[w].shape, dtype=np.uint8)
        ws.refresh_window(w, (3, 4, 10, 9))
        assert shipped == [(w, 3, 4, 8, 6, ws.framebuffers[w][4:10, 3:11].tobytes())]


def test_canvas_bytes_match_jax(both_sides):
    got = []
    for side in SERVING_SIDES:
        canvas = side.newcanvas(5, 3, side.C.dissolve(side.C.gold, delta=140))
        icon = side.icon_of_pdf(__import__("os").path.join(side.examples.path, "up.pdf"))
        got.append([side.window.rgb_bytes_of_canvas(canvas), side.window.alpha_bytes_of_canvas(canvas),
                    side.window.rgb_bytes_of_canvas(icon), side.window.alpha_bytes_of_canvas(icon)])
    assert got[0] == got[1]
    assert [len(b) for b in got[1]] == [45, 15, 32 * 32 * 3, 32 * 32]


def test_canvas_reads_count_as_syncs():
    region = PORT_S.region
    canvas = PORT_S.newcanvas(4, 4, PORT_S.C.red)
    ws = PORT_S.window.WindowSystem()
    w = ws.make_window("t", 20, 20, 0, 0, 0, 0)
    spr = region.fillshape(PORT_S.shape_of_box((1, 1, 8, 8)), PORT_S.fills.plain(PORT_S.C.red))
    before = region.syncs
    PORT_S.window.rgb_bytes_of_canvas(canvas)
    PORT_S.window.alpha_bytes_of_canvas(canvas)
    assert region.syncs == before + 2
    ws.plot_sprite(w, 0, 0, spr)  # mask and colours in one copy
    assert region.syncs == before + 3


@pytest.mark.parametrize("side", SERVING_SIDES, ids=[s.name for s in SERVING_SIDES])
def test_window_system_bookkeeping(side):
    W = side.window
    ws = W.WindowSystem()
    big = ws.make_window("big", 1920, 1080, 0, 0, 0, 0)
    small = ws.make_window("small", 64, 48, 0, 0, 0, 0)
    assert ws.canvas_size(big) == (1920, 1080) and ws.canvas_size(small) == (1280, 1024)
    assert ws.get_window_size(small) == (64, 48) and ws.get_window_scroll(small) == (0, 0)
    ws.display.mouse = (3, 4)
    assert ws.mouse_coords(small) == (3, 4)
    ws.set_status_bar(small, "s"); ws.set_blurslider(small, 3); ws.set_transslider(small, 9); ws.set_cachetext("c")
    win = ws.display.windows[small]
    assert (win.status, win.blur, win.trans, ws.display.cachetext) == ("s", 3, 9, "c")
    ws.capture_mouse(small); ws.release_mouse(small); ws.open_cachewindow(); ws.shutdown()
    # Modifier keys are consumed by poll and never reach the engine.
    ws.display.post(W.INTERNAL, [b"Command", True])
    ws.display.post(W.INTERNAL, [b"Shift", 1])
    ws.display.post(W.INTERNAL, [b"Option", True])
    ws.display.post(W.KEY_DOWN, small, W.Left)
    assert ws.poll() == (W.KEY_DOWN, small, W.Left)
    assert (ws.command_down, ws.shift_down, ws.option_down) == (True, True, True)
    ws.display.post(W.INTERNAL, [b"Command", False])
    assert ws.poll() == (W.NULL_EVENT,) and not ws.command_down
    ws.startup([])
    assert ws.poll() == (W.APP_STARTUP,)
    ws.close_window(small)
    assert small not in ws.framebuffers and small not in ws.display.windows
    ws.delete_window(big)
    assert ws.display.screen_size() == (1920, 1080) and ws.display.platform() == "Headless"
    ws.close_application()


def test_serving_device_names_the_card_or_raises():
    W = PORT_S.window
    assert W.serving_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert W.serving_device("cuda").index is not None
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            W.serving_device("cuda")
        with pytest.raises(RuntimeError):
            W.serving_device("cuda:0")
