"""The port's FastSession (gui/fastserver.py) against the JAX package's,
over real localhost sockets: the JAX package's own 320 x 200 session scene
through both, with the same client script (paints, a drag out and back, a
blur-slider sweep).  On each side the client's image equals the server's
display plane; across sides the images are equal, and so are the bytes the
server wrote to its socket.  Also the filter lens's alpha plane for lenses
that are not plain paths (a stroked path, a CPG).  Tolerance 0."""

import numpy as np
import pytest
import torch

from _torch_general import both_sides  # noqa: F401
from _torch_serving import DEADLINE, JAX_S, PORT_S, SERVING_SIDES, ServedClient, in_thread, socket_pair, wait_for
from _torch_threads import one_torch_thread  # noqa: F401

W_, H_ = 320, 200


def session_scene(side):
    R, C = side.R, side.C
    objs = [
        R.mkrectangle(20.0, 30.0, 180.0, 120.0, side.fills.plain(C.dissolve(C.teal, delta=200))),
        R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.gold), R.PathShape(side.gshapes.circle(220.0, 120.0, 45.0))),
              (), R.OVER),
    ]
    blob = R.Obj(side.ident.new_ids(),
                 R.Basic(side.fills.plain(C.dissolve(C.crimson, delta=170)), R.PathShape(side.gshapes.circle(0.0, 0.0, 22.0))),
                 (side.tr.Translate(80.0, 100.0),), R.OVER)
    f_geom = R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.white), R.rectangle(120.0, 60.0, 120.0, 80.0)), (), R.OVER)
    return objs, blob, f_geom


DRAGS = [(9, 4), (-5, 7), (12, -6), (40, 30), (-40, -30), (-16, -5)]  # out and back to the start
SLIDER = [1, 2, 5, 3]


def serve(side, conn, holder, setup=None):
    objs, blob, f_geom = session_scene(side)
    sess = side.FastSession(conn, W_, H_, objs, blob, f_geom, blur_radius=3, name="session")
    holder["sess"] = sess
    if setup is not None:
        setup(sess)
    sess.run()


def display_np(side, sess):
    rgba = sess.disp.rgba
    return side.plane_np(rgba if isinstance(rgba, torch.Tensor) or side is JAX_S else rgba.gather("cpu"))


def run_session(side, setup=None):
    """Returns (client images after each stage, server planes at the same
    moments, refresh counts per stage, bytes the server wrote).  `setup`
    runs on the session after its first frame and before its loop."""
    sconn, cconn = socket_pair(side, side, record=True)
    holder = {}
    t, fail = in_thread(serve, side, sconn, holder, setup)
    sc = ServedClient(side, cconn)
    c = sc.c
    images, planes, counts = [], [], []

    def snap():
        assert not fail, fail
        sess = wait_for(holder, "sess", fail)
        images.append(c.windows[win].image.copy())
        planes.append(display_np(side, sess)[..., :3].astype(np.uint8))
        counts.append(sc.refreshes)

    c.app_start()
    sc.await_refresh(1 if setup is None else 2)  # the first full frame, and setup's
    sc.drain()
    win = next(iter(c.windows))
    snap()
    sess = holder["sess"]
    bx0, by0, bx1, by1 = sess.view.sprites[sess.blob_key].box
    x, y = (bx0 + bx1) // 2, (by0 + by1) // 2
    c.send_event("LeftDown", win, x, y)
    for dx, dy in DRAGS:
        x, y = x + dx, y + dy
        c.send_event("LeftDragging", win, x, y)
        sc.await_refresh()  # exactly one window per drag
        sc.drain()
        snap()
    c.send_event("LeftDragging", win, x, y)  # no movement: no frame
    c.send_event("LeftUp", win, x, y)
    c.send_event("LeftDragging", win, x + 5, y)  # not dragging: no frame
    sc.barrier(win)
    snap()
    for v in SLIDER:
        c.send_event("BlurSlider", win, v)
        sc.await_refresh()
        sc.drain()
        snap()
    c.paint(win, 100, 50, 120, 90)
    sc.await_refresh()
    c.send_event("LeftDown", win, 5, 5)  # misses the blob
    c.send_event("LeftDragging", win, 9, 9)
    sc.barrier(win)
    snap()
    box = sess.view.sprites[sess.blob_key].box
    sc.finish()
    t.join(DEADLINE)
    assert not fail and not t.is_alive()
    cconn.close()
    return images, planes, counts, bytes(sconn.sock.sent), (sess.lens_box, box, (bx0, by0, bx1, by1))


@pytest.fixture(scope="module")
def sessions():
    from coherence_tpu.scene import cache as j_cache
    from coherence_tpu_torch.scene import cache as t_cache

    j_cache.clear()
    t_cache.clear()
    out = {side.name: run_session(side) for side in SERVING_SIDES}
    j_cache.clear()
    t_cache.clear()
    return out


def reship(mesh=None):
    """A setup for run_session: split the view over `mesh` when given, then
    blur-blend and ship the whole display again."""

    def setup(sess):
        if mesh is not None:
            sess.view.use_mesh(mesh)
        sess.disp.full_refresh()
        sess.ship_full()

    return setup


def test_meshed_session_ships_what_an_unsharded_one_ships(both_sides):
    """A FastSession over a 2-band mesh on one CPU device: ship_window reads
    each window's rows from their bands.  The client's images, the server's
    planes, the refresh counts and every byte on the socket equal those of
    the same session unsharded."""
    from coherence_tpu_torch.parallel import mesh as TM

    plain = run_session(PORT_S, reship())
    PORT_S.cache.clear()
    meshed = run_session(PORT_S, reship(TM.make_mesh(2, ["cpu"] * 2)))
    assert len(meshed[0]) == len(plain[0]) == 1 + len(DRAGS) + 1 + len(SLIDER) + 1
    for i, (a, b) in enumerate(zip(plain[0], meshed[0])):
        assert np.array_equal(a, b), f"client image, stage {i}"
    for i, (a, b) in enumerate(zip(plain[1], meshed[1])):
        assert np.array_equal(a, b), f"server plane, stage {i}"
    assert plain[2] == meshed[2] and plain[4] == meshed[4]
    assert plain[3] == meshed[3] and plain[3].count(b"RefreshWindow") == plain[2][-1]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_client_image_equals_the_server_plane(sessions, side):
    images, planes, counts, _, _ = sessions[side]
    assert len(images) == 1 + len(DRAGS) + 1 + len(SLIDER) + 1
    for i, (img, plane) in enumerate(zip(images, planes)):
        assert np.array_equal(img[:H_, :W_], plane), f"stage {i}"


def test_client_images_equal_across_packages(sessions):
    for i, (a, b) in enumerate(zip(sessions["jax"][0], sessions["port"][0])):
        assert np.array_equal(a, b), f"stage {i}"
    assert sessions["jax"][4] == sessions["port"][4]


def test_server_wrote_the_same_bytes(sessions):
    a, b = sessions["jax"][3], sessions["port"][3]
    assert len(a) == len(b) and a == b
    assert b.count(b"RefreshWindow") == sessions["port"][2][-1]


def test_one_refresh_per_drag_and_none_for_idle_events(sessions):
    counts = sessions["port"][2]
    assert counts == sessions["jax"][2]
    assert counts[: 1 + len(DRAGS)] == list(range(1, 2 + len(DRAGS)))
    # After the drags: the barrier's paint only, then one per slider step, then a paint and a barrier.
    assert counts[1 + len(DRAGS)] == counts[len(DRAGS)] + 1
    assert counts[-1] == counts[1 + len(DRAGS)] + len(SLIDER) + 2


def test_drag_reships_a_window_and_the_blob_comes_back(sessions):
    images, _, _, _, (lens_box, box, start) = sessions["port"]
    assert box == start and lens_box == (120, 60, 240, 140)
    diff = np.argwhere((images[1] != images[0]).any(-1))
    assert len(diff) > 0
    ys, xs = diff[:, 0], diff[:, 1]
    r = 3
    assert ys.max() - ys.min() <= (start[3] - start[1] + 1) + 4 + 4 * r + 64
    assert xs.max() - xs.min() <= (start[2] - start[0] + 1) + 9 + 4 * r + 64
    # Back at the start with the first radius: the first frame again.
    assert np.array_equal(images[1 + len(DRAGS)], images[0])
    # The slider passes radius 5 and ends on the first radius again.
    assert not np.array_equal(images[-3], images[0]) and np.array_equal(images[-2], images[0])


LENSES = {
    "stroked path": lambda s: s.R.Basic(s.fills.plain(s.C.white), s.R.StrokedPathShape(
        s.gshapes.circle(150.0, 100.0, 60.0),
        s.gshapes.StrokeSpec(startcap=s.gshapes.ButtCap, join=s.gshapes.MitredJoin, endcap=s.gshapes.ButtCap,
                             mitrelimit=10.0, linewidth=14.0))),
    "cpg": lambda s: s.R.Basic(s.fills.plain(s.C.dissolve(s.C.white, delta=200)), s.R.CPG(
        s.R.SUBTRACTION, s.R.PathShape(s.gshapes.circle(140.0, 100.0, 70.0)), s.R.PathShape(s.gshapes.circle(170.0, 110.0, 40.0)))),
    "path off the frame's edge": lambda s: s.R.Basic(s.fills.plain(s.C.white), s.R.PathShape(s.gshapes.circle(300.0, 10.0, 50.5))),
    "path outside the frame": lambda s: s.R.Basic(s.fills.plain(s.C.white), s.R.rectangle(400.0, 300.0, 20.0, 20.0)),
}


@pytest.mark.parametrize("name", list(LENSES))
def test_lens_alpha_plane_matches_jax(name, both_sides):
    planes = []
    for side in SERVING_SIDES:
        from coherence_tpu.scene import fastframe as JF
        from coherence_tpu_torch.scene import fastframe as TF

        o = side.R.Obj(side.ident.new_ids(), LENSES[name](side), (side.tr.Translate(3.0, -2.0),), side.R.OVER)
        planes.append(np.asarray(JF.alpha_plane_of_object(o, W_, H_)) if side is JAX_S
                      else TF.alpha_plane_of_object(o, W_, H_, "cpu").numpy())
    assert planes[0].shape == planes[1].shape == (H_, W_)
    assert np.array_equal(planes[0], planes[1])
    assert planes[1].any() == (name != "path outside the frame")


def test_session_under_a_stroked_lens_matches_jax(both_sides):
    """A FastSession whose lens is a stroked ring: the first frame and one
    drag under it, on both sides."""
    got = []
    for side in SERVING_SIDES:
        sconn, cconn = socket_pair(side, side)
        holder = {}

        def serve_ring(side=side, sconn=sconn, holder=holder):
            objs, blob, _ = session_scene(side)
            lens = side.R.Obj(side.ident.new_ids(), LENSES["stroked path"](side), (), side.R.OVER)
            holder["sess"] = side.FastSession(sconn, W_, H_, objs, blob, lens, blur_radius=2, name="ring")
            holder["sess"].run()

        t, fail = in_thread(serve_ring)
        sc = ServedClient(side, cconn)
        sc.c.app_start()
        sc.await_refresh()
        win = next(iter(sc.c.windows))
        sc.c.send_event("LeftDown", win, 80, 100)
        sc.c.send_event("LeftDragging", win, 100, 95)
        sc.await_refresh()
        plane = side.plane_np(wait_for(holder, "sess", fail).disp.rgba)[..., :3].astype(np.uint8)
        assert np.array_equal(sc.c.windows[win].image[:H_, :W_], plane)
        got.append(sc.c.windows[win].image.copy())
        sc.finish()
        t.join(DEADLINE)
        assert not fail, fail
        cconn.close()
    assert np.array_equal(got[0], got[1])


def test_port_session_defaults_to_the_card():
    sconn, cconn = socket_pair(PORT_S, PORT_S)
    objs, blob, f_geom = session_scene(PORT_S)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PORT_S.fastserver.FastSession(sconn, W_, H_, objs, blob, f_geom)
    sconn.close()
    cconn.close()


def test_port_session_tells_the_client_when_an_event_raises(both_sides):
    """run()'s finally sends AppClose before the exception surfaces, so a
    client never waits on a dead server."""
    sconn, cconn = socket_pair(PORT_S, PORT_S)

    def serve_broken():
        objs, blob, f_geom = session_scene(PORT_S)
        sess = PORT_S.FastSession(sconn, W_, H_, objs, blob, f_geom, blur_radius=3)

        def broken(v):
            raise NotImplementedError("not ported")

        sess.set_blur = broken
        sess.run()

    t, fail = in_thread(serve_broken)
    sc = ServedClient(PORT_S, cconn)
    sc.c.app_start()
    sc.await_refresh()
    sc.c.send_event("BlurSlider", 1, 4)
    with pytest.raises(RuntimeError, match="closed the session"):
        sc.await_refresh()
    t.join(DEADLINE)
    assert len(fail) == 1 and isinstance(fail[0], NotImplementedError)
    cconn.close()


def test_port_ship_window_clamps_its_bucket(both_sides):
    """The shipped rectangle is the pow2 bucket of the asked one, clamped
    inside the plane: the rects the display saw."""
    sconn, cconn = socket_pair(PORT_S, PORT_S)
    holder = {}

    def serve_once():
        objs, blob, f_geom = session_scene(PORT_S)
        sess = PORT_S.FastSession(sconn, W_, H_, objs, blob, f_geom, blur_radius=3)
        shipped = []
        real = sess.wx.display.refresh_window
        sess.wx.display.refresh_window = lambda w, x, y, ww, hh, data: (shipped.append((x, y, ww, hh, len(data))),
                                                                        real(w, x, y, ww, hh, data))
        before = PORT_S.region.syncs
        sess.ship_window(300, 190, 400, 260)  # hangs over the corner
        sess.ship_window(10, 10, 12, 11)
        sess.ship_window(50, 60, 40, 70)  # empty
        sess.ship_full()
        holder["shipped"], holder["syncs"] = shipped, PORT_S.region.syncs - before
        sess.run()

    t, fail = in_thread(serve_once)
    sc = ServedClient(PORT_S, cconn)
    sc.c.app_start()
    sc.await_refresh(4)
    sc.finish()
    t.join(DEADLINE)
    assert not fail, fail
    cconn.close()
    bucket = PORT_S.region.bucket_hw
    hb, wb = bucket(11, 21)
    hs, ws = bucket(2, 3)
    assert holder["shipped"] == [(W_ - wb, H_ - hb, wb, hb, wb * hb * 3), (9, 9, ws, hs, ws * hs * 3),
                                 (0, 0, W_, H_, W_ * H_ * 3)]
    assert holder["syncs"] == 3  # one host copy per shipped window
