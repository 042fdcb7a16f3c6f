"""The port's checkpoint, undo and persistence modules (scene/checkpoint,
scene/undo, utils/persist) against the JAX package's.  The checkpoint JSON
is the carrier of scenes between the packages: for every demo scene both
write the same text, a scene written by one is read by the other and renders
the same pixels, and a saved view or sprite file loads on either side.
Tolerance 0."""

import json
import os

import numpy as np
import pytest

from _torch_general import both_sides, dense, same_raster  # noqa: F401
from _torch_serving import JAX_S, PORT_S, SERVING_SIDES
from _torch_threads import one_torch_thread  # noqa: F401

BOX = (1, 1, 96, 96)

DEMOS = ["redblob", "blueblob", "cpg_example", "affinefilter", "blurfilter", "rgbfilter", "brush", "brushcircle",
         "brushblue", "minusfilter", "monofilter", "q_shape", "q_shape_2", "logo", "radial_filled", "wirecircle", "hole",
         "wireframe", "p6_curve", "p6_curve2", "p6_curve3", "curves", "smear", "wirebrush", "monobrush", "curve",
         "smalllion", "aatext", "mintext1", "mintext2", "filtertext1", "filtertext2", "lionfilter1", "lionfilter2"]


def to_json_or_error(side, scene):
    try:
        return side.checkpoint.scene_to_json(scene)
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}"


@pytest.mark.parametrize("name", DEMOS)
def test_demo_scene_json_text_equal(name):
    """Each side builds the demo from its own modules; the text is equal
    (or both refuse: a filter without a recipe)."""
    texts = [to_json_or_error(side, [getattr(side.examples, name)()]) for side in SERVING_SIDES]
    assert texts[0] == texts[1]
    if texts[1].startswith("{"):
        d = json.loads(texts[1])
        assert d["version"] == 1 and len(d["scene"]) == 1
        assert '"idset"' not in texts[1] and "tensor" not in texts[1]
        # What the port reads back writes the same text again.
        assert PORT_S.checkpoint.scene_to_json(PORT_S.checkpoint.scene_from_json(texts[1])) == texts[1]


def mixed_scene(side):
    """The JAX package's checkpoint-test scene and a few more kinds: a
    gradient under PreTrans, a blur filter, a CPG, a brush stroke, a
    monochrome filter, a stroked path, a convolved group, primitives."""
    R, C, F, tr = side.R, side.C, side.filters, side.tr
    fills, gshapes = side.fills, side.gshapes
    new = side.ident.new_ids
    spec = gshapes.StrokeSpec(startcap=gshapes.ButtCap, join=gshapes.BevelJoin, endcap=gshapes.ButtCap, mitrelimit=10.0,
                              linewidth=3.5)
    return [
        R.Obj(new(), R.Basic(fills.gradient((10.0, 10.0), (80.0, 80.0), True, True, C.red, C.blue),
                             R.PathShape(gshapes.circle(40.0, 40.0, 25.0))), (tr.Translate(5.0, 0.0),), R.PreTrans(0.8, R.OVER)),
        R.Obj(new(), F.blur(R.Basic(fills.plain(C.white), R.rectangle(20, 20, 30, 30)), side.convolve.mkgaussian(2)), (), R.OVER),
        R.Obj(new(), R.Basic(fills.plain(C.green), R.CPG(R.EXCLUSIVE_OR, R.PathShape(gshapes.circle(40.0, 60.0, 15.0)),
                                                         R.PathShape(gshapes.circle(55.0, 60.0, 15.0)))), (), R.OVER),
        R.Obj(new(), F.monochrome(R.Basic(fills.plain(C.white), R.rectangle(50, 10, 30, 30))), (), R.OVER),
        R.Obj(new(), R.Basic(fills.plain(C.gold), R.BrushStroke(((0.6, ("gaussian", 5.0)), gshapes.circle(30.0, 30.0, 10.0)))),
              (), R.OVER),
        R.Obj(new(), R.Basic(fills.plain(C.dissolve(C.purple, delta=180)), R.StrokedPathShape(gshapes.circle(60.0, 50.0, 20.0), spec)),
              (tr.Rotate((48.0, 48.0), 0.3), tr.Scale((0.0, 0.0), 1.1, 0.9)), R.OVER),
        R.Obj(new(), R.Convolved(side.convolve.mkgaussian(1), R.Group((
            R.Obj(new(), R.Basic(fills.radial((30.0, 70.0), (30.0, 70.0), (45.0, 70.0), True, False, C.teal, C.white),
                                 R.rectangle(15.0, 60.0, 40.0, 25.0)), (tr.ShearX((0.0, 0.0), 0.1),), R.OVER),
        ))), (), R.OVER),
        R.primobj(C.lightgrey, R.RectanglePrim(0.0, 0.0, 100.0, 100.0)),
    ]


def render96(side, scene):
    return dense(side, side.render_simple_scene(scene, side.shape_of_box(BOX)), BOX)


def test_mixed_scene_json_text_equal():
    texts = [side.checkpoint.scene_to_json(mixed_scene(side)) for side in SERVING_SIDES]
    assert texts[0] == texts[1]
    kinds = [o["geom"]["k"] for o in json.loads(texts[1])["scene"]]
    assert kinds == ["basic", "filter", "basic", "filter", "basic", "basic", "convolved", "prim"]


@pytest.mark.parametrize("writer,reader", [(JAX_S, PORT_S), (PORT_S, JAX_S), (PORT_S, PORT_S)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_scene_crosses_packages_and_renders_the_same_pixels(writer, reader, both_sides):
    scene = mixed_scene(writer)
    text = writer.checkpoint.scene_to_json(scene)
    want = render96(JAX_S, scene if writer is JAX_S else JAX_S.checkpoint.scene_from_json(text))
    loaded = reader.checkpoint.scene_from_json(text)
    assert [type(o.geometry).__name__ for o in loaded] == [type(o.geometry).__name__ for o in scene]
    assert len({o.idset for o in loaded} | {o.idset for o in scene}) == 2 * len(scene) or writer is not reader
    reader.cache.clear()
    got = render96(reader, loaded)
    assert np.array_equal(got, want)
    assert (got[..., 3] > 0).sum() > 2000


@pytest.mark.parametrize("name", ["cpg_example", "blurfilter", "brushblue", "wireframe", "q_shape_2", "radial_filled"])
def test_jax_written_demo_renders_jax_pixels_in_the_port(name, both_sides):
    R = JAX_S.R
    demo = R.position_anchor(R.Centre, (48.0, 48.0), getattr(JAX_S.examples, name)())
    backdrop = R.position_anchor(R.Centre, (55.0, 50.0), JAX_S.examples.blueblob())
    scene = [demo, backdrop]
    text = JAX_S.checkpoint.scene_to_json(scene)
    want = render96(JAX_S, scene)
    got = render96(PORT_S, PORT_S.checkpoint.scene_from_json(text))
    assert np.array_equal(got, want)


def small_view(side):
    R, C = side.R, side.C
    return side.view(scene=[R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.purple), R.rectangle(10, 10, 30, 30)), (), R.OVER)],
                     pages=side.app.page(5.0, 5.0, 80.0, 60.0), background=[side.app.background_obj()],
                     master_update=side.shape_of_box((0, 0, 100, 100)), tool="zoom")


@pytest.mark.parametrize("writer,reader", [(JAX_S, PORT_S), (PORT_S, JAX_S), (PORT_S, PORT_S)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_view_file_crosses_packages(writer, reader, tmp_path, both_sides):
    p, pj = str(tmp_path / "view.json"), str(tmp_path / "jax.json")
    writer.checkpoint.save_view(p, small_view(writer))
    JAX_S.checkpoint.save_view(pj, small_view(JAX_S))
    assert open(p).read() == open(pj).read()
    v = reader.load_view(p)
    assert len(v.scene) == 1 and len(v.pages) == 3 and len(v.background) == 1
    assert v.master_update.box == (0, 0, 100, 100) and v.tool == "zoom" and v.selections == reader.R.null_selection
    if reader is PORT_S:
        assert str(v.device) == "cpu" and v.master_update.mask.device.type == "cpu"
    frame = reader.R.render_frame(reader.ident.new_ids(), v, reader.shape_of_box((0, 0, 100, 100)))
    jv = JAX_S.load_view(pj)
    want = JAX_S.R.render_frame(JAX_S.ident.new_ids(), jv, JAX_S.shape_of_box((0, 0, 100, 100)))
    assert same_raster(reader.np_sprite(frame), JAX_S.np_sprite(want))


def test_view_without_master_update_round_trips(tmp_path):
    for side in SERVING_SIDES:
        v = side.view(scene=[], pages=[], background=[], master_update=None)
        p = str(tmp_path / f"{side.name}.json")
        side.checkpoint.save_view(p, v)
        back = side.load_view(p)
        assert back.master_update is None and back.scene == [] and back.tool == "select"
    assert open(tmp_path / "jax.json").read() == open(tmp_path / "port.json").read()


def undo_history(side):
    """A fixed script of records, undos, redos and a selective undo; what
    each step returned and left behind, as bounds (ids differ by side)."""
    R, C = side.R, side.C
    mk = lambda x: R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.red), R.rectangle(x, 10.0, 20.0, 20.0)), (), R.OVER)
    a, b, c = mk(10.0), mk(40.0), mk(70.0)
    view = side.view(scene=[a, b, c], pages=[], background=[], master_update=None)
    um = side.undo.UndoManager(limit=3)
    log = []

    def note(what, state=None):
        scene = state.scene if state is not None else view.scene
        log.append((what, [R.bounds_of_basicshape(o) for o in scene], len(um.history), len(um.redo_list),
                    um.can_undo(), um.can_redo()))

    note("start")
    assert um.undo(view) is None and um.redo(view) is None and um.undo_selective(view) is None
    for step in range(4):  # one more than the limit keeps
        um.record(view)
        moved = R.translate_renderobject(3 * (step + 1), step, view.scene[step % 3])
        view.scene = [moved if o is view.scene[step % 3] else o for o in view.scene]
        note(f"edit {step}")
    view.selections = (R.Size, ([view.scene[0]], R.handles_size()))
    sel = um.undo_selective(view)
    log.append(("selective", [R.bounds_of_basicshape(o) for o in sel]))
    for what in ("undo", "undo", "redo", "undo", "undo", "undo"):
        state = getattr(um, what)(view)
        if state is not None:
            view.scene, view.selections = list(state.scene), state.selections
        note(what, state)
    um.record(view)
    note("record clears redo")
    return log


def test_undo_histories_equal():
    jlog, tlog = undo_history(JAX_S), undo_history(PORT_S)
    assert jlog == tlog
    assert tlog[4][2] == 3 and tlog[-1][3] == 0


@pytest.mark.parametrize("writer,reader", [(JAX_S, PORT_S), (PORT_S, JAX_S), (PORT_S, PORT_S)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_sprite_and_shape_files_cross_packages(writer, reader, tmp_path):
    circle = lambda s: s.R.Obj(s.ident.new_ids(), s.R.Basic(s.fills.plain(s.C.dissolve(s.C.green, delta=150)),
                                                            s.R.PathShape(s.gshapes.circle(20.5, 18.0, 11.0))), (), s.R.OVER)
    spr = writer.render_simple_scene([circle(writer)], writer.shape_of_box((3, 4, 40, 36)))
    want = JAX_S.np_sprite(JAX_S.render_simple_scene([circle(JAX_S)], JAX_S.shape_of_box((3, 4, 40, 36))))
    p, p2, p3 = (str(tmp_path / n) for n in ("spr.npz", "shp.npz", "null.npz"))
    writer.persist.save_sprite(p, spr)
    back = reader.load_sprite(p)
    assert same_raster(reader.np_sprite(back), want)
    writer.persist.save_shape(p2, writer.region.shape_of_sprite(spr))
    shp = reader.load_shape(p2)
    assert shp.box == want[0] and np.array_equal(reader.np_shape(shp)[1], want[1])
    writer.persist.save_sprite(p3, None)
    assert reader.load_sprite(p3) is None
    writer.persist.save_shape(p3, None)
    assert reader.load_shape(p3) is None
    with np.load(p) as d:
        assert sorted(d.files) == ["box", "mask", "rgba"] and d["rgba"].dtype == np.int32 and d["mask"].dtype == bool
        assert d["mask"].shape == (want[0][3] - want[0][1] + 1, want[0][2] - want[0][0] + 1)


def test_port_persistence_round_trip(tmp_path):
    """The JAX package's own utils test, on the port."""
    region = PORT_S.region
    spr = region.fillshape(PORT_S.shape_of_box((3, 4, 12, 13)), PORT_S.fills.plain(PORT_S.C.green))
    p = str(tmp_path / "spr.npz")
    PORT_S.persist.save_sprite(p, spr)
    back = PORT_S.load_sprite(p)
    assert back.box == spr.box and np.array_equal(back.rgba.numpy(), spr.rgba.numpy())
    assert back.rgba.device.type == "cpu"
    p2 = str(tmp_path / "shp.npz")
    PORT_S.persist.save_shape(p2, region.shape_of_sprite(spr))
    assert PORT_S.load_shape(p2).box == spr.box and PORT_S.load_shape(p2).full_box


def test_port_remote_display_end_to_end(both_sides, tmp_path):
    """The JAX package's end-to-end case on the port: Engine behind a
    RemoteDisplay, HeadlessClient over a real socket, a PNG of the client's
    window."""
    from _torch_serving import DEADLINE, in_thread, socket_pair

    side = PORT_S
    R, C = side.R, side.C
    sconn, cconn = socket_pair(side, side)
    state = {}

    def client_thread():
        c = side.client.HeadlessClient(cconn)
        state["client"] = c
        c.app_start()
        while c.running and c.handle_one():
            pass

    t, fail = in_thread(client_thread)
    eng = side.Engine(display=side.window.RemoteDisplay(sconn))
    view = side.view(scene=[R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.red), R.rectangle(20.0, 20.0, 40.0, 40.0)), (), R.OVER)],
                     pages=[], background=[side.app.background_obj()], master_update=side.shape_of_box((0, 0, 200, 200)))
    eng.views.append(view)
    assert eng.wx.poll()[0] == "AppStartup"
    view.window = eng.wx.make_window("remote", 200, 200, 0, 0, 0, 0)
    eng.render_rect(view.window, 0, 0, 200, 200)
    eng.wx.close_application()
    t.join(DEADLINE)
    assert not t.is_alive() and not fail
    win = state["client"].windows[view.window]
    assert tuple(win.image[40, 40]) == (255, 0, 0)
    assert tuple(win.image[5, 5]) == tuple(C.rgba_of_colour(C.lightgrey)[:3])
    p = str(tmp_path / "w.png")
    state["client"].save_png(view.window, p)
    assert np.array_equal(side.png.read_png(p), win.image)
    cconn.close()
    sconn.close()


def test_tkclient_helpers():
    for side in SERVING_SIDES:
        tkclient, W = side.tkclient, side.window
        img = np.zeros((2, 3, 3), np.uint8)
        img[0, 0] = (255, 0, 0)
        data = tkclient.ppm_bytes(img)
        assert data.startswith(b"P6\n3 2\n255\n") and len(data) == 11 + 18
        for sym, code in [("Escape", 27), ("Left", 314), ("a", 65), ("Z", 90)]:
            got = tkclient._keycode_of_keysym(sym)
            assert got == code
            assert W.key_of_keycode(got) in (sym.capitalize() if len(sym) > 1 else sym.upper(), sym.upper(), "Escape", "Left")
        assert tkclient._keycode_of_keysym("F13") is None


def test_port_tkclient_imports_tkinter_late():
    """Importing the module needs no tkinter; only a TkClient does."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = ("import sys; sys.path.insert(0, sys.argv[1]); import coherence_tpu_torch.gui.tkclient as t; "
            "assert 'tkinter' not in sys.modules; assert t.TkClient.POLL_MS == 20")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", prog, root], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
