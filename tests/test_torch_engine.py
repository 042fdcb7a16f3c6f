"""The port's Engine (gui/app.py) against the JAX package's: one event
script per scenario (the scenarios of the JAX package's own engine tests and
a few more of the select tool's state machine), fed to an Engine of each
side with containment off (``resilient=False`` where the loop runs; handlers
called directly elsewhere, so any exception fails the test).  After every
event the two sides are compared in their window framebuffers, the rects
shipped to the display, the status bars and sliders, the drag state and the
scene's structure (as checkpoint JSON, which holds no id).  One scenario
runs over TCP and compares the two clients' images.  Tolerance 0."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coherence_tpu.io import pdf as JP
from coherence_tpu_torch.io import pdf as TP

from _torch_general import both_sides  # noqa: F401
from _torch_serving import DEADLINE, JAX_S, PORT_S, SERVING_SIDES, ServedClient, crc, in_thread, socket_pair
from _torch_threads import one_torch_thread  # noqa: F401

SIZE = 300


def two_shape_view(side, size=SIZE):
    """The JAX package's engine-test scene: a red circle over a blue
    rectangle on the grey background."""
    R, C, W = side.R, side.C, side.window
    red = R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.red), R.PathShape(side.gshapes.circle(80.0, 80.0, 30.0))),
                (), R.OVER)
    blue = R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.blue), R.rectangle(150.0, 150.0, 60.0, 40.0)), (), R.OVER)
    return side.view(scene=[red, blue], pages=[], window=W.nullwindow, background=[side.app.background_obj()],
                     selections=R.null_selection, master_update=side.shape_of_box((0, 0, size, size)),
                     rubberband=None, tool=W.Select)


def make_engine(side, **kw):
    eng = side.Engine(**kw)
    view = two_shape_view(side)
    eng.views.append(view)
    view.window = eng.wx.make_window("test", SIZE, SIZE, 0, 0, 0, 0)
    return eng, view


def selection_summary(side, view):
    box, (objs, handles) = view.selections
    kind = box if isinstance(box, str) else ("Rotate", box.x, box.y)
    return kind, [side.R.bounds_of_basicshape(o) for o in objs], [h for h, _, _ in handles]


def observe(side, eng, view):
    """Everything a user or a client could tell the two sides apart by."""
    disp = eng.wx.display
    return {
        "fb": {w: crc(fb) for w, fb in eng.wx.framebuffers.items()},
        "refreshed": list(disp.refreshed),
        "windows": {w: (v.name, v.width, v.height, v.status, v.blur, v.trans) for w, v in disp.windows.items()},
        "dragging": eng.state.dragging[0],
        "tool": view.tool,
        "rubberband": view.rubberband,
        "scene": json.loads(side.checkpoint.scene_to_json(view.scene))["scene"],
        "bounds": [side.R.bounds_of_basicshape(o) for o in view.scene],
        "selection": selection_summary(side, view),
        "undo": (len(eng.undo.history), len(eng.undo.redo_list)),
    }


def play(side, script, **engine_kw):
    """Feed the script to a fresh Engine: ("mouse", x, y) moves the pointer,
    ("mods", command, shift, option) holds modifier keys, anything else is
    an event tuple for event_handler (through filter_event, as run() does).
    A ValueError or ZeroDivisionError of a handler is recorded with the
    observation, so that the port must raise where the JAX package does.
    Returns the observations after every event and the final framebuffers."""
    eng, view = make_engine(side, **engine_kw)
    W = side.window
    seen = []
    for step in script:
        if step[0] == "mouse":
            eng.wx.display.mouse = (step[1], step[2])
        elif step[0] == "mods":
            eng.wx.command_down, eng.wx.shift_down, eng.wx.option_down = step[1:]
        else:
            kind = getattr(W, step[0])
            raised = None
            try:
                eng.event_handler(eng.filter_event((kind, view.window, *step[1:])))
            except (ValueError, ZeroDivisionError) as e:  # a fault of the reference's own is compared, not hidden
                raised = type(e).__name__
            seen.append({**observe(side, eng, view), "raised": raised})
    return eng, view, seen


def click(x, y):
    return [("mouse", x, y), ("LEFT_DOWN", x, y), ("LEFT_UP", x, y)]


def drag(x0, y0, *points):
    out = [("mouse", x0, y0), ("LEFT_DOWN", x0, y0)]
    for x, y in points:
        out += [("mouse", x, y), ("LEFT_DRAGGING", x, y)]
    return out + [("LEFT_UP", *points[-1])]


PAINT = [("PAINT_RECT", 0, 0, SIZE, SIZE)]
CMD, NOMODS = ("mods", True, False, False), ("mods", False, False, False)

SCRIPTS = {
    "paint and pick-select": PAINT + click(80, 80),
    "drag moves an object": PAINT + drag(80, 80, (100, 90)),
    "drag in three steps": PAINT + drag(80, 80, (85, 83), (90, 86), (95, 89)),
    "rubberband selects several": PAINT + drag(20, 20, (250, 250)),
    "rubberband over nothing": PAINT + click(80, 80) + drag(240, 20, (280, 60)),
    "click on nothing deselects": PAINT + click(80, 80) + click(280, 20),
    "zoom doubles": PAINT + [("BUTTON_CLICKED", 2)] + click(150, 150),
    "zoom to a rectangle and back out": PAINT + [("BUTTON_CLICKED", 2)] + drag(40, 40, (100, 90), (160, 140))
    + [("mouse", 150, 150), ("RIGHT_DOWN", 150, 150), ("RIGHT_UP", 150, 150), ("BUTTON_CLICKED", 1)],
    "zoom rubberband cancelled": PAINT + [("BUTTON_CLICKED", 2), ("mouse", 40, 40), ("LEFT_DOWN", 40, 40),
                                          ("mouse", 90, 90), ("LEFT_DRAGGING", 90, 90), ("KEY_DOWN", "Escape")],
    "undo restores, redo repeats": PAINT + drag(80, 80, (120, 120)) + [CMD, ("KEY_UP", "Z"), ("KEY_UP", "Y"),
                                                                     ("KEY_UP", "Z"), NOMODS],
    "nudge and escape": PAINT + click(80, 80) + [("KEY_DOWN", "Right"), ("KEY_DOWN", "Down"), ("KEY_DOWN", "Left"),
                                                  ("KEY_DOWN", "Up"), ("KEY_DOWN", "Up"), ("KEY_DOWN", "Escape")],
    "to bottom and to top": PAINT + click(80, 80) + [("BUTTON_CLICKED", 4), ("BUTTON_CLICKED", 3), CMD, ("KEY_UP", "B"),
                                                      ("KEY_UP", "F"), NOMODS],
    "blur slider": PAINT + click(80, 80) + [("BLUR_SLIDER", 2), ("BLUR_SLIDER", 3), ("BLUR_SLIDER", 0)],
    "transparency slider": PAINT + click(170, 160) + [("TRANS_SLIDER", 128), ("TRANS_SLIDER", 40), ("TRANS_SLIDER", 255)],
    "blur, fade, then undo both": PAINT + click(80, 80) + [("BLUR_SLIDER", 2), ("TRANS_SLIDER", 100), CMD, ("KEY_UP", "Z"),
                                                            ("KEY_UP", "Z"), NOMODS],
    "select all and drag both": PAINT + [CMD, ("KEY_UP", "A"), NOMODS] + drag(170, 160, (180, 150)),
    "right click adds and removes": PAINT + click(80, 80) + [("mouse", 170, 160), ("RIGHT_DOWN", 170, 160), ("RIGHT_UP", 170, 160),
                                                              ("mouse", 80, 80), ("RIGHT_DOWN", 80, 80), ("RIGHT_UP", 80, 80)],
    "second click turns the handles": PAINT + click(80, 80) + click(80, 80) + click(80, 80),
    "size handle scales": PAINT + click(170, 160) + drag(218, 198, (240, 215), (250, 225)),
    "escape abandons a drag": PAINT + [("mouse", 80, 80), ("LEFT_DOWN", 80, 80), ("mouse", 120, 100), ("LEFT_DRAGGING", 120, 100),
                                       ("KEY_DOWN", "Escape"), ("LEFT_UP", 120, 100)],
    "a drag event at the press point is dropped": PAINT + [("mouse", 80, 80), ("LEFT_DOWN", 80, 80), ("LEFT_DRAGGING", 80, 80),
                                                           ("mouse", 90, 85), ("LEFT_DRAGGING", 90, 85), ("LEFT_UP", 90, 85)],
    "partial paints": [("PAINT_RECT", 50, 50, 100, 100), ("PAINT_RECT", 250, 250, 200, 200), ("PAINT_RECT", 0, 0, 2, 2)],
}


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        for k in x:
            if x[k] != y[k]:
                return f"after event {i}: {k}: jax {x[k]!r}, port {y[k]!r}"
    return None


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_engine_scenario_matches_jax(name, both_sides):
    runs = [play(side, SCRIPTS[name]) for side in SERVING_SIDES]
    (jeng, jview, jseen), (teng, tview, tseen) = runs
    assert len(jseen) == len(tseen) > 0
    assert first_difference(jseen, tseen) is None
    for w in jeng.wx.framebuffers:
        assert np.array_equal(jeng.wx.framebuffers[w], teng.wx.framebuffers[w])
    check = CHECKS.get(name)
    if check is not None:
        check(PORT_S, teng, tview, tseen)


def _check_pick(side, eng, view, seen):
    fb = eng.wx.framebuffers[view.window]
    assert tuple(fb[80, 80]) == (255, 0, 0) and tuple(fb[170, 160]) == (0, 0, 255)
    assert side.R.is_selected(view.selections, view.scene[0]) and eng.state.dragging == side.app.DragNone
    assert seen[-1]["windows"][view.window][3] == side.messages.objsel


def _check_drag(side, eng, view, seen):
    xmin, xmax, ymin, ymax = side.R.bounds_of_basicshape(view.scene[0])
    assert abs((xmin + xmax) / 2 - 100) <= 2 and abs((ymin + ymax) / 2 - 90) <= 2
    assert tuple(eng.wx.framebuffers[view.window][90, 100]) == (255, 0, 0)


def _check_rubberband(side, eng, view, seen):
    assert seen[1]["dragging"] == "rubberband"
    assert all(side.R.is_selected(view.selections, o) for o in view.scene)


def _check_zoom(side, eng, view, seen):
    xmin, xmax, _, _ = side.R.bounds_of_basicshape(view.scene[0])
    assert view.tool == side.window.Zoom and 110 <= xmax - xmin <= 130


def _check_undo(side, eng, view, seen):
    assert seen[3]["bounds"] != seen[0]["bounds"]
    assert seen[4]["bounds"] == seen[0]["bounds"] and seen[5]["bounds"] == seen[3]["bounds"]
    assert seen[6]["bounds"] == seen[0]["bounds"]


def _check_nudge(side, eng, view, seen):
    assert seen[3]["bounds"][0][0] == seen[2]["bounds"][0][0] + 1
    assert view.selections == side.R.null_selection


def _check_order(side, eng, view, seen):
    colours = [[o["geom"]["fill"]["colour"] for o in s["scene"]] for s in seen]
    assert colours[3] == colours[5] == colours[0][::-1] and colours[4] == colours[6] == colours[0]


def _check_blur(side, eng, view, seen):
    assert seen[3]["scene"][0]["geom"]["k"] == "convolved" and seen[3]["windows"][view.window][4] == 0
    assert seen[-1]["scene"][0]["geom"]["k"] == "basic"


def _check_trans(side, eng, view, seen):
    assert seen[3]["scene"][1]["compop"] == {"k": "pretrans", "v": 128 / 255.0, "op": "over"}
    assert tuple(eng.wx.framebuffers[view.window][170, 160]) == (0, 0, 255)
    assert seen[3]["fb"] != seen[2]["fb"]


def _check_turn(side, eng, view, seen):
    kinds = [s["selection"][0] if isinstance(s["selection"][0], str) else s["selection"][0][0] for s in seen[2::2]]
    assert kinds[:2] == ["Size", "Rotate"]
    assert len(seen[4]["selection"][2]) == 9  # eight handles and the rotation centre


def _check_scale(side, eng, view, seen):
    b0, b1 = seen[2]["bounds"][1], seen[-1]["bounds"][1]
    assert seen[3]["dragging"] == "handle"
    assert b1[1] - b1[0] > b0[1] - b0[0] and b1[3] - b1[2] > b0[3] - b0[2]


def _check_escape(side, eng, view, seen):
    assert seen[2]["bounds"] != seen[0]["bounds"] and seen[3]["bounds"] == seen[0]["bounds"]


CHECKS = {
    "paint and pick-select": _check_pick,
    "drag moves an object": _check_drag,
    "rubberband selects several": _check_rubberband,
    "zoom doubles": _check_zoom,
    "undo restores, redo repeats": _check_undo,
    "nudge and escape": _check_nudge,
    "to bottom and to top": _check_order,
    "blur slider": _check_blur,
    "transparency slider": _check_trans,
    "second click turns the handles": _check_turn,
    "size handle scales": _check_scale,
    "escape abandons a drag": _check_escape,
}


def test_frag_debug_window_mirrors_fragments(both_sides):
    got = []
    for side in SERVING_SIDES:
        R, C = side.R, side.C
        eng = side.Engine(frag_debug=True)
        eng.frag_window = eng.wx.make_window("Sprite Debug window", 600, 740, 0, 0, 0, 0)
        view = side.view(scene=[R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.red), R.rectangle(20.0, 20.0, 30.0, 30.0)),
                                      (), R.OVER)],
                         pages=[], background=[side.app.background_obj()], master_update=side.shape_of_box((0, 0, 200, 200)))
        eng.views.append(view)
        view.window = eng.wx.make_window("main", 200, 200, 0, 0, 0, 0)
        eng.force_update(True, side.ident.new_ids(), view, side.shape_of_box((0, 0, 200, 200)))
        eng.force_update(True, side.ident.new_ids(), view, side.shape_of_box((10, 10, 60, 40)))
        assert tuple(eng.wx.framebuffers[eng.frag_window][30, 30]) == (255, 0, 0)
        assert eng.old_debug_coords.box == (10, 10, 60, 40)
        got.append((eng.wx.framebuffers[eng.frag_window], eng.wx.framebuffers[view.window], list(eng.wx.display.refreshed)))
    assert np.array_equal(got[0][0], got[1][0]) and np.array_equal(got[0][1], got[1][1])
    assert got[0][2] == got[1][2]


def test_startup_event_opens_the_demo_window(both_sides):
    """AppStartup with both debug options: the cache window, the fragment
    window with its status text, then the "Minimal Rendering" demo."""
    got = []
    for side in SERVING_SIDES:
        R = side.R
        eng = side.Engine(cache_debug=True, frag_debug=True)
        eng.startup(with_icons=False)
        assert eng.wx.poll() == (side.window.APP_STARTUP,)
        eng.event_handler((side.window.APP_STARTUP,))
        view = eng.views[0]
        scene = view.scene
        assert len(scene) == 13 and view.master_update.box == (0, 0, 650, 730)
        for i in (0, 2, 4):
            border, obj = scene[i], scene[i + 1]
            spec = border.geometry.shape.spec
            assert isinstance(border.geometry.shape, R.StrokedPathShape)
            assert spec.linewidth == 1.0 and spec.join == side.gshapes.MitredJoin
            assert border.transform == obj.transform
            assert border.geometry.shape.path is obj.geometry.filter.geometry.shape.path
        windows = {w: (v.name, v.width, v.height, v.status) for w, v in eng.wx.display.windows.items()}
        got.append((windows, [R.bounds_of_basicshape(o) for o in scene], [type(o.geometry).__name__ for o in scene],
                    json.loads(side.checkpoint.scene_to_json(view.pages + view.background))))
    assert got[0] == got[1]
    assert [v[0] for v in got[1][0].values()] == ["Sprite Debug window", "Minimal Rendering"]


def test_opendemos_filter_borders_paint_alike(both_sides):
    """The strip of the demo window that holds the three filter objects and
    their 1-px borders, painted through the PaintRect path."""
    fbs = []
    for side in SERVING_SIDES:
        eng = side.Engine()
        eng.opendemos()
        view = eng.views[0]
        view.scene = view.scene[:6]  # the borders and their filters
        eng.event_handler((side.window.PAINT_RECT, view.window, 60, 480, 480, 140))
        fbs.append(eng.wx.framebuffers[view.window])
        ring = side.render_simple_scene([view.scene[0]], side.shape_of_box(side.R.bounds_of_basicshape(view.scene[0])[::2]
                                                                            + side.R.bounds_of_basicshape(view.scene[0])[1::2]))
        assert ring is not None
    assert np.array_equal(fbs[0], fbs[1])
    assert (fbs[1][480:620, 60:540] != 0).any()


def test_toolbar_icons_reach_the_display_alike(both_sides):
    got = []
    for side in SERVING_SIDES:
        eng = side.Engine()
        shipped = []
        eng.wx.display.startup = lambda icons: shipped.extend(
            (side.window.rgb_bytes_of_canvas(c), side.window.alpha_bytes_of_canvas(c)) for c in icons)
        was = side.cache.usecache
        eng.startup()
        assert side.cache.usecache == was
        got.append(shipped)
    assert got[0] == got[1] and len(got[1]) == 4


def test_open_file_and_page_keys(both_sides):
    import os

    got = []
    for side in SERVING_SIDES:
        W = side.window
        eng = side.Engine()
        name = os.path.join(side.examples.path, "zoom.pdf")
        eng.event_handler((W.OPEN_FILE, name))
        view = eng.views[0]
        eng.event_handler((W.PAINT_RECT, view.window, 80, 80, 160, 160))
        eng.event_handler((W.KEY_DOWN, view.window, W.PageDown))  # one page: stays
        eng.event_handler((W.KEY_DOWN, view.window, W.PageUp))
        assert eng.docs[view.window] == [name, 0, 1]
        got.append((eng.wx.framebuffers[view.window], [side.R.bounds_of_basicshape(o) for o in view.scene],
                    json.loads(side.checkpoint.scene_to_json(view.scene + view.pages)), eng.wx.display.windows[view.window].name))
    assert np.array_equal(got[0][0], got[1][0]) and got[0][1:] == got[1][1:]
    assert got[1][3] == "zoom.pdf"


def test_closing_windows_ends_the_loop(both_sides):
    for side in SERVING_SIDES:
        W = side.window
        eng, view = make_engine(side)
        second = two_shape_view(side)
        eng.views.append(second)
        second.window = eng.wx.make_window("second", 100, 100, 0, 0, 0, 0)
        eng.wx.display.post(W.WINDOW_CLOSED, view.window)
        eng.wx.display.post(W.PAINT_RECT, second.window, 0, 0, 50, 50)
        eng.wx.display.post(W.APP_CLOSE)
        eng.wx.display.post(W.PAINT_RECT, second.window, 0, 0, 50, 50)  # never reached
        eng.run(max_events=10, resilient=False)
        assert eng.views == [] and len(eng.wx.display.events) == 1
        with pytest.raises(KeyError):
            eng.pickview(view.window)


def pdf_pages_files(side, tmp_path):
    """chip_smoke.py's three-page document (every graphics construct on
    page 1, images on page 2, text on page 3) at 480x270, written by the
    side's own writer plain and sealed with AES (modern xref, an owner
    password; the random bytes from a seed): (paths, the files' bytes).
    The seal is AES-128 (R4): chip_smoke.py seals with AES-256 (R6), whose
    pure-Python key derivation takes seconds at every open, and
    tests/test_torch_pdf_writer.py holds R6's bytes."""
    import random

    import chip_smoke

    P = {"jax": JP, "port": TP}[side.name]
    pdf = P.Pdf(*chip_smoke.pdf_document(P, 480, 270, image_wh=(64, 48)))
    rng = random.Random(6)
    files = (P.pdf_to_bytes(pdf),
             P.pdf_to_bytes(pdf, modern=True, encrypt={"revision": 4, "user_pw": b"", "owner_pw": b"pdf-pages",
                                                      "rand": lambda n: bytes(rng.randrange(256) for _ in range(n))}))
    paths = []
    for name, data in zip(("pages", "pages_aes"), files):
        paths.append(str(tmp_path / f"{side.name}_{name}.pdf"))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths, files


def test_open_pdf_pages_and_turn_the_page(both_sides, tmp_path):
    """Shadings, patterns, soft masks, groups, blend modes, an annotation,
    images and text through Engine.openfile and goto_page on both sides,
    from each side's own file, plain and encrypted (the files equal): the
    framebuffers of pages 1-3 after each PageDown, the rects shipped and
    the status bar are equal, and the encrypted file shows the plain
    file's pages."""
    got, written = [], []
    for side in SERVING_SIDES:
        paths, files = pdf_pages_files(side, tmp_path)
        written.append(files)
        W = side.window
        shown = []
        for path in paths:
            side.cache.clear()
            eng = side.Engine()
            eng.event_handler((W.OPEN_FILE, path))
            view = eng.views[0]
            eng.event_handler((W.PAINT_RECT, view.window, 0, 0, 600, 400))
            pages = [eng.wx.framebuffers[view.window].copy()]
            for _ in range(2):
                eng.event_handler((W.KEY_DOWN, view.window, W.PageDown))
                pages.append(eng.wx.framebuffers[view.window].copy())
            shown.append((pages, eng.docs[view.window][1:], list(eng.wx.display.refreshed),
                          eng.wx.display.windows[view.window].status))
        got.append(shown)
    assert written[0] == written[1]
    (a_plain, a_sealed), (b_plain, b_sealed) = got
    for a, b in ((a_plain, b_plain), (a_sealed, b_sealed)):
        assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0])) and a[1:] == b[1:]
    assert all(np.array_equal(x, y) for x, y in zip(b_sealed[0], b_plain[0]))
    b1, b2, b3 = b_plain[0]
    assert b_plain[1] == [2, 3] and not np.array_equal(b1, b2) and not np.array_equal(b3, b1)
    assert not np.array_equal(b3, b2)
    assert len(np.unique(b1[100:370, 100:580].reshape(-1, 3), axis=0)) > 100


def test_port_loop_contains_errors_but_never_a_missing_branch():
    """The resilient loop drops an event whose handler raised, as the JAX
    package's does; a NotImplementedError names a branch the port lacks and
    is raised even then."""
    W = PORT_S.window
    eng, view = make_engine(PORT_S)
    eng.state.dragging = ("object", 0, 0, [], None)
    eng.wx.display.post(W.PAINT_RECT, 99, 0, 0, 10, 10)  # no such window: KeyError
    before = PORT_S.profiling.counters["engine.event_errors"]
    eng.run(max_events=1)
    assert PORT_S.profiling.counters["engine.event_errors"] == before + 1
    assert eng.state.dragging == PORT_S.app.DragNone
    eng.wx.display.post(W.PAINT_RECT, 99, 0, 0, 10, 10)
    with pytest.raises(KeyError):
        eng.run(max_events=1, resilient=False)

    def missing(*a):
        raise NotImplementedError("not ported")

    eng.render_rect = missing
    eng.wx.display.post(W.PAINT_RECT, view.window, 0, 0, 10, 10)
    with pytest.raises(NotImplementedError):
        eng.run(max_events=1, resilient=True)


def test_port_engine_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        assert PORT_S.app.Engine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PORT_S.app.Engine()
    eng = PORT_S.app.Engine(device="cpu")
    assert eng.device == torch.device("cpu") and eng.master_update.mask.device.type == "cpu"


@pytest.mark.parametrize("seed", range(3))
def test_scene_changes_matches_jax(seed, both_sides):
    """Scene diffing between two seeded edits of the same scene: removal,
    reordering, a moved object, a filter above the change."""
    got = []
    for side in SERVING_SIDES:
        R, C = side.R, side.C
        rng = np.random.default_rng(seed)
        objs = [R.Obj(side.ident.new_ids(), R.Basic(side.fills.plain(C.dissolve(C.red, delta=int(rng.integers(60, 256)))),
                                                    R.PathShape(side.gshapes.circle(float(rng.integers(30, 170)),
                                                                                    float(rng.integers(30, 170)),
                                                                                    float(rng.integers(8, 30))))), (), R.OVER)
                for _ in range(5)]
        lens = R.Obj(side.ident.new_ids(), side.filters.blur(R.Basic(side.fills.plain(C.white), R.rectangle(60.0, 60.0, 80.0, 80.0)),
                                                              side.convolve.mkgaussian(2)), (), R.OVER)
        s = [lens] + objs
        k = int(rng.integers(1, 5))
        moved = R.translate_renderobject(int(rng.integers(-9, 10)), 4, objs[k])
        s2 = [lens] + [moved if o is objs[k] else o for o in objs if o is not objs[(k + 1) % 5]]
        s2[1], s2[2] = s2[2], s2[1]
        faded = side.app.trans_renderobject(90, s2[3])
        s2[3] = faded
        args = () if side is JAX_S else ("cpu",)
        got.append([side.np_shape(side.app.scene_changes(s, s2, *args)), side.np_shape(side.app.scene_changes(s, s, *args))])
    assert got[0][1] is None and got[1][1] is None
    a, b = got[0][0], got[1][0]
    assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_object_modifiers_match_jax():
    for fn in ("blur", "unblur", "trans"):
        out = []
        for side in SERVING_SIDES:
            A, R, C = side.app, side.R, side.C
            basic = R.Basic(side.fills.plain(C.teal), R.rectangle(1.0, 2.0, 30.0, 40.0))
            plain = R.Obj(side.ident.new_ids(), basic, (side.tr.Translate(3.0, 4.0),), R.OVER)
            lens = R.Obj(side.ident.new_ids(), side.filters.monochrome(basic), (), R.OVER)
            blurred, blurred_lens = A.blur_renderobject(3, plain), A.blur_renderobject(3, lens)
            if fn == "blur":
                res = [blurred, blurred_lens, A.blur_renderobject(2, blurred), A.blur_renderobject(2, blurred_lens)]
            elif fn == "unblur":
                res = [A.unconvolve_renderobject(o) for o in (blurred, blurred_lens, plain, lens)]
            else:
                res = [A.trans_renderobject(77, o) for o in (plain, lens, blurred_lens)]
                assert res[0].idset == plain.idset and res[1].idset == lens.idset
            out.append([(type(o.geometry).__name__,
                         type(o.geometry.filter.geometry).__name__ if isinstance(o.geometry, R.FilterG) else None,
                         len(o.transform), repr(o.compop)) for o in res]
                       + [json.loads(side.checkpoint.scene_to_json([o for o in res if not isinstance(o.geometry, R.FilterG)]))])
        assert out[0] == out[1], fn


def engine_server(side, conn, ready):
    eng = side.Engine(display=side.window.RemoteDisplay(conn))
    view = two_shape_view(side)
    eng.views.append(view)
    assert eng.wx.poll()[0] == side.window.APP_STARTUP
    view.window = eng.wx.make_window("session", SIZE, SIZE, 0, 0, 0, 0)
    eng.force_update_whole(view)
    ready["engine"], ready["view"] = eng, view
    eng.run(resilient=False)


def served_session(side):
    """The benchmark session's topology at 300 x 300: the Engine in a thread
    behind a RemoteDisplay, a HeadlessClient on a real socket, and every
    event sent by the client.  Returns the client's images after each stage
    and the engine's framebuffer."""
    sconn, cconn = socket_pair(side, side)
    ready = {}
    t, fail = in_thread(engine_server, side, sconn, ready)
    sc = ServedClient(side, cconn)
    c = sc.c
    images = []

    def snap():
        assert not fail, fail
        images.append(c.windows[win].image.copy())

    c.app_start()
    sc.await_refresh()
    sc.drain()
    win = next(iter(c.windows))
    snap()
    c.mouse = (80, 80)
    c.send_event("LeftDown", win, 80, 80)
    sc.barrier(win)
    snap()
    x, y = 80, 80
    for _ in range(3):
        x, y = x + 5, y + 3
        c.mouse = (x, y)
        c.send_event("LeftDragging", win, x, y)
        sc.await_refresh()
        sc.drain()
        snap()
    c.send_event("LeftUp", win, x, y)
    sc.barrier(win)
    c.send_event("BlurSlider", win, 2)
    sc.await_refresh()
    sc.barrier(win)
    snap()
    c.send_event("Button", 2, win)
    c.mouse = (150, 150)
    c.send_event("RightDown", win, 150, 150)
    c.send_event("RightUp", win, 150, 150)
    sc.await_refresh()
    sc.barrier(win)
    snap()
    fb = ready["engine"].wx.framebuffers[ready["view"].window].copy()
    status = c.windows[win].status
    sc.finish()
    t.join(DEADLINE)
    assert not fail and not t.is_alive()
    cconn.close()
    return images, fb, status


def test_engine_over_tcp_gives_the_jax_clients_pixels(both_sides):
    (jimages, jfb, jstatus), (timages, tfb, tstatus) = [served_session(side) for side in SERVING_SIDES]
    assert len(jimages) == len(timages) == 7
    for i, (a, b) in enumerate(zip(jimages, timages)):
        assert np.array_equal(a, b), f"client images differ at stage {i}"
    assert np.array_equal(timages[-1], tfb[:SIZE, :SIZE]) and np.array_equal(jfb, tfb)
    assert any(not np.array_equal(timages[i], timages[i + 1]) for i in range(1, 6))
    assert jstatus == tstatus
