"""The interactive engine (parity: reference ``engine.ml``).

Views, tools (select/zoom), the drag state machine
(object / handle / rotation-crosshair / rubberband), keyboard handling,
blur/opacity sliders, PDF open, demo windows, and the event loop — driving
the coherent renderer with per-change dirty regions so each interaction
repaints only what changed (engine.ml:224-252 force_update).

The PyTorch counterpart of ``coherence_tpu.gui.app``.  An Engine renders on
one device, the card unless the caller names the CPU, and raises if that
device is not there; every ``View`` it makes carries that device.  The
event loop is the reference's, without the host-compute placement wrapper
(its only reason was a remote accelerator), and it never contains a
``NotImplementedError``: a branch that the port has not ported must not
vanish in the resilient loop.

The coherence cache, ``render.underanyfilter``, ``cache.usecache`` and the
blend operators are module state: one Engine per process and device at a
time, and ``cache.clear()`` between Engines on different devices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch

from .. import colour as C
from .. import ident
from .. import transform as tr
from ..geometry import path as gpath
from ..geometry import shapes as gshapes
from ..raster import convolve as rconvolve
from ..raster import fills as rfills
from ..raster import region
from ..raster.region import NULL_SHAPE, box_intersect, shape_intersection as s_int, shape_union as s_uni
from ..scene import cache
from ..scene import examples as E
from ..scene import icons as icons_mod
from ..scene import pdfscene
from ..scene import render as R
from ..scene.undo import UndoManager
from ..utils import profiling
from . import messages as Messages
from . import window as W


# --- object modifiers (engine.ml:28-75) --------------------------------------


def convolve_renderobject(k, o: R.Obj) -> R.Obj:
    g = o.geometry
    if isinstance(g, R.Convolved):
        return convolve_renderobject(k, R.Obj(ident.new_ids(), g.geometry, o.transform, o.compop))
    if isinstance(g, R.FilterG):
        f = g.filter
        inner = f.geometry.geometry if isinstance(f.geometry, R.Convolved) else f.geometry
        nf = R.Filter(R.Convolved(k, inner), f.reading_scene, f.filter, f.dirty, f.filterkind)
        return R.Obj(ident.new_ids(), R.FilterG(nf), o.transform, o.compop)
    return R.Obj(ident.new_ids(), R.Convolved(k, g), o.transform, o.compop)


def blur_renderobject(r: int, o: R.Obj) -> R.Obj:
    return convolve_renderobject(rconvolve.mkgaussian(r), o)


def unconvolve_renderobject(o: R.Obj) -> R.Obj:
    g = o.geometry
    if isinstance(g, R.Convolved):
        return R.Obj(ident.new_ids(), g.geometry, o.transform, o.compop)
    if isinstance(g, R.FilterG) and isinstance(g.filter.geometry, R.Convolved):
        f = g.filter
        nf = R.Filter(f.geometry.geometry, f.reading_scene, f.filter, f.dirty, f.filterkind)
        return R.Obj(ident.new_ids(), R.FilterG(nf), o.transform, o.compop)
    return o


def trans_renderobject(v: int, o: R.Obj) -> R.Obj:
    """Change global transparency (engine.ml:57-70)."""
    g = o.geometry
    if isinstance(g, R.FilterG):
        f = g.filter
        if isinstance(f.geometry, R.Basic):
            ng = R.Basic(rfills.plain(C.dissolve(C.white, delta=v)), f.geometry.shape)
            nf = R.Filter(ng, f.reading_scene, f.filter, f.dirty, f.filterkind)
            return R.Obj(o.idset, R.FilterG(nf), o.transform, o.compop)
        return o
    return R.Obj(o.idset, g, o.transform, R.PreTrans(v / 255.0, R.OVER))


# --- canvas furniture (engine.ml:77-99) ---------------------------------------


def background_obj():
    return R.primobj(C.lightgrey, R.RectanglePrim(0.0, 0.0, 1280.0, 1024.0))


def page(x, y, w, h):
    """A white page with border and soft drop shadow (engine.ml:81-93)."""
    r, b = x + w, y + h
    shadow = blur_renderobject(
        4,
        R.Obj(
            ident.new_ids(),
            R.Basic(
                rfills.plain(C.dissolve_between(a=C.black, b=C.white, alpha=120)),
                R.rectangle(x + 6.0, y + 6.0, w, h),
            ),
            (),
            R.OVER,
        ),
    )
    return [
        R.primobj(C.white, R.RectanglePrim(x, y, x + w, y + h)),
        R.primobj(
            C.dissolve_between(a=C.black, b=C.white, alpha=200),
            R.RectanglePrim(x - 1.0, y - 1.0, r + 1.0, b + 1.0),
        ),
        shadow,
    ]


# --- drag state (engine.ml:176-201) -------------------------------------------

DragNone = ("none",)


@dataclass
class StateFlags:
    previous_event: Optional[tuple] = None
    previous_mouse_event: Optional[tuple] = None
    dragging: tuple = DragNone
    outlines: bool = False
    justpicked: bool = False


class AppExit(Exception):
    pass


class Engine:
    """The application: views + event handling (engine.ml main), rendering
    on `device`."""

    def __init__(self, display=None, device="cuda", cache_debug: bool = False, frag_debug: bool = False):
        self.device = W.serving_device(device)
        self.wx = W.WindowSystem(display)
        self.views: List[R.View] = []
        self.state = StateFlags()
        self.captured = False
        self.cache_debug = cache_debug
        # Sprite-fragment debug window (engine.ml:9,117-125,238-251): mirrors
        # every redrawn fragment so minimal rendering is visible.
        self.frag_debug = frag_debug
        self.frag_window = None
        self.old_debug_coords = None
        self.undo = UndoManager()
        self.docs: dict = {}  # window -> [path, page_index, npages]
        self.master_update = region.shape_of_box((0, 0, 400, 400), self.device)
        self.mouse = (0, 0)
        cache.usecache = True
        cache.setsize(100 * 1024 * 1024)  # engine.ml:1611

    # --- startup -----------------------------------------------------------

    def startup(self, with_icons: bool = True):
        """Render toolbar icons and start the display (engine.ml:145-174)."""
        import os

        icons = []
        if with_icons:
            was = cache.usecache
            cache.usecache = False
            try:
                for f in ("pointer.pdf", "zoom.pdf", "up.pdf", "down.pdf"):
                    icons.append(icons_mod.icon_of_pdf(os.path.join(E.path, f), self.device))
            finally:
                cache.usecache = was
        self.wx.startup(icons)

    # --- view plumbing (engine.ml:101-142) -----------------------------------

    def pickview(self, window) -> R.View:
        for v in self.views:
            if v.window == window:
                return v
        raise KeyError(f"pickview: window {window} didn't exist")

    def remove_view(self, window):
        self.views = [v for v in self.views if v.window != window]

    # --- rendering entry points (engine.ml:208-252) ---------------------------

    def render_rect(self, win, x, y, w, h):
        # engine.ml:211-212 clips to the fixed 1280x1024 canvas; our
        # framebuffers scale with the window, so clip to the actual extent.
        cw, ch = self.wx.canvas_size(win)
        clip = box_intersect((0, 0, cw - 1, ch - 1), (x, y, x + w - 1, y + h - 1))
        if clip is None:
            return
        x0, y0, x1, y1 = clip
        view = self.pickview(win)
        sprite = R.render_frame(
            ident.new_ids(), view, region.shape_of_box((x0, y0, x1, y1), self.device)
        )
        self.wx.plot_sprite(win, 0, 0, sprite)
        self.wx.refresh_window(win, (x0, y0, x1, y1))

    def force_update(self, selections, lmo, view: R.View, shape):
        w, h = self.wx.get_window_size(view.window)
        dx, dy = self.wx.get_window_scroll(view.window)
        shape = s_int(shape, region.shape_of_box((dx, dy, dx + w - 1, dy + h - 1), self.device))
        shape = s_int(shape, view.master_update)
        rendered = R.render_frame(lmo, view, shape, display_selection=selections)
        if rendered is None:
            return
        x0, y0, x1, y1 = rendered.box
        self.wx.plot_sprite(view.window, 0, 0, rendered)
        self.wx.refresh_window(view.window, (x0, y0, x1, y1))
        if self.frag_debug and self.frag_window is not None:
            # Mirror exactly the redrawn fragments (engine.ml:238-251): clear
            # the previous fragment area to light grey, plot the new one.
            new_coords = region.shape_of_sprite(rendered)
            total = region.shape_union(self.old_debug_coords, new_coords)
            if self.old_debug_coords is not None:
                self.wx.plot_shape(
                    self.frag_window, 0, 0, C.lightgrey, self.old_debug_coords
                )
            self.wx.plot_sprite(self.frag_window, 0, 0, rendered)
            if total is not None:
                tx0, ty0, tx1, ty1 = total.box
                self.wx.refresh_window(self.frag_window, (tx0, ty0, tx1, ty1))
            self.old_debug_coords = new_coords

    def force_update_whole(self, view: R.View):
        w, h = self.wx.get_window_size(view.window)
        dx, dy = self.wx.get_window_scroll(view.window)
        self.force_update(
            True, ident.new_ids(), view, region.shape_of_box((dx, dy, dx + w - 1, dy + h - 1), self.device)
        )

    def update_rect(self, selections, lmo, view, x0, y0, x1, y1):
        xmin, xmax = min(x0, x1), max(x0, x1)
        ymin, ymax = min(y0, y1), max(y0, y1)
        self.force_update(
            selections, lmo, view, region.shape_of_box((xmin, ymin, xmax, ymax), self.device)
        )

    def update_rubberband(self, r2, view: R.View):
        old = view.rubberband
        if old is None and r2 is None:
            return
        if old is None or r2 is None:
            rect = old if r2 is None else r2
            view.rubberband = r2
            self.update_rect(True, ident.new_ids(), view, *rect)
            return
        x0, y0, x1, y1 = old
        a = (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
        x0, y0, x1, y1 = r2
        b = (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
        u = (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))
        view.rubberband = r2
        self.update_rect(True, ident.new_ids(), view, u[0], u[1], u[2], u[3])

    # --- sliders (engine.ml:285-335) ------------------------------------------

    def _selected(self, view):
        return [o for o in view.scene if R.is_selected(view.selections, o)]

    def update_blurslider_selection(self, view: R.View):
        levels = []
        for o in self._selected(view):
            g = o.geometry
            if isinstance(g, R.Convolved):
                levels.append(rconvolve.radius_of_kernel(g.kernel))
            elif isinstance(g, R.FilterG) and isinstance(g.filter.geometry, R.Convolved):
                levels.append(rconvolve.radius_of_kernel(g.filter.geometry.kernel))
            else:
                levels.append(None)
        vals = [l for l in levels if l is not None]
        level = vals[0] if vals and all(v == vals[0] for v in vals) and len(vals) == len(levels) else 0
        self.wx.set_blurslider(view.window, level)

    def update_transslider_selection(self, view: R.View):
        levels = []
        for o in self._selected(view):
            g = o.geometry
            if isinstance(g, R.FilterG) and isinstance(g.filter.geometry, R.Basic):
                levels.append(C.alpha_of_colour(g.filter.geometry.fill.single(0, 0)))
            elif isinstance(o.compop, R.PreTrans):
                levels.append(int(o.compop.v * 255.0))
            else:
                levels.append(255)
        level = levels[0] if levels and all(v == levels[0] for v in levels) else 255
        self.wx.set_transslider(view.window, level)

    # --- selection machinery (engine.ml:338-493) --------------------------------

    def change_selection(self, view: R.View, selections2, noupdate=False):
        drawn = R.drawable_of_selection(view.selections)
        drawn2 = R.drawable_of_selection(selections2)
        total = NULL_SHAPE
        for o in drawn + drawn2:
            total = s_uni(total, R.shapeonly_of_basicshape(o, self.device))
        view.selections = selections2
        if not noupdate:
            self.update_blurslider_selection(view)
            self.update_transslider_selection(view)
            self.force_update(
                True, ident.new_ids(), view, s_int(total, view.master_update)
            ) if total is not None else None

    def redraw_selections(self, view):
        self.change_selection(view, view.selections)

    def select_all(self, view: R.View):
        self.change_selection(view, (R.Size, (list(view.scene), R.handles_size())))

    def view_map_selected_objects(
        self, f, first, last, view: R.View, originalscene=None, originalselections=None,
        filtersfancy=False,
    ):
        """Apply f to every selected object, updating exactly the dirty
        regions (engine.ml:441-493)."""
        osel = originalselections if originalselections is not None else view.selections
        oscene = originalscene if originalscene is not None else view.scene
        sel_now = [o for o in view.scene if R.is_selected(view.selections, o)]
        sel_orig = [o for o in oscene if R.is_selected(osel, o)]
        if len(sel_now) != len(sel_orig):
            sel_orig = sel_now
        mapped = [f(o) for o in sel_orig]
        replace = {o.idset: m for o, m in zip(sel_now, mapped)}
        scene2 = [replace.get(o.idset, o) for o in view.scene]
        box = view.selections[0]
        handles = R.handles_size() if box == R.Size else R.handles_rotate()
        old_objs = view.selections[1][0]
        new_objs = [replace.get(o.idset, o) for o in old_objs]
        selections2 = (box, (new_objs, handles))
        dirty = NULL_SHAPE
        for o, o2 in zip(sel_now, mapped):
            if isinstance(o.geometry, R.FilterG) and filtersfancy:
                d = R.alldirty(o, o2, view.master_update, self.device)
            else:
                d = R.dirty_region(o, o2, self.device)(view.master_update)
            d = R.dirty_filter(ident.new_ids(), d, scene2, self.device)
            dirty = s_uni(dirty, d)
        sel_shapes = NULL_SHAPE
        if first:
            for o in R.drawable_of_selection(view.selections):
                sel_shapes = s_uni(sel_shapes, R.shapeonly_of_basicshape(o, self.device))
        if last:
            for o in R.drawable_of_selection(selections2):
                sel_shapes = s_uni(sel_shapes, R.shapeonly_of_basicshape(o, self.device))
        view.scene = scene2
        view.selections = selections2
        total = s_uni(dirty, sel_shapes)
        if total is not None:
            self.force_update(last, ident.new_ids(), view, total)

    def view_change_scene(self, view: R.View, scene2, selections2, first, last):
        """Change scenes with proper dirty computation (engine.ml:560-641)."""
        main_change = scene_changes(view.scene, scene2, self.device)
        sel_shapes = NULL_SHAPE
        if first:
            for o in R.drawable_of_selection(view.selections):
                sel_shapes = s_uni(sel_shapes, R.shapeonly_of_basicshape(o, self.device))
        if last:
            for o in R.drawable_of_selection(selections2):
                sel_shapes = s_uni(sel_shapes, R.shapeonly_of_basicshape(o, self.device))
        view.scene = list(scene2)
        view.selections = selections2
        total = s_uni(main_change, sel_shapes)
        if total is not None:
            self.force_update(True, ident.new_ids(), view, total)

    def move_selected(self, first, dx, dy, view):
        self.view_map_selected_objects(
            lambda o: R.translate_renderobject(dx, dy, o), first, False, view
        )

    def transform_selected(self, first, t, view, originalscene, originalselections):
        self.view_map_selected_objects(
            lambda o: R.transform_renderobject(t, o),
            first,
            False,
            view,
            originalscene=originalscene,
            originalselections=originalselections,
        )

    def selection_to_top(self, view: R.View):
        sel = [o for o in view.scene if R.is_selected(view.selections, o)]
        rest = [o for o in view.scene if not R.is_selected(view.selections, o)]
        self.view_change_scene(view, sel + rest, view.selections, False, False)

    def selection_to_bottom(self, view: R.View):
        sel = [o for o in view.scene if R.is_selected(view.selections, o)]
        rest = [o for o in view.scene if not R.is_selected(view.selections, o)]
        self.view_change_scene(view, rest + sel, view.selections, False, False)

    # --- mouse: select tool (engine.ml:700-998) ---------------------------------

    def select_leftdown(self, x, y, view: R.View):
        self.state.justpicked = False
        picked = R.pick(x, y, view)
        if isinstance(picked, R.PickedObject):
            if not R.is_selected(view.selections, picked.obj):
                self.state.justpicked = True
                self.change_selection(view, R.null_selection)
                self.change_selection(
                    view, (R.Size, ([picked.obj], R.handles_size())), noupdate=True
                )
                self.wx.set_status_bar(view.window, Messages.objsel)
            self.undo.record(view)
            self.state.dragging = ("object", x, y, list(view.scene), view.selections)
            self.state.outlines = self.wx.option_down
            self.wx.capture_mouse(view.window)
            self.captured = True
        elif isinstance(picked, R.PickedSelectionHandle):
            self.undo.record(view)
            self.state.dragging = (
                "handle", x, y, picked.handle, picked.obj, picked.objs,
                list(view.scene), view.selections,
            )
            self.state.outlines = self.wx.option_down
            self.wx.capture_mouse(view.window)
            self.captured = True
            self.wx.set_status_bar(
                view.window,
                Messages.dragsize if view.selections[0] == R.Size else Messages.dragrotate,
            )
        else:
            self.state.dragging = ("rubberband",)
            self.update_rubberband((x, y, x, y), view)

    def zoom_leftdown(self, x, y, view):
        self.state.dragging = ("rubberband",)
        self.update_rubberband((x, y, x, y), view)

    def select_dragging_object(self, view, x, y, xo, yo):
        dx, dy = x - xo, y - yo
        first = (
            not self.state.justpicked
            and self.state.previous_event is not None
            and self.state.previous_event[0] == W.LEFT_DOWN
        )
        self.move_selected(first, dx, dy, view)
        d = self.state.dragging
        self.state.dragging = ("object", x, y, d[3], d[4])

    def _bounds_of_selections(self, selections):
        bs = [R.bounds_of_basicshape(o) for o in selections[1][0]]
        xmin = min(b[0] for b in bs)
        xmax = max(b[1] for b in bs)
        ymin = min(b[2] for b in bs)
        ymax = max(b[3] for b in bs)
        return float(xmin), float(xmax), float(ymin), float(ymax)

    def centre_of_selections(self, selections):
        xmin, xmax, ymin, ymax = self._bounds_of_selections(selections)
        return int((xmin + xmax) / 2.0), int((ymin + ymax) / 2.0)

    def _dragging_action_size(self, x, y, xo, yo, xmin, xmax, ymin, ymax, handle):
        """Size-handle transform (engine.ml:796-840)."""

        def safe(v):
            return v if math.isfinite(v) and v != 0.0 else 1.0

        def mkscale(c, sx, sy):
            return tr.Scale(c, sx, sy)

        def mkscale_corner(c, sx, sy):
            sx, sy = safe(sx), safe(sy)
            if self.wx.shift_down:
                c = ((xmax + xmin) / 2.0, (ymax + ymin) / 2.0)
            if self.wx.command_down:
                s = min(sx, sy)
                return tr.Scale(c, s, s)
            return tr.Scale(c, sx, sy)

        H = R
        if handle == R.HandleTopLeft:
            return mkscale_corner((xmax, ymax), (x - xmax) / (xo - xmax), (y - ymax) / (yo - ymax))
        if handle == R.HandleTopMiddle:
            return mkscale((xmax, ymax), 1.0, (y - ymax) / (yo - ymax))
        if handle == R.HandleTopRight:
            return mkscale_corner((xmin, ymax), (x - xmin) / (xo - xmin), (y - ymax) / (yo - ymax))
        if handle == R.HandleLeftMiddle:
            return mkscale((xmax, ymax), (x - xmax) / (xo - xmax), 1.0)
        if handle == R.HandleRightMiddle:
            return mkscale((xmin, ymin), (x - xmin) / (xo - xmin), 1.0)
        if handle == R.HandleBottomLeft:
            return mkscale_corner((xmax, ymin), (x - xmax) / (xo - xmax), (y - ymin) / (yo - ymin))
        if handle == R.HandleBottomMiddle:
            return mkscale((xmin, ymin), 1.0, (y - ymin) / (yo - ymin))
        if handle == R.HandleBottomRight:
            return mkscale_corner((xmin, ymin), (x - xmin) / (xo - xmin), (y - ymin) / (yo - ymin))
        raise ValueError("transform_of_handle: inconsistency")

    def _dragging_action_rotate(self, cx, cy, x, y, xo, yo, handle):
        """Rotate/shear-handle transform (engine.ml:843-863)."""
        cx, cy = float(cx), float(cy)
        corner = (R.HandleTopLeft, R.HandleTopRight, R.HandleBottomLeft, R.HandleBottomRight)
        if handle in corner:
            angle = gshapes.rotation((cx, cy), (xo, yo), (x, y))
            if self.wx.shift_down:
                angle = gshapes.restrict_angle(math.radians(45.0), angle)
            return tr.Rotate((cx, cy), angle)
        if handle in (R.HandleTopMiddle, R.HandleBottomMiddle):
            return tr.ShearX((cx, cy), (x - cx) / (y - cy))
        if handle in (R.HandleLeftMiddle, R.HandleRightMiddle):
            return tr.ShearY((cx, cy), (y - cy) / (x - cx))
        raise ValueError("transform_of_handle: inconsistency")

    def select_dragging_handle(self, x, y, xo, yo, view, handle, oscene, osel):
        first = (
            not self.state.justpicked
            and self.state.previous_event is not None
            and self.state.previous_event[0] == W.LEFT_DOWN
        )
        xmin, xmax, ymin, ymax = self._bounds_of_selections(osel)
        if view.selections[0] == R.Size:
            t = self._dragging_action_size(
                float(x), float(y), float(xo), float(yo), xmin, xmax, ymin, ymax, handle
            )
        else:
            cx, cy = view.selections[0].x, view.selections[0].y
            t = self._dragging_action_rotate(cx, cy, float(x), float(y), float(xo), float(yo), handle)
        self.transform_selected(first, t, view, oscene, osel)
        robj = R.renderobject_of_handle(view.selections, handle)
        self.state.dragging = ("handle", xo, yo, handle, robj, None, oscene, osel)

    def select_dragging_crosshair(self, x, y, view: R.View):
        """Move the rotation centre (engine.ml:776-793)."""
        box, ss = view.selections
        if box == R.Size:
            raise ValueError("not in rotation mode")
        robj = R.renderobject_of_handle(view.selections, R.HandleRotationCentre)
        old_shape = R.shapeonly_of_basicshape(robj, self.device)
        new_shape = region.translate_shape(x - box.x, y - box.y, old_shape)
        view.selections = rehandle_selections((R.Rotate(x, y), ss))
        self.force_update(True, ident.new_ids(), view, s_uni(old_shape, new_shape))
        d = self.state.dragging
        robj2 = R.renderobject_of_handle(view.selections, R.HandleRotationCentre)
        self.state.dragging = ("handle", x, y, R.HandleRotationCentre, robj2, None, d[6], d[7])

    def select_dragging(self, x, y, view):
        self.state.justpicked = False
        d = self.state.dragging
        if d[0] == "object":
            self.select_dragging_object(view, x, y, d[1], d[2])
        elif d[0] == "handle" and d[3] == R.HandleRotationCentre:
            self.select_dragging_crosshair(x, y, view)
        elif d[0] == "handle":
            self.select_dragging_handle(x, y, d[1], d[2], view, d[3], d[6], d[7])
        elif d[0] == "rubberband":
            self.wx.set_status_bar(view.window, Messages.dragrubberband)
            if view.rubberband is not None:
                x0, y0, _, _ = view.rubberband
                self.update_rubberband((x0, y0, x, y), view)

    def zoom_dragging(self, x, y, view):
        self.wx.set_status_bar(view.window, Messages.dragrubberband)
        if view.rubberband is not None:
            x0, y0, _, _ = view.rubberband
            self.update_rubberband((x0, y0, x, y), view)

    def select_leftup(self, x, y, view: R.View):
        picked = R.pick(x, y, view)
        if isinstance(picked, R.PickedObject):
            selected = R.is_selected(view.selections, picked.obj)
            prev = self.state.previous_event
            if selected and prev is not None and prev[0] == W.LEFT_DOWN and not self.state.justpicked:
                # Toggle size <-> rotate handles (engine.ml:929-941).
                box, ss = view.selections
                if box == R.Size:
                    cx, cy = self.centre_of_selections(view.selections)
                    sel2 = (R.Rotate(cx, cy), ss)
                else:
                    sel2 = (R.Size, ss)
                self.change_selection(view, rehandle_selections(sel2))
            elif selected and prev is not None and prev[0] == W.LEFT_DOWN:
                self.redraw_selections(view)
            elif prev is not None and prev[0] == W.LEFT_DRAGGING:
                box, ss = view.selections
                if isinstance(box, R.Rotate):
                    cx, cy = self.centre_of_selections(view.selections)
                    self.change_selection(view, (R.Rotate(cx, cy), ss))
                else:
                    self.redraw_selections(view)
        d = self.state.dragging
        if d[0] == "handle":
            self.redraw_selections(view)
        elif d[0] == "rubberband":
            old = view.rubberband
            self.update_rubberband(None, view)
            if old is not None:
                x0, y0, x1, y1 = old
                if (x0, y0) == (x1, y1):
                    self.change_selection(view, R.null_selection)
                else:
                    xmin, xmax = min(x0, x1), max(x0, x1)
                    ymin, ymax = min(y0, y1), max(y0, y1)
                    hits = [
                        o
                        for o in view.scene
                        if box_intersect(
                            (xmin, ymin, xmax, ymax),
                            (lambda b: (min(b[0], b[1]), min(b[2], b[3]), max(b[0], b[1]), max(b[2], b[3])))(
                                R.bounds_of_basicshape(o)
                            ),
                        )
                        is not None
                    ]
                    if hits:
                        self.change_selection(view, (R.Size, (hits, R.handles_size())))
                    else:
                        self.change_selection(view, R.null_selection)
        self.state.dragging = DragNone
        self.wx.set_status_bar(
            view.window,
            Messages.nonesel if view.selections == R.null_selection else Messages.objsel,
        )
        if self.captured:
            self.captured = False
            self.wx.release_mouse(view.window)

    # --- zoom tool (engine.ml:1015-1105) ---------------------------------------

    def update_selections_objs(self, objs, view):
        pairs = dict(zip((o.idset for o in objs), view.scene))
        box, (robjs, handles) = view.selections
        robjs2 = [pairs.get(o.idset, o) for o in robjs]
        view.selections = rehandle_selections((box, (robjs2, handles)))

    def zoom_transform(self, view: R.View, t):
        old = list(view.scene)
        view.scene = [R.transform_renderobject_many(t, o) for o in view.scene]
        self.update_selections_objs(old, view)
        self.force_update_whole(view)

    def zoom_about(self, view, cx, cy, z):
        self.zoom_transform(view, [tr.Scale((cx, cy), z, z)])

    def zoom_leftup(self, x, y, view: R.View):
        d = self.state.dragging
        rb = view.rubberband
        if d[0] == "rubberband" and rb is not None and rb[0] != rb[2] and rb[1] != rb[3]:
            x0, y0, x1, y1 = rb
            self.state.dragging = DragNone
            view.rubberband = None
            self.wx.set_status_bar(
                view.window,
                Messages.nonesel if view.selections == R.null_selection else Messages.objsel,
            )
            vw, vh = self.wx.get_window_size(view.window)
            dx = float(vw // 2 - (x0 + x1) // 2)
            dy = float(vh // 2 - (y0 + y1) // 2)
            sx = vw / abs(x0 - x1)
            sy = vh / abs(y0 - y1)
            scale = min(sx, sy)
            c = (vw / 2.0, vh / 2.0)
            self.zoom_transform(view, [tr.Scale(c, scale, scale), tr.Translate(dx, dy)])
        elif d[0] == "rubberband":
            vw, vh = self.wx.get_window_size(view.window)
            self.zoom_about(view, vw / 2.0, vh / 2.0, 2.0)

    def select_rightdown(self, x, y, view: R.View):
        self.state.justpicked = False
        picked = R.pick(x, y, view)
        if isinstance(picked, R.PickedObject):
            self.state.dragging = ("object", x, y, list(view.scene), view.selections)
            if R.is_selected(view.selections, picked.obj):
                box, (os, handles) = view.selections
                os2 = [o for o in os if not ident.set_eq(o.idset, picked.obj.idset)]
                self.change_selection(view, (box, (os2, handles)))
            else:
                box, (os, h) = view.selections
                handles = R.handles_size() if box == R.Size else R.handles_rotate()
                self.change_selection(view, (box, ([picked.obj] + os, h)))

    def select_rightup(self, x, y, view):
        self.state.dragging = DragNone

    def zoom_rightup(self, x, y, view):
        rb = view.rubberband
        if rb is None or (rb[0], rb[1]) == (rb[2], rb[3]):
            vw, vh = self.wx.get_window_size(view.window)
            self.zoom_about(view, vw / 2.0, vh / 2.0, 0.5)

    # --- keyboard (engine.ml:1107-1155) -----------------------------------------

    def nudge_selection(self, dx, dy, view):
        self.view_map_selected_objects(
            lambda o: R.translate_renderobject(dx, dy, o), True, False, view
        )
        box, ss = view.selections
        if isinstance(box, R.Rotate):
            cx, cy = self.centre_of_selections(view.selections)
            self.change_selection(view, rehandle_selections((R.Rotate(cx, cy), ss)))
        else:
            self.change_selection(view, rehandle_selections((R.Size, ss)))

    def select_keydown(self, view, key):
        if key == W.Escape:
            d = self.state.dragging
            if d[0] == "none":
                self.change_selection(view, R.null_selection)
            elif d[0] in ("object", "handle"):
                oscene = d[3] if d[0] == "object" else d[6]
                osel = d[4] if d[0] == "object" else d[7]
                self.view_change_scene(view, oscene, osel, False, True)
                self.state.dragging = DragNone
            elif d[0] == "rubberband":
                self.update_rubberband(None, view)
                self.state.dragging = DragNone
                self.wx.set_status_bar(
                    view.window,
                    Messages.nonesel if view.selections == R.null_selection else Messages.objsel,
                )
        elif key == W.Left:
            self.nudge_selection(-1, 0, view)
        elif key == W.Right:
            self.nudge_selection(1, 0, view)
        elif key == W.Down:
            self.nudge_selection(0, 1, view)
        elif key == W.Up:
            self.nudge_selection(0, -1, view)

    def zoom_keydown(self, view, key):
        if key == W.Escape and self.state.dragging[0] == "rubberband":
            self.update_rubberband(None, view)
            self.state.dragging = DragNone

    def select_keyup(self, view, key):
        mods = (self.wx.command_down, self.wx.shift_down, self.wx.option_down)
        if key == "A" and mods == (True, False, False):
            self.select_all(view)
        elif key == "B" and mods == (True, False, False):
            self.selection_to_bottom(view)
        elif key == "F" and mods == (True, False, False):
            self.selection_to_top(view)
        elif key == "Z" and mods == (True, False, False):
            state = self.undo.undo(view)
            if state is not None:
                self.view_change_scene(view, state.scene, state.selections, True, True)
        elif key == "Y" and mods == (True, False, False):
            state = self.undo.redo(view)
            if state is not None:
                self.view_change_scene(view, state.scene, state.selections, True, True)

    # --- tools/buttons (engine.ml:1160-1198) -------------------------------------

    def selecttool(self, window):
        view = self.pickview(window)
        view.tool = W.Select
        self.wx.set_status_bar(
            window,
            Messages.nonesel if view.selections == R.null_selection else Messages.objsel,
        )

    def zoomtool(self, window):
        view = self.pickview(window)
        view.tool = W.Zoom
        self.wx.set_status_bar(window, Messages.zoomhints)

    def changeblur(self, view, value):
        assert value >= 0
        self.undo.record(view)
        f = (
            unconvolve_renderobject
            if value == 0
            else (lambda o: convolve_renderobject(rconvolve.mkgaussian(value), o))
        )
        self.view_map_selected_objects(f, True, True, view)

    def changetrans(self, view, value):
        assert 0 <= value <= 255
        self.undo.record(view)
        self.view_map_selected_objects(
            lambda o: trans_renderobject(value, o), True, True, view, filtersfancy=True
        )

    # --- files / demos (engine.ml:1200-1466) --------------------------------------

    def _page_scene(self, name, page_index):
        """Display-ready scene for one page: (objs, disp_w, disp_h, npages)."""
        graphic, pdf = E.pdf_graphic_from_file(name, page_index)
        pages = pdf.pages()
        pg = pages[max(0, min(len(pages) - 1, page_index))]
        mb = pdf.resolve(pg.get("MediaBox", [0, 0, 612, 792]))
        page_w = abs(float(mb[2]) - float(mb[0]))
        page_h = abs(float(mb[3]) - float(mb[1]))
        objs = pdfscene.scene_of_graphic(pdf, graphic, self.device)
        # Page /Rotate (inheritable, PDF 7.7.3.3): rotate the content into
        # display orientation and swap the page box for 90/270.  BEYOND
        # REFERENCE: engine.ml:1200-1229 ignores the attribute.
        try:
            rot = int(pdf.resolve(pg.get("Rotate", 0)) or 0) % 360
        except Exception:
            rot = 0
        pre: list = []
        disp_w, disp_h = page_w, page_h
        if rot == 90:
            pre = [tr.Translate(0.0, page_w), tr.Rotate((0.0, 0.0), -math.pi / 2)]
            disp_w, disp_h = page_h, page_w
        elif rot == 180:
            pre = [tr.Translate(page_w, page_h), tr.Rotate((0.0, 0.0), math.pi)]
        elif rot == 270:
            pre = [tr.Translate(page_h, 0.0), tr.Rotate((0.0, 0.0), math.pi / 2)]
            disp_w, disp_h = page_h, page_w
        t = [
            tr.Translate(100.0, 100.0),
            tr.Scale((0.0, disp_h / 2.0), 1.0, -1.0),
        ] + pre
        objs2 = [R.transform_renderobject_many(t, o) for o in reversed(objs)]
        return objs2, disp_w, disp_h, len(pages)

    def openfile(self, name):
        import os

        objs2, disp_w, disp_h, npages = self._page_scene(name, 0)
        view = R.View(
            device=self.device,
            scene=objs2,
            pages=page(100.0, 100.0, disp_w, disp_h),
            window=W.nullwindow,
            background=[background_obj()],
            selections=R.null_selection,
            master_update=self.master_update,
            rubberband=None,
            tool=W.Select,
        )
        self.views.insert(0, view)
        view.window = self.wx.make_window(
            os.path.basename(name), 600, 400, 200, 200, 1280, 1024, True
        )
        self.docs[view.window] = [name, 0, npages]

    def goto_page(self, view, delta: int):
        """PageUp/PageDown navigation across a document's pages (BEYOND
        REFERENCE: the reference renders page 1 only)."""
        info = self.docs.get(view.window)
        if not info:
            return
        name, idx, n = info
        new = max(0, min(n - 1, idx + delta))
        if new == idx:
            return
        objs2, disp_w, disp_h, _ = self._page_scene(name, new)
        view.scene = objs2
        view.pages = page(100.0, 100.0, disp_w, disp_h)
        view.selections = R.null_selection
        info[1] = new
        self.state.dragging = DragNone
        self.force_update_whole(view)
        self.wx.set_status_bar(view.window, f"Page {new + 1}/{n}")

    def opendemo(self, geom, renderobjects, name):
        sx, sy, dx, dy, canvas_w, canvas_h = geom
        view = R.View(
            device=self.device,
            scene=list(renderobjects),
            pages=page(50.0, 50.0, float(canvas_w), float(canvas_h)),
            window=W.nullwindow,
            background=[background_obj()],
            selections=R.null_selection,
            master_update=region.shape_of_box((0, 0, canvas_w + 150, canvas_h + 150), self.device),
            rubberband=None,
            tool=W.Select,
        )
        self.views.insert(0, view)
        view.window = self.wx.make_window(name, sx, sy, dx, dy, 0, 0, True)
        return view

    def opendemos(self):
        """The "Minimal Rendering" demo window (engine.ml:1356-1466)."""
        scale = lambda n: (lambda o: R.transform_renderobject(tr.Scale((0.0, 0.0), n, n), o))
        flipy = lambda o: R.transform_renderobject(tr.Scale((0.0, 0.0), 1.0, -1.0), o)
        rotate = lambda a: (
            lambda o: R.transform_renderobject(tr.Rotate((0.0, 0.0), math.radians(a)), o)
        )
        move = lambda anchor, p: (lambda o: R.position_anchor(anchor, p, o))
        fade = lambda v: (lambda o: trans_renderobject(v, o))
        blur = lambda r: (lambda o: blur_renderobject(r, o))

        def line(col, thick, p, p2):
            path = gpath.Path(
                gpath.EVEN_ODD, (gpath.Subpath(False, False, (gpath.Straight(p, p2),)),)
            )
            spec = gshapes.StrokeSpec(
                startcap=gshapes.ButtCap,
                join=gshapes.BevelJoin,
                endcap=gshapes.ButtCap,
                mitrelimit=10.0,
                linewidth=thick,
            )
            return E.object_of_geometry(R.Basic(rfills.plain(col), R.StrokedPathShape(path, spec)))

        movex = lambda n: (lambda o: R.transform_renderobject(tr.Translate(n, 0.0), o))
        movexy = lambda p: (lambda o: R.transform_renderobject(tr.Translate(*p), o))

        def border_of_obj(width, colour, obj):
            """Stroked-border highlight of a Path / Path-filter object
            (engine.ml:1315-1330): same path, mitred 1-px stroke, the
            object's own transform, Over."""
            geom = obj.geometry
            if isinstance(geom, R.FilterG):
                geom = geom.filter.geometry
            if not (isinstance(geom, R.Basic) and isinstance(geom.shape, R.PathShape)):
                raise ValueError("Can't use border here")
            spec = gshapes.StrokeSpec(
                startcap=gshapes.ButtCap,
                join=gshapes.MitredJoin,
                endcap=gshapes.ButtCap,
                mitrelimit=1.0,
                linewidth=width,
            )
            return R.Obj(
                ident.new_ids(),
                R.Basic(rfills.plain(colour), R.StrokedPathShape(geom.shape.path, spec)),
                obj.transform,
                R.OVER,
            )

        bordercol = C.dissolve(C.black, delta=128)
        wf = move(R.Centre, (150.0, 550.0))(E.wireframe())
        bf = move(R.Centre, (300.0, 550.0))(E.blurfilter())
        mf = move(R.Centre, (450.0, 550.0))(E.monofilter())
        objs = [
            border_of_obj(1.0, bordercol, wf),
            wf,
            border_of_obj(1.0, bordercol, bf),
            bf,
            border_of_obj(1.0, bordercol, mf),
            mf,
            move(R.TopLeft, (50.0, 10.0))(scale(1.3)(flipy(E.mintext1()))),
            move(R.Centre, (300.0, 150.0))(scale(0.6)(E.brushcircle())),
            move(R.Centre, (450.0, 350.0))(fade(128)(blur(3)(scale(2.0)(flipy(E.logo()))))),
            move(R.Centre, (450.0, 150.0))(flipy(E.q_shape_2())),
            move(R.Centre, (150.0, 150.0))(E.brushblue()),
            move(R.Centre, (150.0, 350.0))(rotate(25.0)(scale(0.5)(E.cpg_example()))),
            move(R.Centre, (300.0, 350.0))(
                R.mkgroup(
                    [movex(50.0 + 10.0 * k)(line(C.green, 1.0, (10.0, 60.0), (10.0 + 10.0 * k, 100.0))) for k in range(6)]
                    + [
                        movexy((50.0 + 10.0 * k, 50.0))(
                            line(C.green, 2.0, (10.0, 60.0), (10.0 + 10.0 * k, 100.0))
                        )
                        for k in range(6)
                    ]
                )
            ),
        ]
        self.opendemo((600, 700, 0, 30, 500, 580), objs, "Minimal Rendering")

    # --- event loop (engine.ml:1468-1627) -----------------------------------------

    def filter_event(self, event):
        if event[0] == W.LEFT_DRAGGING:
            prev = self.state.previous_event
            if prev is not None and prev[0] == W.LEFT_DOWN and prev[2:] == event[2:]:
                return (W.NULL_EVENT,)
        return event

    def event_handler(self, event):
        kind = event[0]
        if kind == W.APP_STARTUP:
            if self.cache_debug:
                self.wx.open_cachewindow()
            if self.frag_debug:
                self.frag_window = self.wx.make_window(
                    "Sprite Debug window", 600, 740, 650, 30, 560, 240, False
                )
                self.wx.set_status_bar(
                    self.frag_window,
                    "This window shows the redraw region of the window above.",
                )
            self.opendemos()
        elif kind == W.WINDOW_CLOSED:
            self.remove_view(event[1])
            self.wx.delete_window(event[1])
            if not self.views:
                raise AppExit
        elif kind == W.APP_CLOSE:
            for v in list(self.views):
                self.wx.close_window(v.window)
                self.remove_view(v.window)
            raise AppExit
        elif kind == W.OPEN_FILE:
            self.openfile(event[1])
        elif kind in (W.LEFT_DOWN, W.LEFT_UP, W.RIGHT_DOWN, W.RIGHT_UP):
            win = event[1]
            x, y = self.wx.mouse_coords(win)
            self.mouse = (x, y)
            view = self.pickview(win)
            method = {
                (W.LEFT_DOWN, W.Select): self.select_leftdown,
                (W.LEFT_DOWN, W.Zoom): self.zoom_leftdown,
                (W.LEFT_UP, W.Select): self.select_leftup,
                (W.LEFT_UP, W.Zoom): self.zoom_leftup,
                (W.RIGHT_DOWN, W.Select): self.select_rightdown,
                (W.RIGHT_DOWN, W.Zoom): lambda *a: None,
                (W.RIGHT_UP, W.Select): self.select_rightup,
                (W.RIGHT_UP, W.Zoom): self.zoom_rightup,
            }[(kind, view.tool)]
            method(event[2], event[3], view)
        elif kind == W.LEFT_DRAGGING:
            win = event[1]
            if self.cache_debug:
                self.wx.set_cachetext(cache.string_of_cachestate())
            x, y = self.wx.mouse_coords(win)
            prev = self.state.previous_mouse_event
            if (
                prev is not None
                and prev[0] in (W.LEFT_DRAGGING, W.LEFT_DOWN)
                and (x, y) != self.mouse
            ):
                self.mouse = (x, y)
                view = self.pickview(win)
                if view.tool == W.Zoom:
                    self.zoom_dragging(x, y, view)
                else:
                    self.select_dragging(x, y, view)
            else:
                self.mouse = (x, y)
        elif kind == W.KEY_DOWN:
            view = self.pickview(event[1])
            if event[2] == W.PageDown:
                self.goto_page(view, 1)
            elif event[2] == W.PageUp:
                self.goto_page(view, -1)
            else:
                (self.zoom_keydown if view.tool == W.Zoom else self.select_keydown)(view, event[2])
        elif kind == W.KEY_UP:
            view = self.pickview(event[1])
            if view.tool == W.Select:
                self.select_keyup(view, event[2])
        elif kind == W.PAINT_RECT:
            self.render_rect(event[1], event[2], event[3], event[4], event[5])
        elif kind == W.BUTTON_CLICKED:
            win, b = event[1], event[2]
            if b == 1:
                self.selecttool(win)
            elif b == 2:
                self.zoomtool(win)
            elif b == 3:
                self.selection_to_top(self.pickview(win))
            elif b == 4:
                self.selection_to_bottom(self.pickview(win))
        elif kind == W.BLUR_SLIDER:
            self.changeblur(self.pickview(event[1]), event[2])
        elif kind == W.TRANS_SLIDER:
            self.changetrans(self.pickview(event[1]), event[2])
        if kind != W.NULL_EVENT:
            self.state.previous_event = event
        if kind in (W.LEFT_DOWN, W.LEFT_UP, W.RIGHT_DOWN, W.RIGHT_UP, W.LEFT_DRAGGING):
            self.state.previous_mouse_event = event

    def run(self, max_events: Optional[int] = None, resilient: bool = True):
        """The main loop (engine.ml:1607-1627), in whatever thread calls it.

        Unlike the reference — where any exception aborts the loop and kills
        both processes (engine.ml:1622-1627, SURVEY.md §5.3) — event-handler
        failures are contained by default: the event is dropped, drag state
        resets, and the loop continues.  A ``NotImplementedError`` is never
        contained: it names a branch this package has not ported."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        n = 0
        try:
            while max_events is None or n < max_events:
                e = self.wx.poll()
                if e[0] == W.NULL_EVENT and max_events is None:
                    continue
                try:
                    self.event_handler(self.filter_event(e))
                except (AppExit, NotImplementedError):
                    raise
                except Exception as exc:  # noqa: BLE001 — containment is the point
                    if not resilient:
                        raise
                    profiling.counter("engine.event_errors")
                    print(f"engine: error handling {e[0]}: {exc!r}")
                    self.state.dragging = DragNone
                n += 1
        except AppExit:
            self.wx.close_application()
            self.wx.shutdown()


def rehandle_selections(selections):
    """Fresh handles (engine.ml:655-661)."""
    box, (objects, _) = selections
    handles = R.handles_size() if box == R.Size else R.handles_rotate()
    return box, (objects, handles)


# --- scene diffing (engine.ml:560-641) ---------------------------------------


def _obj_same_content(a, b) -> bool:
    """True when two same-idset objects would render identically.

    Transparency slides keep the idset on purpose (trans_renderobject,
    engine.ml:57-70: the cached sprite doesn't depend on the PreTrans
    alpha) — so undo/redo can legally restore an object that shares its
    idset with the current one but differs in compop, transform or (for
    filter lenses) geometry.  Those must count as changed."""
    if a is b:
        return True
    if a.compop != b.compop or a.transform != b.transform:
        return False
    if a.geometry is b.geometry:
        return True
    try:
        return bool(a.geometry == b.geometry)
    except Exception:
        return False


def scene_changes(s, s2, device):
    """Dirty shape between two scenes: symmetric difference, content
    changes under a shared idset, depth changes, and filter dirty
    transfer (engine.ml:599-641), as a shape on `device`."""
    ids_s = [o.idset for o in s]
    ids_s2 = [o.idset for o in s2]
    in_both = set(i for i in ids_s) & set(ids_s2)
    changed = [
        R.shapeonly_of_basicshape(o, device)
        for o in list(s) + list(s2)
        if o.idset not in in_both
    ]
    by_id = {o.idset: o for o in s}
    by_id2 = {o.idset: o for o in s2}
    for i in in_both:
        if not _obj_same_content(by_id[i], by_id2[i]):
            changed.append(R.shapeonly_of_basicshape(by_id[i], device))
            changed.append(R.shapeonly_of_basicshape(by_id2[i], device))
    # Depth-order changes among shared objects.
    order_s = [i for i in ids_s if i in in_both]
    order_s2 = [i for i in ids_s2 if i in in_both]
    pos2 = {i: k for k, i in enumerate(order_s2)}
    obj_by_id = {o.idset: o for o in s}
    depth = []
    for a_i in range(len(order_s)):
        for b_i in range(a_i + 1, len(order_s)):
            a, b = order_s[a_i], order_s[b_i]
            if pos2[a] > pos2[b]:
                depth.append(
                    s_int(
                        R.shapeonly_of_basicshape(obj_by_id[a], device),
                        R.shapeonly_of_basicshape(obj_by_id[b], device),
                    )
                )
    # Filters in both scenes transfer the changes below them.
    filt = []
    filters_in_both = [
        o for o in s if isinstance(o.geometry, R.FilterG) and o.idset in in_both
    ]
    for fobj in filters_in_both:
        def below(obj, scene):
            ids = [o.idset for o in scene]
            k = ids.index(obj.idset)
            return list(scene)[k + 1 :]

        inner = scene_changes(below(fobj, s), below(fobj, s2), device)
        filt.append(
            s_int(fobj.geometry.filter.dirty(inner, fobj, device), R.shapeonly_of_basicshape(fobj, device))
        )
    total = NULL_SHAPE
    for sh in changed + depth + filt:
        total = s_uni(total, sh)
    return total
