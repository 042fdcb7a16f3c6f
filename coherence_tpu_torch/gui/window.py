"""Windowing proxy (parity: reference ``wxgui.ml`` + ``main.py``).

The reference runs a wxPython process connected by TCP; here a
``WindowSystem`` hosts per-window RGB framebuffers and speaks to a
``Display`` backend:

* :class:`HeadlessDisplay` — in-process, no UI: windows are plain records,
  events are injected programmatically (tests, demos, screenshot dumps);
* :class:`RemoteDisplay` — the reference's socket protocol, for an external
  display client (same message vocabulary: MakeWindow/RefreshWindow/
  MouseNow/... with synchronous-RPC reply matching, wxgui.ml:207-227).

Sprite plotting writes the rendered sprite's RGB straight into the window's
framebuffer (the renderer has already composited; wxgui.ml:370-424), and
``refresh_window`` ships the dirty rect's bytes to the display.

The PyTorch counterpart of ``coherence_tpu.gui.window``.  Framebuffers are
host arrays, as there; a sprite or canvas lives on whatever device rendered
it and is read to the host once where it is plotted or shipped
(``plot_sprite``, ``rgb_bytes_of_canvas``): each such read is a
synchronising copy, counted in ``region.syncs``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .. import native_lib
from ..raster import fills as rfills
from ..raster import region

# Tools (wxgui.ml:431)
Select = "select"
Zoom = "zoom"

# Keys (wxgui.ml:15-22)
Escape, Left, Up, Right, Down = "Escape", "Left", "Up", "Right", "Down"
PageUp, PageDown = "PageUp", "PageDown"

_KEYCODES = {27: Escape, 314: Left, 315: Up, 316: Right, 317: Down,
             366: PageUp, 367: PageDown}
_KEYCODES.update({k: chr(k) for k in range(65, 91)})


def key_of_keycode(k: int) -> str:
    return _KEYCODES.get(k, f"UnknownKey{k}")


# Events (wxgui.ml:25-42): (kind, *payload) tuples.
APP_STARTUP = "AppStartup"
APP_CLOSE = "AppClose"
OPEN_FILE = "OpenFile"
WINDOW_CLOSED = "WindowClosed"
BUTTON_CLICKED = "ButtonClicked"
KEY_DOWN = "KeyDown"
KEY_UP = "KeyUp"
LEFT_DOWN = "LeftDown"
LEFT_UP = "LeftUp"
RIGHT_DOWN = "RightDown"
RIGHT_UP = "RightUp"
LEFT_DRAGGING = "LeftDragging"
PAINT_RECT = "PaintRect"
BLUR_SLIDER = "BlurSlider"
TRANS_SLIDER = "TransSlider"
INTERNAL = "Internal"
NULL_EVENT = "NullEvent"

CANVAS_W, CANVAS_H = 1280, 1024  # per-window framebuffer (wxgui.ml:262)

nullwindow = -1


def serving_device(device) -> torch.device:
    """The device a server renders on, with its index filled in (CUDA's
    current device is per thread; an indexed device means the same card in
    every thread).  Raises if a CUDA device is asked for and there is none:
    a server never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but CUDA is not available; pass device=\"cpu\" to serve from the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class _Win:
    name: str
    width: int
    height: int
    scroll: Tuple[int, int] = (0, 0)
    status: str = ""
    blur: int = 0
    trans: int = 255


class HeadlessDisplay:
    """In-process display: no UI, programmable events, inspectable state."""

    def __init__(self):
        self.windows: Dict[int, _Win] = {}
        self._next = 1
        self.events: deque = deque()
        self.mouse: Tuple[int, int] = (0, 0)
        self.refreshed: list = []  # (window, rect) log
        self.cachetext: str = ""
        self.screen = (1920, 1080)

    # --- engine-facing RPCs ------------------------------------------------

    def make_window(self, name, sx, sy, dx, dy, ex, ey, toolbar) -> int:
        w = self._next
        self._next += 1
        self.windows[w] = _Win(name, sx, sy)
        return w

    def close_window(self, w):
        self.windows.pop(w, None)

    def window_size(self, w):
        win = self.windows[w]
        return win.width, win.height

    def window_scroll(self, w):
        return self.windows[w].scroll

    def mouse_now(self, w):
        return self.mouse

    def screen_size(self):
        return self.screen

    def platform(self):
        return "Headless"

    def refresh_window(self, w, x, y, width, height, rgb_bytes: bytes):
        self.refreshed.append((w, (x, y, width, height)))

    def set_status_bar(self, w, s):
        if w in self.windows:
            self.windows[w].status = s

    def set_blurslider(self, w, v):
        if w in self.windows:
            self.windows[w].blur = v

    def set_transslider(self, w, v):
        if w in self.windows:
            self.windows[w].trans = v

    def set_cachetext(self, s):
        self.cachetext = s

    def capture_mouse(self, w):
        pass

    def release_mouse(self, w):
        pass

    def open_cachewindow(self):
        pass

    def startup(self, icons):
        self.post(APP_STARTUP)

    def close_application(self):
        pass

    # --- event injection ----------------------------------------------------

    def post(self, kind, *payload):
        self.events.append((kind, *payload))

    def poll(self):
        if self.events:
            return self.events.popleft()
        return (NULL_EVENT,)


class RemoteDisplay:
    """Speaks the reference protocol to a display client over TCP
    (wxgui.ml:95-367 message vocabulary)."""

    def __init__(self, connection):
        self.conn = connection
        self.pending: deque = deque()

    def _synch_call(self, name, *args):
        self.conn.send([name, *args])
        while True:
            v = self.conn.poll()
            e = self._decode(v)
            if e[0] == INTERNAL and e[1] and e[1][0] == (
                name.encode() if isinstance(name, str) else name
            ):
                return e[1][1:]
            self.pending.append(e)

    @staticmethod
    def _decode(v):
        """Wire tuple -> event tuple (wxgui.ml:143-191)."""
        if not isinstance(v, list) or not v:
            return (NULL_EVENT,)
        head = v[0].decode("latin1") if isinstance(v[0], bytes) else v[0]
        rest = v[1:]
        if head == "AppStart":
            return (APP_STARTUP,)
        if head == "AppClose":
            return (APP_CLOSE,)
        if head in ("KeyDown", "KeyUp"):
            return (head, rest[0], key_of_keycode(rest[1]))
        if head in ("LeftDown", "LeftUp", "RightDown", "RightUp", "LeftDragging"):
            return (head, *rest)
        if head == "Button":
            return (BUTTON_CLICKED, rest[1], rest[0])
        if head == "CloseWindow":
            return (WINDOW_CLOSED, rest[0])
        if head == "OpenFile":
            return (OPEN_FILE, rest[0].decode("latin1"))
        if head == "PaintRect":
            return (PAINT_RECT, *rest)
        if head in ("BlurSlider", "TransSlider"):
            return (head, *rest)
        if head == "Internal":
            return (INTERNAL, rest)
        return (INTERNAL, [v[0], *rest])

    def poll(self):
        if self.pending:
            return self.pending.popleft()
        return self._decode(self.conn.poll())

    def post(self, kind, *payload):  # parity with HeadlessDisplay for tests
        self.pending.append((kind, *payload))

    def make_window(self, name, sx, sy, dx, dy, ex, ey, toolbar) -> int:
        (w,) = self._synch_call("MakeWindow", name, sx, sy, dx, dy, ex, ey, toolbar)
        return w

    def close_window(self, w):
        self._synch_call("CloseWindow", w)

    def window_size(self, w):
        (ww,) = self._synch_call("WindowWidth", w)
        (hh,) = self._synch_call("WindowHeight", w)
        return ww, hh

    def window_scroll(self, w):
        dx, dy = self._synch_call("WindowScroll", w)
        return dx, dy

    def mouse_now(self, w):
        x, y = self._synch_call("MouseNow", w)
        return x, y

    def screen_size(self):
        w, h = self._synch_call("ScreenSize")
        return w, h

    def platform(self):
        (p,) = self._synch_call("Platform")
        return p.decode("latin1") if isinstance(p, bytes) else p

    def refresh_window(self, w, x, y, width, height, rgb_bytes: bytes):
        self._synch_call("RefreshWindow", w, x, y, width, height, rgb_bytes)

    def set_status_bar(self, w, s):
        self.conn.send(["SetStatusBar", w, s])

    def set_blurslider(self, w, v):
        self.conn.send(["SetBlurSlider", w, v])

    def set_transslider(self, w, v):
        self.conn.send(["SetTransSlider", w, v])

    def set_cachetext(self, s):
        self.conn.send(["SetCacheText", s])

    def capture_mouse(self, w):
        self.conn.send(["CaptureMouse", w])

    def release_mouse(self, w):
        self.conn.send(["ReleaseMouse", w])

    def open_cachewindow(self):
        self.conn.send(["OpenCacheWindow"])

    def startup(self, icons):
        """Ship toolbar icons as raw RGB + alpha planes (wxgui.ml:110-120)."""
        msg = ["Startup"]
        for canvas in icons:
            msg.append(rgb_bytes_of_canvas(canvas))
            msg.append(alpha_bytes_of_canvas(canvas))
        self.conn.send(msg)

    def close_application(self):
        self.conn.send(["AppClose"])


def rgb_bytes_of_canvas(canvas) -> bytes:
    """Canvas -> packed RGB bytes (ref canvas.ml:61-83 string_of_canvas)."""
    region._sync()
    return canvas.rgba[..., :3].to(torch.uint8).cpu().numpy().tobytes()


def alpha_bytes_of_canvas(canvas) -> bytes:
    """Canvas -> alpha bytes (ref canvas.ml:85-105)."""
    region._sync()
    return canvas.rgba[..., 3].to(torch.uint8).cpu().numpy().tobytes()


class WindowSystem:
    """The engine-side windowing API (the ``Wxgui`` module equivalent)."""

    def __init__(self, display=None):
        self.display = display or HeadlessDisplay()
        self.framebuffers: Dict[int, np.ndarray] = {}
        self.shift_down = False
        self.command_down = False
        self.option_down = False

    # --- lifecycle ----------------------------------------------------------

    def startup(self, icons):
        self.display.startup(icons)

    def shutdown(self):
        pass

    def close_application(self):
        self.display.close_application()

    # --- events ---------------------------------------------------------------

    def poll(self):
        """Next event; modifier-key updates are consumed here
        (wxgui.ml:143-200)."""
        while True:
            e = self.display.poll()
            if e[0] == INTERNAL and e[1] and e[1][0] in (b"Command", b"Option", b"Shift"):
                name, val = e[1][0], e[1][1]
                if name == b"Command":
                    self.command_down = bool(val)
                elif name == b"Option":
                    self.option_down = bool(val)
                else:
                    self.shift_down = bool(val)
                continue
            return e

    # --- windows -----------------------------------------------------------

    def make_window(self, name, sx, sy, dx, dy, ex, ey, toolbar=True) -> int:
        w = self.display.make_window(name, sx, sy, dx, dy, ex, ey, toolbar)
        # The reference fixes every framebuffer at 1280x1024 (wxgui.ml:262);
        # here it grows with the window so 1080p/4K sessions paint fully.
        self.framebuffers[w] = np.zeros(
            (max(CANVAS_H, sy), max(CANVAS_W, sx), 3), dtype=np.uint8
        )
        return w

    def canvas_size(self, w) -> Tuple[int, int]:
        """(width, height) of the window's framebuffer."""
        fb = self.framebuffers[w]
        return fb.shape[1], fb.shape[0]

    def delete_window(self, w):
        self.framebuffers.pop(w, None)

    def close_window(self, w):
        self.delete_window(w)
        self.display.close_window(w)

    def get_window_size(self, w):
        return self.display.window_size(w)

    def get_window_scroll(self, w):
        return self.display.window_scroll(w)

    def mouse_coords(self, w):
        return self.display.mouse_now(w)

    def set_status_bar(self, w, s):
        self.display.set_status_bar(w, s)

    def set_blurslider(self, w, v):
        self.display.set_blurslider(w, v)

    def set_transslider(self, w, v):
        self.display.set_transslider(w, v)

    def set_cachetext(self, s):
        self.display.set_cachetext(s)

    def capture_mouse(self, w):
        self.display.capture_mouse(w)

    def release_mouse(self, w):
        self.display.release_mouse(w)

    def open_cachewindow(self):
        self.display.open_cachewindow()

    # --- pixels -------------------------------------------------------------

    def plot_sprite(self, w, dx: int, dy: int, sprite) -> None:
        """Write a rendered sprite's RGB into the window framebuffer
        (wxgui.ml:370-424: replacement, not blending — the renderer already
        composited).  The sprite's colours and mask come off its device in
        one copy, as one uint8 plane (r, g, b, mask)."""
        if sprite is None or w not in self.framebuffers:
            return
        region._sync()
        rgbm = torch.cat([sprite.rgba[..., :3], sprite.mask[..., None]], dim=-1).to(torch.uint8)
        x0, y0, _, _ = sprite.box
        native_lib.blit_masked_rgb(self.framebuffers[w], rgbm.cpu().numpy(), y0 + dy, x0 + dx)

    def plot_shape(self, w, dx, dy, colour, shape) -> None:
        if shape is None:
            return
        self.plot_sprite(w, dx, dy, region.fillshape(shape, rfills.plain(colour)))

    def refresh_window(self, w, rect) -> None:
        """Ship the dirty rect of the framebuffer to the display
        (wxgui.ml:334-367)."""
        xmin, ymin, xmax, ymax = rect
        if xmin == xmax or ymin == ymax or w not in self.framebuffers:
            return
        fb = self.framebuffers[w]
        xmin, ymin = max(0, xmin), max(0, ymin)
        xmax, ymax = min(fb.shape[1] - 1, xmax), min(fb.shape[0] - 1, ymax)
        # Made contiguous first: tobytes of a strided view walks it element
        # by element, ten times slower for the same bytes.
        data = np.ascontiguousarray(fb[ymin : ymax + 1, xmin : xmax + 1]).tobytes()
        self.display.refresh_window(
            w, xmin, ymin, xmax - xmin + 1, ymax - ymin + 1, data
        )
