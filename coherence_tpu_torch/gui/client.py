"""Remote display client (parity: the reference's ``main.py`` wxPython
process, headless by default).

Connects to an engine's RemoteDisplay over the wire protocol (directly by
port or via the findport handshake), keeps per-window RGB images, answers the
synchronous RPCs (MakeWindow / WindowWidth / MouseNow / RefreshWindow / ...)
and forwards input events.  ``HeadlessClient`` drives everything
programmatically and can dump window contents as arrays/PPM files — the
protocol is the interface (SURVEY.md §5.8), so a real widget toolkit can
replace it without touching the engine.

The port's copy of ``coherence_tpu.gui.client``, unchanged: a client of
either package serves an engine of either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from . import talk


@dataclass
class ClientWindow:
    name: str
    width: int
    height: int
    image: np.ndarray  # (h, w, 3) uint8
    scroll: Tuple[int, int] = (0, 0)
    status: str = ""
    blur: int = 0
    trans: int = 255


class HeadlessClient:
    """The display half of the protocol (main.py:326-379 dispatch loop)."""

    def __init__(self, conn: talk.Connection):
        self.conn = conn
        self.windows: Dict[int, ClientWindow] = {}
        self._next = 1
        self.mouse: Tuple[int, int] = (0, 0)
        self.icons: list = []
        self.cachetext = ""
        self.running = True

    # --- outgoing (to engine) ------------------------------------------------

    def app_start(self):
        self.conn.send(["AppStart"])

    def send_event(self, *parts):
        self.conn.send(list(parts))

    def reply(self, name: str, *vals):
        self.conn.send(["Internal", name, *vals])

    def paint(self, w: int, x: int, y: int, width: int, height: int):
        self.send_event("PaintRect", w, x, y, width, height)

    def left_click(self, w: int, x: int, y: int):
        self.mouse = (x, y)
        self.send_event("LeftDown", w, x, y)
        self.send_event("LeftUp", w, x, y)

    def drag(self, w: int, x0: int, y0: int, x1: int, y1: int):
        self.mouse = (x0, y0)
        self.send_event("LeftDown", w, x0, y0)
        self.mouse = (x1, y1)
        self.send_event("LeftDragging", w, x1, y1)
        self.send_event("LeftUp", w, x1, y1)

    # --- incoming dispatch ----------------------------------------------------

    def handle_one(self) -> bool:
        """Process one engine message; False when the engine said AppClose.

        The synchronous RPCs mirror main.py's dispatch handlers."""
        v = self.conn.poll()
        if not isinstance(v, list) or not v:
            return True
        head = v[0].decode("latin1") if isinstance(v[0], bytes) else v[0]
        args = v[1:]
        if head == "Startup":
            self.icons = args
        elif head == "MakeWindow":
            name = args[0].decode("latin1") if isinstance(args[0], bytes) else args[0]
            sx, sy = args[1], args[2]
            w = self._next
            self._next += 1
            self.windows[w] = ClientWindow(name, sx, sy, np.zeros((sy, sx, 3), np.uint8))
            self._on_make_window(w)
            self.reply("MakeWindow", w)
        elif head == "CloseWindow":
            self.windows.pop(args[0], None)
            self._on_close_window(args[0])
            self.reply("CloseWindow")
        elif head == "WindowWidth":
            self.reply("WindowWidth", self.windows[args[0]].width)
        elif head == "WindowHeight":
            self.reply("WindowHeight", self.windows[args[0]].height)
        elif head == "WindowScroll":
            self.reply("WindowScroll", *self.windows[args[0]].scroll)
        elif head == "MouseNow":
            self.reply("MouseNow", self.mouse[0], self.mouse[1])
        elif head == "ScreenSize":
            self.reply("ScreenSize", 1920, 1080)
        elif head == "Platform":
            self.reply("Platform", "Headless")
        elif head == "RefreshWindow":
            w, x, y, width, height, data = args
            win = self.windows.get(w)
            if win is not None:
                arr = np.frombuffer(data, np.uint8).reshape(height, width, 3)
                h = min(height, win.height - y)
                ww = min(width, win.width - x)
                if h > 0 and ww > 0:
                    win.image[y : y + h, x : x + ww] = arr[:h, :ww]
                self._on_refresh(w)
            self.reply("RefreshWindow")
        elif head == "SetStatusBar":
            if args[0] in self.windows:
                s = args[1].decode("latin1") if isinstance(args[1], bytes) else args[1]
                self.windows[args[0]].status = s
                self._on_window_state(args[0])
        elif head == "SetBlurSlider":
            if args[0] in self.windows:
                self.windows[args[0]].blur = args[1]
                self._on_window_state(args[0])
        elif head == "SetTransSlider":
            if args[0] in self.windows:
                self.windows[args[0]].trans = args[1]
                self._on_window_state(args[0])
        elif head == "SetCacheText":
            self.cachetext = (
                args[0].decode("latin1") if isinstance(args[0], bytes) else args[0]
            )
        elif head in ("CaptureMouse", "ReleaseMouse", "OpenCacheWindow"):
            pass
        elif head == "AppClose":
            self.running = False
            return False
        return True

    # --- display hooks (no-ops headless; a widget toolkit overrides) ------

    def _on_make_window(self, w: int):
        pass

    def _on_close_window(self, w: int):
        pass

    def _on_refresh(self, w: int):
        pass

    def _on_window_state(self, w: int):
        pass

    def pump(self, until_idle_events: int = 0) -> bool:
        """Handle messages until the socket would block.  Returns False
        when the engine closed the session (AppClose), True otherwise."""
        while True:
            got = self.conn.poll(block=False)
            if got is None:
                return True
            self.conn.queue.appendleft(got)
            if not self.handle_one():
                return False

    def save_ppm(self, w: int, path: str):
        win = self.windows[w]
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (win.width, win.height))
            f.write(win.image.tobytes())

    def save_png(self, w: int, path: str):
        from ..utils.png import write_png

        write_png(path, self.windows[w].image)


def run_client(port: Optional[int] = None, findport_file: str = "findport"):
    """Connect and serve until AppClose (the main.py main loop)."""
    conn = talk.connect(port) if port is not None else talk.connect_findport(findport_file)
    client = HeadlessClient(conn)
    client.app_start()
    while client.running and client.handle_one():
        pass
    conn.close()
    return client
