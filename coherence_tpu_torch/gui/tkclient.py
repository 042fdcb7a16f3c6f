"""Visible display client on tkinter (stdlib) — the reference's wxPython
GUI (main.py:143-198) at one-tenth the code, speaking the same wire
protocol as HeadlessClient (the protocol is the interface, SURVEY.md §5.8).

Per window: a Toplevel with the rendered canvas, the four tool buttons
(select / zoom / to-top / to-bottom — main.py:160-181), the blur (0-10)
and opacity (0-255) sliders, and a status bar.  Every input event forwards
to the engine exactly as the reference forwards wx events
(main.py:250-289); engine->client rects land in the backing image and
redraw the canvas photo.

Run: ``python -m coherence_tpu_torch.gui.tkclient <port>`` against an
engine started with a socket RemoteDisplay (``README.md`` shows the
two-endpoint wiring).

The port's copy of ``coherence_tpu.gui.tkclient``, unchanged; tkinter is
imported only when a ``TkClient`` is made.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import talk
from .client import HeadlessClient

# wx-compatible keycodes (gui/window.py:33-40 key_of_keycode).
_TK_KEYCODES = {
    "Escape": 27,
    "Left": 314,
    "Up": 315,
    "Right": 316,
    "Down": 317,
    "Prior": 366,  # PageUp
    "Next": 367,  # PageDown
}


def _keycode_of_keysym(keysym: str) -> Optional[int]:
    if keysym in _TK_KEYCODES:
        return _TK_KEYCODES[keysym]
    if len(keysym) == 1 and keysym.isalpha():
        return ord(keysym.upper())
    return None


def ppm_bytes(image: np.ndarray) -> bytes:
    """PPM (P6) encoding of an (h, w, 3) uint8 image — what tk.PhotoImage
    accepts without any imaging library."""
    h, w = image.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + image.tobytes()


class TkClient(HeadlessClient):
    """HeadlessClient + on-screen tkinter windows."""

    POLL_MS = 20

    def __init__(self, conn: talk.Connection, root=None):
        super().__init__(conn)
        import tkinter as tk

        self._tk = tk
        self.root = root if root is not None else tk.Tk()
        self.root.withdraw()  # windows are per-engine-window Toplevels
        self._views: Dict[int, dict] = {}
        self._setting_sliders = False

    # --- engine -> widgets -----------------------------------------------------

    def _on_make_window(self, w: int):
        tk = self._tk
        win = self.windows[w]
        top = tk.Toplevel(self.root)
        top.title(win.name)
        top.protocol("WM_DELETE_WINDOW", lambda: self.send_event("CloseWindow", w))

        bar = tk.Frame(top)
        bar.pack(side="top", fill="x")
        for label, b in (("Select", 1), ("Zoom", 2), ("To top", 3), ("To bottom", 4)):
            tk.Button(
                bar, text=label, command=lambda b=b: self.send_event("Button", b, w)
            ).pack(side="left")
        blur = tk.Scale(
            bar, from_=0, to=10, orient="horizontal", label="blur", length=90,
            command=lambda v: self._slider(w, "BlurSlider", int(v)),
        )
        blur.pack(side="left", padx=4)
        trans = tk.Scale(
            bar, from_=0, to=255, orient="horizontal", label="opacity", length=120,
            command=lambda v: self._slider(w, "TransSlider", int(v)),
        )
        # Programmatic .set fires the command; guard so window construction
        # does not send a spurious slider event (which would push a junk
        # undo snapshot engine-side).
        self._setting_sliders = True
        try:
            trans.set(255)
        finally:
            self._setting_sliders = False
        trans.pack(side="left", padx=4)

        canvas = tk.Canvas(top, width=win.width, height=win.height, highlightthickness=0)
        canvas.pack(side="top")
        status = tk.StringVar(value="")
        tk.Label(top, textvariable=status, anchor="w").pack(side="bottom", fill="x")

        photo = tk.PhotoImage(data=ppm_bytes(win.image))
        item = canvas.create_image(0, 0, anchor="nw", image=photo)
        view = {
            "top": top, "canvas": canvas, "photo": photo, "item": item,
            "status": status, "blur": blur, "trans": trans,
        }
        self._views[w] = view

        def xy(ev):
            self.mouse = (ev.x, ev.y)
            return ev.x, ev.y

        canvas.bind("<Button-1>", lambda e: self.send_event("LeftDown", w, *xy(e)))
        canvas.bind("<ButtonRelease-1>", lambda e: self.send_event("LeftUp", w, *xy(e)))
        canvas.bind("<B1-Motion>", lambda e: self.send_event("LeftDragging", w, *xy(e)))
        canvas.bind("<Button-3>", lambda e: self.send_event("RightDown", w, *xy(e)))
        canvas.bind("<ButtonRelease-3>", lambda e: self.send_event("RightUp", w, *xy(e)))
        canvas.bind("<Motion>", lambda e: xy(e))

        def key(ev, updown):
            code = _keycode_of_keysym(ev.keysym)
            if code is not None:
                self.send_event(updown, w, code)

        top.bind("<KeyPress>", lambda e: key(e, "KeyDown"))
        top.bind("<KeyRelease>", lambda e: key(e, "KeyUp"))
        canvas.focus_set()
        # The engine paints reactively: request the initial content.
        self.paint(w, 0, 0, win.width, win.height)

    def _slider(self, w: int, which: str, v: int):
        if not self._setting_sliders:
            self.send_event(which, w, v)

    def _on_close_window(self, w: int):
        view = self._views.pop(w, None)
        if view is not None:
            view["top"].destroy()

    def _on_refresh(self, w: int):
        view = self._views.get(w)
        if view is None:
            return
        view["photo"] = self._tk.PhotoImage(data=ppm_bytes(self.windows[w].image))
        view["canvas"].itemconfigure(view["item"], image=view["photo"])

    def _on_window_state(self, w: int):
        view = self._views.get(w)
        win = self.windows.get(w)
        if view is None or win is None:
            return
        view["status"].set(win.status)
        self._setting_sliders = True
        try:
            view["blur"].set(win.blur)
            view["trans"].set(win.trans)
        finally:
            self._setting_sliders = False

    # --- main loop --------------------------------------------------------------

    def _poll(self):
        if not self.pump() or not self.running:
            self.root.quit()
            return
        self.root.after(self.POLL_MS, self._poll)

    def run(self):
        self.app_start()
        self.root.after(self.POLL_MS, self._poll)
        self.root.mainloop()


def run_tk_client(port: Optional[int] = None, findport_file: str = "findport"):
    conn = talk.connect(port) if port is not None else talk.connect_findport(findport_file)
    client = TkClient(conn)
    client.run()
    conn.close()
    return client


if __name__ == "__main__":
    import sys

    run_tk_client(int(sys.argv[1]) if len(sys.argv) > 1 else None)
