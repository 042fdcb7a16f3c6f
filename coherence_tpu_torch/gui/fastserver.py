"""Device-backed display server: the reference's two-endpoint architecture
(engine.ml:208-252 paint semantics, main.py:219-226 client blits) with
frames produced by the tiled animated device path (DeviceView +
FilteredDisplay) instead of the general renderer.

The PyTorch counterpart of ``coherence_tpu.gui.fastserver``.  It speaks the
same byte wire protocol (gui/wire.py) through WindowSystem / RemoteDisplay,
so any client — HeadlessClient, tkclient, or a real widget toolkit — works
unmodified, and for the same events it writes the same bytes to the socket
as the JAX package's session.  Per drag event: one animated step (atlas
piece update, dirty-tile recomposite, blur blend:
``FilteredDisplay.step_animated``), then only the rewritten display window
is cut out and cast to uint8 on the device, copied to the host once and
shipped as a RefreshWindow: the latency the client sees is the step, one
window-sized copy and the socket, whatever the frame's size.

This is the serving configuration for interactive workloads: the general
Engine (gui/app.py) keeps full reference semantics (arbitrary scene edits,
tools, undo); FastSession serves the hot interactive loop: drag an animated
object under a live filter.

Not carried over from the JAX package: ``_warm_blur`` and its
``warm_blur_radii`` argument (they pre-load one compiled program per blur
radius; eager PyTorch has none to load).  Over a meshed view
(``DeviceView.use_mesh``) ``ship_window`` reads the window's rows from the
display plane's bands.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..raster import convolve as rconvolve
from ..raster import region
from ..raster.region import bucket_hw
from ..scene import render as R
from ..scene.fastframe import (
    DeviceView,
    FilteredDisplay,
    alpha_plane_of_object,
    tiled_sprite_of_object,
)
from . import window as W
from .window import RemoteDisplay


class FastSession:
    """One window serving an animated-object-under-filter scene from
    `device`, the card unless the caller names the CPU.

    scene_objs: static content (front-to-back); blob: the draggable
    animated object (topmost); f_geom: the blur filter's lens geometry.
    The caller owns the connection; run() drives the event loop until the
    client closes."""

    def __init__(
        self,
        connection,
        width: int,
        height: int,
        scene_objs,
        blob: R.Obj,
        f_geom: R.Obj,
        blur_radius: int = 5,
        atlas_cap: Optional[int] = None,
        staged=None,
        name: str = "coherence (torch)",
        device="cuda",
    ):
        self.device = W.serving_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.width, self.height = width, height
        self.wx = W.WindowSystem(display=RemoteDisplay(connection))
        self.wx.poll()  # AppStartup
        self.win = self.wx.make_window(name, width, height, 0, 0, 0, 0)

        view = DeviceView(width, height, device=self.device, atlas_cap=atlas_cap)
        f_alpha = alpha_plane_of_object(f_geom, width, height, self.device)
        view.set_scene(list(scene_objs), tiled=True, staged=staged)
        blob_spr = tiled_sprite_of_object(blob, view.pw, view.ph, self.device)
        self.blob_key = blob.idset
        view.sprites[self.blob_key] = blob_spr
        view.order.insert(0, self.blob_key)
        view.make_animated(self.blob_key)
        self.view = view
        self.f_alpha = f_alpha
        # Lens support box (1-based inclusive): a blur-radius change only
        # alters pixels where the filter alpha is nonzero, so the slider
        # reblends and ships this window, not the frame.  One readback of
        # two small vectors, at set-up.
        al = f_alpha > 0
        region._sync()
        ys = torch.nonzero(al.any(1)).flatten().cpu()
        xs = torch.nonzero(al.any(0)).flatten().cpu()
        self.lens_box = (
            (int(xs[0]) + 1, int(ys[0]) + 1, int(xs[-1]) + 1, int(ys[-1]) + 1)
            if len(ys)
            else None
        )
        self.disp = FilteredDisplay(view, f_alpha, rconvolve.mkgaussian(blur_radius))
        self.disp.full_refresh()
        self.dragging = False
        self.last_xy = (0, 0)
        self.ship_full()

    # --- pixel shipping -------------------------------------------------------

    def ship_window(self, x0: int, y0: int, x1: int, y1: int) -> None:
        """Read [x0..x1] x [y0..y1] (1-based inclusive box) of the display
        plane and RefreshWindow it to the client (synchronous: returns
        when the client has the pixels, the latency the user feels)."""
        x0 = max(1, x0); y0 = max(1, y0)
        x1 = min(self.width, x1); y1 = min(self.height, y1)
        if x0 > x1 or y0 > y1:
            return
        h, w = y1 - y0 + 1, x1 - x0 + 1
        # The pow2 bucket decides which rectangle crosses the wire: it is
        # kept so that a client sees the JAX package's stream byte for byte.
        hb, wb = bucket_hw(h, w)
        hb, wb = min(hb, self.height), min(wb, self.width)
        # Clamp the bucketed window inside the plane; blit the whole
        # bucket (its extra rows and columns re-ship unchanged pixels).
        r0 = min(y0 - 1, self.height - hb)
        c0 = min(x0 - 1, self.width - wb)
        # Slice and cast on the device; one copy of hb x wb x 3 bytes.  Under
        # a mesh the window's rows come from the bands that hold them.
        if self.view.mesh is None:
            win = self.disp.rgba[r0 : r0 + hb, c0 : c0 + wb]
        else:
            win = self.disp.rgba.window(r0, r0 + hb, c0, c0 + wb, self.device)
        region._sync()
        rgb = win[..., :3].to(torch.uint8).cpu().numpy()
        fb = self.wx.framebuffers[self.win]
        fb[r0 : r0 + hb, c0 : c0 + wb] = rgb
        self.wx.refresh_window(self.win, (c0, r0, c0 + wb - 1, r0 + hb - 1))

    def ship_full(self) -> None:
        self.ship_window(1, 1, self.width, self.height)

    # --- interactions -----------------------------------------------------------

    def drag_step(self, dx: int, dy: int) -> None:
        """One animated step, then ship only the rewritten window."""
        prev = self.view.sprites[self.blob_key].box
        self.disp.step_animated(self.blob_key, dx, dy)
        now = self.view.sprites[self.blob_key].box
        r = self.disp.kernel.radius
        x0 = min(prev[0], now[0]) - 2 * r
        y0 = min(prev[1], now[1]) - 2 * r
        x1 = max(prev[2], now[2]) + 2 * r
        y1 = max(prev[3], now[3]) + 2 * r
        self.ship_window(x0, y0, x1, y1)

    def set_blur(self, v: int) -> None:
        """Radius change: reblend and ship only the lens window (content is
        untouched; pixels outside the filter alpha cannot change)."""
        self.disp.kernel = rconvolve.mkgaussian(max(1, int(v)))
        if self.lens_box is None:
            return
        self.disp.step(self.lens_box)
        self.ship_window(*self.lens_box)

    def _hit_blob(self, x: int, y: int) -> bool:
        x0, y0, x1, y1 = self.view.sprites[self.blob_key].box
        return x0 - 1 <= x <= x1 and y0 - 1 <= y <= y1

    # --- event loop --------------------------------------------------------------

    def handle(self, e) -> bool:
        """One event; returns False when the session should end."""
        kind = e[0]
        if kind in (W.APP_CLOSE, W.WINDOW_CLOSED):
            return False
        if kind == W.PAINT_RECT:
            _, _w, x, y, pw, ph = e
            self.ship_window(x + 1, y + 1, x + pw, y + ph)
        elif kind == W.LEFT_DOWN:
            _, _w, x, y = e
            self.dragging = self._hit_blob(x, y)
            self.last_xy = (x, y)
        elif kind == W.LEFT_DRAGGING:
            _, _w, x, y = e
            if self.dragging:
                lx, ly = self.last_xy
                if (x, y) != (lx, ly):
                    self.drag_step(x - lx, y - ly)
            self.last_xy = (x, y)
        elif kind == W.LEFT_UP:
            self.dragging = False
        elif kind == W.BLUR_SLIDER:
            self.set_blur(e[2])
        return True

    def run(self, max_events: Optional[int] = None) -> None:
        """Serve events, in whatever thread calls it, until the client
        closes; the client is told so even when an event raised."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        n = 0
        try:
            while max_events is None or n < max_events:
                e = self.wx.poll()
                if e[0] == W.NULL_EVENT:
                    continue
                if not self.handle(e):
                    break
                n += 1
        finally:
            try:
                self.wx.close_application()  # tell the client we're done
            except Exception:
                pass
