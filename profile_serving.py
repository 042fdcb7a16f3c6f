#!/usr/bin/env python3
"""Where a served event's time goes, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 profile_serving.py

``chip_smoke.py``'s two serving sessions (``serve_fast``: a FastSession;
``serve_engine``: an Engine; both at 1920 x 1080 behind a localhost TCP
socket with the port's HeadlessClient) give the latency a client sees.  This
script runs the same two sessions with host-clock spans around the calls
that make up a served event, in the server's thread, and prints for drags
and for blur-slider steps the milliseconds per event inside each:

  * serve_fast: ``handle`` (the whole event), ``step_animated`` or ``step``
    (the frame: launches queued, not waited for), ``ship_window``, and
    within it ``wx.refresh_window`` (the framebuffer rect's ``tobytes`` and
    the display call) and ``display.refresh_window`` (marshalling, the
    socket, the client's blit and its reply); ``ship_window`` less
    ``wx.refresh_window`` is the slice, the cast, the wait for the card and
    the copy to the host;
  * serve_engine: ``event_handler``, ``render_frame``, ``plot_sprite`` (the
    sprite's readback and blit), ``wx.refresh_window`` and
    ``display.refresh_window``.

(cProfile is no use here: since Python 3.12 it records every thread, and the
client's calls muddle the server's.)  It prints one JSON line per session
with the client's latency of the same events beside the spans and, last, the
card's name and power limit.  The spans cost about a microsecond each.
"""

import subprocess
import sys
import time

import chip_smoke as cs

DEVICE = "cuda"


class Spans:
    """Seconds and calls per (event kind, span name), from wrapped
    callables; the kind is that of the event being handled."""

    def __init__(self):
        self.kind = None
        self.total = {}

    def wrap(self, name, fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                rec = self.total.setdefault((self.kind, name), [0.0, 0])
                rec[0] += time.perf_counter() - t0
                rec[1] += 1

        return wrapped

    def handler(self, name, fn):
        """Wrap the event handler itself: it names the kind."""
        timed = self.wrap(name, fn)

        def wrapped(event):
            self.kind = event[0]
            try:
                return timed(event)
            finally:
                self.kind = None

        return wrapped

    def per_event(self, kind, handler_name) -> dict:
        n = self.total[(kind, handler_name)][1]
        return {name: secs / n * 1e3 for (k, name), (secs, _calls) in self.total.items() if k == kind}


def drive(sv, win, n_drags: int, engine: bool):
    """The client's half: a press on the blob, n_drags drags, the slider
    steps.  Returns the (drag, slider) latencies in seconds."""
    c = sv.c
    bx, by, _ = cs.serve_blob(cs.W, cs.H)
    c.mouse = (bx, by)
    c.send_event("LeftDown", win, bx, by)
    if engine:
        sv.barrier(win)
    x, y = bx, by
    drags = []
    for k in range(n_drags):
        dx, dy = cs.serve_drag(k)
        x, y = x + dx, y + dy

        def send():
            c.mouse = (x, y)
            c.send_event("LeftDragging", win, x, y)

        drags.append(sv.timed(send))
    c.send_event("LeftUp", win, x, y)
    sv.barrier(win)
    sliders = [sv.timed(lambda v=v: c.send_event("BlurSlider", win, v)) for v in cs.SERVE_BLUR_STEPS]
    return drags, sliders


def session(torch, n_drags: int, engine: bool) -> dict:
    from coherence_tpu_torch.gui import app, fastserver
    from coherence_tpu_torch.gui.window import RemoteDisplay
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R

    cache.clear()
    spans = Spans()

    def wrap_window_system(wx):
        wx.display.refresh_window = spans.wrap("display.refresh_window", wx.display.refresh_window)
        wx.refresh_window = spans.wrap("wx.refresh_window", wx.refresh_window)
        wx.plot_sprite = spans.wrap("plot_sprite", wx.plot_sprite)

    def fast_server(conn, ready):
        objs, blob, f_geom = cs.fast_scene(cs.W, cs.H)
        sess = fastserver.FastSession(conn, cs.W, cs.H, objs, blob, f_geom, blur_radius=cs.SERVE_BLUR, device=DEVICE)
        wrap_window_system(sess.wx)
        sess.disp.step_animated = spans.wrap("step_animated", sess.disp.step_animated)
        sess.disp.step = spans.wrap("step", sess.disp.step)
        sess.ship_window = spans.wrap("ship_window", sess.ship_window)
        sess.handle = spans.handler("handle", sess.handle)
        sess.run()

    def engine_server(conn, ready):
        eng = app.Engine(display=RemoteDisplay(conn), device=DEVICE)
        view = R.View(device=eng.device, scene=cs.engine_scene(cs.W, cs.H), pages=[], background=[app.background_obj()],
                      master_update=region.shape_of_box((0, 0, cs.W, cs.H), eng.device))
        eng.views.append(view)
        view.window = eng.wx.make_window("session", cs.W, cs.H, 0, 0, 0, 0)
        eng.force_update_whole(view)
        wrap_window_system(eng.wx)
        real_render_frame = R.render_frame
        R.render_frame = spans.wrap("render_frame", real_render_frame)
        eng.event_handler = spans.handler("event_handler", eng.event_handler)
        try:
            eng.run(resilient=False)
        finally:
            R.render_frame = real_render_frame

    sv = cs.Served(engine_server if engine else fast_server)
    if not engine:
        sv.c.app_start()
    sv.await_refresh()
    sv.drain()
    win = next(iter(sv.c.windows))
    drags, sliders = drive(sv, win, n_drags, engine)
    sv.close()
    cache.clear()
    name = "event_handler" if engine else "handle"
    return {"client_drag_ms": cs.latency(drags[cs.SERVE_WARM:]), "client_slider_ms": cs.latency(sliders),
            "drag_ms_per_event": spans.per_event("LeftDragging", name),
            "slider_ms_per_event": spans.per_event("BlurSlider", name)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    from coherence_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    kernels.load()
    t0 = time.perf_counter()
    for engine in (False, True):
        n = cs.SERVE_WARM + (cs.SERVE_ENGINE_DRAGS if engine else cs.SERVE_FAST_DRAGS)
        cs.emit({"session": "serve_engine" if engine else "serve_fast", "size": [cs.W, cs.H], "drags": n,
                 **session(torch, n, engine)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.emit({"nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
